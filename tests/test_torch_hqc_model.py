"""PyTorch port conformance: the port's binding of the native HQC model and
its fast oracle against the JAX package's, on the fixture key.  Both bind
the same library (``csrc/libhqc_core.so``), so every output must be the same
bytes; the fast oracle must answer as the native decode does."""

import pickle
from pathlib import Path

import numpy as np
import pytest

from sca_ldpc_tpu.models.hqc import Hqc128 as JaxHqc128
from sca_ldpc_tpu_torch.models.hqc import (
    Hqc128,
    Hqc192,
    Hqc256,
    hqc_by_param_set,
    search_distinguishable_plaintext,
    shift_and_add_mod_2_sparse,
    sparse_times_sparse,
    toggle_bits_in_v,
    toggle_outer_block,
)
from sca_ldpc_tpu_torch.models.hqc.model import lib_fingerprint
from sca_ldpc_tpu_torch.models.hqc.oracle_fast import FastCiphertextState
from sca_ldpc_tpu_torch.models.hqc.tracking import HqcSimulationParams
from sca_ldpc_tpu_torch.utils import make_random_state

KEYFILE = Path(__file__).resolve().parent.parent / "fixtures" / "test-hqc128.key"


@pytest.fixture(scope="module")
def key():
    with open(KEYFILE, "rb") as f:
        return pickle.load(f)


def test_params_and_classes():
    assert Hqc128.params("N") == JaxHqc128.params("N") == 17669
    for what in ("N1", "N2", "N1N2", "DELTA", "OMEGA"):
        assert Hqc128.params(what) == JaxHqc128.params(what)
    assert hqc_by_param_set("192") is Hqc192 and hqc_by_param_set(256) is Hqc256
    assert Hqc128.name() == "hqc-128"
    with pytest.raises(ValueError):
        Hqc128.params("BOGUS")
    assert len(lib_fingerprint()) == 64


def test_same_bytes_as_the_jax_binding(key):
    pub, priv = key
    assert Hqc128.secrets_from_key(priv) == JaxHqc128.secrets_from_key(priv)
    rng = np.random.RandomState(3)
    for _ in range(3):
        pt = rng.bytes(16)
        r1 = sorted(int(i) for i in rng.choice(17669, 20, replace=False))
        ct, ss = Hqc128.encaps_with_plaintext_and_r1(pub, pt, r1)
        ct_j, ss_j = JaxHqc128.encaps_with_plaintext_and_r1(pub, pt, r1)
        assert (bytes(ct), bytes(ss)) == (bytes(ct_j), bytes(ss_j))
        assert Hqc128.decode_intermediates(ct, priv) == JaxHqc128.decode_intermediates(ct, priv)
        assert bytes(Hqc128.decode_intermediates(ct, priv)[0]) == pt
        assert Hqc128.decaps(ct, priv) == JaxHqc128.decaps(ct, priv)
        assert Hqc128.eprime(ct, priv, pt) == JaxHqc128.eprime(ct, priv, pt)
        bad = toggle_outer_block(ct, 0, 17669, 384)
        assert Hqc128.decode_intermediates(bad, priv) == JaxHqc128.decode_intermediates(bad, priv)
        assert Hqc128.num_rejections(pt) == JaxHqc128.num_rejections(pt)


def test_host_helpers():
    assert sparse_times_sparse([3, 5, 9], [0, 2], N=10, mod=2) == [1, 3, 7, 9]
    assert shift_and_add_mod_2_sparse([1, 5, 8, 12], 3, 15) == [0, 1, 4, 5, 11, 12]
    assert toggle_bits_in_v(bytearray((0xFF, 0xFF, 0xFF)), [0, 6], 9).hex() == "ffffbe"
    assert toggle_outer_block(bytearray((0xFF, 0xFF, 0xFE, 0xFE)), 0, 9, 10).hex() == "ffff01fd"
    pt = search_distinguishable_plaintext(Hqc128, make_random_state(0))
    assert Hqc128.num_rejections(pt) // 1000 - 3 >= 3


@pytest.fixture(scope="module")
def oracle_setup(key):
    pub, priv = key
    pt = bytes(range(16))
    ct, _ = Hqc128.encaps_with_plaintext_and_r1(pub, pt, [0, 500, 9000])
    params = HqcSimulationParams(Hqc128, 15, (1.0, 1.0), 100, 3)
    return params, priv, pt, ct


def _native(params, ct, priv, pt):
    return bytes(params.HQC.decode_intermediates(ct, priv)[0]) == pt


def test_fast_oracle_block_and_bit_flips_match_native(oracle_setup):
    """test_fast_oracle.py's walks: blocks to the failure edge, then single
    bits, the fast state against the native decode after every flip."""
    params, priv, pt, ct = oracle_setup
    n, n1, n2 = params.N, params.N1, params.N2
    st = FastCiphertextState.from_ciphertext(params, ct, priv, pt)
    assert st.decode_success() and _native(params, ct, priv, pt)
    ct_mod = bytearray(ct)
    for block in range(params.OUTER_DECODING_LIMIT + 1):
        ct_mod = toggle_outer_block(ct_mod, block, n, n2)
        st.toggle_block(block)
        assert st.decode_success() == _native(params, ct_mod, priv, pt)
    rng = make_random_state(1)
    for trial in range(30):
        bit = int(rng.randint(0, n1 * n2))
        ct_mod = toggle_bits_in_v(ct_mod, [bit], n)
        st.toggle_bits([bit])
        assert st.decode_success() == _native(params, ct_mod, priv, pt), f"trial {trial}, bit {bit}"


def test_fast_oracle_probes_match_native_and_do_not_mutate(oracle_setup):
    params, priv, pt, ct = oracle_setup
    n, n1, n2 = params.N, params.N1, params.N2
    st = FastCiphertextState.from_ciphertext(params, ct, priv, pt)
    ct_mod = bytearray(ct)
    for block in range(params.OUTER_DECODING_LIMIT + 1):
        st.toggle_block(block)
        ct_mod = toggle_outer_block(ct_mod, block, n, n2)
    before = (st.W.copy(), st.wrong_count, st.bits.copy())
    bits = [int(b) for b in make_random_state(2).randint(0, n1 * n2, 24)]
    probes = st.probe_bits(bits)
    for bit, got in zip(bits, probes):
        assert bool(got) == _native(params, toggle_bits_in_v(ct_mod, [bit], n), priv, pt)
        assert st.probe_bit(bit) == bool(got)
    assert st.probe_block(0) == _native(params, toggle_outer_block(ct_mod, 0, n, n2), priv, pt)
    assert np.array_equal(st.W, before[0]) and st.wrong_count == before[1] and np.array_equal(st.bits, before[2])
