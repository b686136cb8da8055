"""PyTorch port conformance: q-ary min-sum decoding and q-ary FER simulation
on the CPU, against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
min-plus chain is held bitwise; decoders are held on hard decisions with no
tolerance (the plain version sums the DV slots in the JAX package's order,
and these inputs have no ties).  The Pallas kernels run in interpret mode,
as tests/test_pallas_kernel.py runs them.
"""

import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from qary_reference import ref_min_sum
from sca_ldpc_tpu import codes as jcodes
from sca_ldpc_tpu.channels import llr as jllr
from sca_ldpc_tpu.ops import QaryDecoder as JaxQaryDecoder
from sca_ldpc_tpu.ops import minplus as jminplus
from sca_ldpc_tpu.ops.kernels.qary_pallas import chain_exclusive_pallas, qary_min_sum_fused
from sca_ldpc_tpu.sim import simulate_frame_error_rate_qary as jax_fer_qary
from sca_ldpc_tpu_torch import codes
from sca_ldpc_tpu_torch.channels import binary_prior_llr, probs_to_llr
from sca_ldpc_tpu_torch.models.kyber import gen_ldpc_matrix
from sca_ldpc_tpu_torch.ops import QaryDecoder, decoder_name_for, get_decoder_by_name, minplus
from sca_ldpc_tpu_torch.ops.kernels.qary_cuda import chain_exclusive_cuda, qary_min_sum_fused_cuda
from sca_ldpc_tpu_torch.ops.qary import _var_sign_mask
from sca_ldpc_tpu_torch.sim import simulate_frame_error_rate_qary
from sca_ldpc_tpu_torch.utils import make_random_state

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOY = np.array([[1, 1, 1, 1, 0, 0], [0, 0, 1, 1, 0, 1], [1, 0, 0, 1, 1, 0]], np.int8)
SIGNED = np.array([[1, -1, 1, 0], [0, 1, -1, 1]], np.int8)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


# ---------------------------------------------------------------- constructors


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_constructors_match_jax(seed):
    def both(name, *args, **kw):
        a = getattr(codes, name)(*args, np.random.RandomState(seed), **kw)
        b = getattr(jcodes, name)(*args, np.random.RandomState(seed), **kw)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
        return a

    assert both("fixed_weight_vec", 40, 6).sum() == 6
    both("circular_qary_parity_check_block", 30, 3)
    both("make_qary_qc_parity_check_matrix", 30, 4, 2)
    assert both("make_qary_qc_parity_check_matrix", 20, 6, 3, check_blocks=2).shape == (40, 100)
    both("make_qc_parity_check_matrix", 25, 3, 2)
    both("make_regular_ldpc_parity_check_matrix", 60, 30, 3, 6)
    assert both("make_regular_ldpc_parity_check_matrix_identity", 300, 150, 3, 6).shape == (150, 450)


def test_constructor_argument_checks():
    rng = np.random.RandomState(0)
    for args in [(60, 30, 1, 6), (60, 30, 3, 2), (61, 30, 3, 6), (60, 31, 3, 6)]:
        with pytest.raises(ValueError):
            codes.make_regular_ldpc_parity_check_matrix(*args, rng)
    with pytest.raises(NotImplementedError):
        codes.make_qary_qc_parity_check_matrix(30, 5, 2, rng)


# ---------------------------------------------------------------- layout


def _h(name):
    if name == "toy":
        return TOY
    if name == "signed":
        return SIGNED
    if name == "qary_qc":
        return jcodes.make_qary_qc_parity_check_matrix(30, 4, 2, make_random_state(3))
    if name == "regular_identity":
        return jcodes.make_regular_ldpc_parity_check_matrix_identity(60, 30, 3, 6, make_random_state(1))
    return jcodes.make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, make_random_state(1))


CODES = ["toy", "signed", "qary_qc", "regular_identity", "medium"]
B_OF = {"toy": 7, "signed": 2, "qary_qc": 2, "regular_identity": 7, "medium": 7}


def _assert_layouts_equal(a, b):
    for f in ("n", "r", "dc", "dv", "n_edges", "flat_size"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("chk_var", "chk_sign", "chk_mask", "chk_deg", "var_flat", "var_sign", "var_mask", "var_deg"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name", CODES)
def test_code_layout_matches_jax(name):
    H = _h(name)
    _assert_layouts_equal(codes.CodeLayout.from_h(H), jcodes.CodeLayout.from_h(H))
    _assert_layouts_equal(codes.CodeLayout.from_h(H, dc=9, dv=5), jcodes.CodeLayout.from_h(H, dc=9, dv=5))
    rows, cols = np.nonzero(H)
    _assert_layouts_equal(codes.CodeLayout.from_edges(H.shape[0], H.shape[1], rows, cols),
                          jcodes.CodeLayout.from_edges(H.shape[0], H.shape[1], rows, cols))
    with pytest.raises(ValueError):
        codes.CodeLayout.from_h(H, dc=1)


# ---------------------------------------------------------------- channels


def test_probs_to_llr_exact_row():
    """decoder.rs:744-768: llr = ln(max/p), inf where p == 0."""
    row = [0.0, 0.0, 0.0, 0.0, 0.14, 0.14, 0.14, 0.14, 0.14, 0.14, 0.14, 0.02, 0.0, 0.0, 0.0]
    llr = probs_to_llr(torch.tensor([row]))
    expected = np.array([np.inf] * 4 + [0.0] * 7 + [1.9459101] + [np.inf] * 3, dtype=np.float32)
    assert llr.dtype == torch.float32
    np.testing.assert_allclose(llr[0].numpy(), expected, rtol=1e-5)
    np.testing.assert_allclose(llr.numpy(), np.asarray(jllr.probs_to_llr(np.array([row], np.float32))), rtol=1e-6)


def test_llr_conversions_match_jax():
    rng = np.random.RandomState(2)
    probs = rng.dirichlet(np.ones(5), size=(3, 7)).astype(np.float32)
    probs[0, :, 1] = 0.0
    ours = probs_to_llr(torch.from_numpy(probs)).numpy()
    theirs = np.asarray(jllr.probs_to_llr(probs))
    assert np.array_equal(np.isinf(ours), np.isinf(theirs))
    np.testing.assert_allclose(ours[np.isfinite(ours)], theirs[np.isfinite(theirs)], rtol=1e-6, atol=1e-6)
    p = np.array([0.0, 1e-31, 0.01, 0.5, 1.0], np.float32)
    np.testing.assert_allclose(binary_prior_llr(p).numpy(), np.asarray(jllr.binary_prior_llr(p)), rtol=1e-6)


# ---------------------------------------------------------------- min-plus


def test_clip_inf_and_identity_match_jax():
    x = np.array([1.0, np.inf, -np.inf, np.nan, 2e15, -3.0], np.float32)
    assert np.array_equal(_bits(minplus.clip_inf(torch.from_numpy(x))), _bits(jminplus.clip_inf(jnp.asarray(x))))
    assert np.array_equal(_bits(minplus.identity(7)), _bits(jminplus.identity(7)))


@pytest.mark.parametrize("wa,wb,s_out,ha,hb", [
    (15, 1, 7, None, 0), (15, 29, 14, None, 7), (29, 43, 7, 14, 21), (5, 25, 2, 12, 14), (3, 9, 6, 1, None),
])
def test_conv_bitwise_matches_jax(wa, wb, s_out, ha, hb):
    rng = np.random.RandomState(wa + wb)
    a = (rng.rand(4, 3, wa) * 20 - 2).astype(np.float32)
    b = (rng.rand(4, 3, wb) * 20 - 2).astype(np.float32)
    b[rng.rand(*b.shape) < 0.2] = minplus.BIG
    ours = minplus.conv(torch.from_numpy(a), torch.from_numpy(b), s_out, ha, hb)
    theirs = jminplus.conv(jnp.asarray(a), jnp.asarray(b), s_out, ha, hb)
    assert np.array_equal(_bits(ours), _bits(theirs))


def _v2c(bt, r, dc, q, seed):
    rng = np.random.RandomState(seed)
    v = (rng.rand(bt, r, dc, q) * 20).astype(np.float32)
    v[rng.rand(*v.shape) < 0.1] = minplus.BIG  # pad-like BIG entries
    v[rng.rand(*v.shape) < 0.05] *= -1
    return v


@pytest.mark.parametrize("bt,r,dc,q", [(16, 10, 7, 15), (5, 7, 4, 5), (3, 4, 1, 3)])
def test_chain_exclusive_bitwise_matches_jax(bt, r, dc, q):
    """Plain version and the kernel wrapper on CPU tensors, against the JAX
    ``minplus.chain_exclusive`` and (in interpret mode) ``chain_exclusive_pallas``."""
    b = (q - 1) // 2
    s_mid = (dc - 1) * b
    v = _v2c(bt, r, dc, q, bt)
    ref = _bits(jminplus.chain_exclusive(jnp.asarray(v), s_mid, s_out=b))
    assert np.array_equal(_bits(minplus.chain_exclusive(torch.from_numpy(v), s_mid, s_out=b)), ref)
    before = chain_exclusive_cuda.launches
    assert np.array_equal(_bits(chain_exclusive_cuda(torch.from_numpy(v), s_mid, b)), ref)
    assert chain_exclusive_cuda.launches == before  # the CPU path launches nothing
    if (bt, q) == (16, 15):
        with pltpu.force_tpu_interpret_mode():
            pallas = chain_exclusive_pallas(jnp.asarray(np.abs(v)), s_mid, b, tb=8)
        ref_abs = _bits(jminplus.chain_exclusive(jnp.asarray(np.abs(v)), s_mid, s_out=b))
        assert np.array_equal(_bits(pallas), ref_abs)
        assert np.array_equal(_bits(chain_exclusive_cuda(torch.from_numpy(np.abs(v)), s_mid, b)), ref_abs)


@pytest.mark.parametrize("bt,s_out", [(11, 2), (8, 3)])
def test_chain_exclusive_with_extra_bitwise_matches_jax(bt, s_out):
    sw, b = 6, 2
    se = sw * b
    s_mid = (2 * sw - 1) * b
    rng = np.random.RandomState(bt)
    v = (rng.rand(bt, 10, sw, 2 * b + 1) * 20).astype(np.float32)
    extra = (rng.rand(bt, 10, 2 * se + 1) * 20).astype(np.float32)
    extra[:, :3, :5] = minplus.BIG
    ref = _bits(jminplus.chain_exclusive(jnp.asarray(v), s_mid, extra=jnp.asarray(extra), s_out=s_out))
    vt, et = torch.from_numpy(v), torch.from_numpy(extra)
    assert np.array_equal(_bits(minplus.chain_exclusive(vt, s_mid, extra=et, s_out=s_out)), ref)
    assert np.array_equal(_bits(chain_exclusive_cuda(vt, s_mid, s_out, et)), ref)


def test_kernel_wrappers_check_inputs_on_cpu():
    v = torch.from_numpy(_v2c(2, 3, 4, 5, 0))
    with pytest.raises(ValueError):
        chain_exclusive_cuda(v[..., :4], 6, 2)
    with pytest.raises(TypeError):
        chain_exclusive_cuda(v.double(), 6, 2)
    with pytest.raises(ValueError):
        chain_exclusive_cuda(v, 6, 2, torch.zeros((2, 4, 5)))
    with pytest.raises(ValueError):
        chain_exclusive_cuda(v, -1, 2)
    dec = QaryDecoder(TOY, 7, 3, backend="fused", device="cpu")
    llr = torch.zeros((2, 6, 15))
    with pytest.raises(ValueError):
        qary_min_sum_fused_cuda(llr, *dec._args, 6, 3)
    with pytest.raises(TypeError):
        qary_min_sum_fused_cuda(llr, dec._args[0].long(), *dec._args[1:], 7, 3)


# ---------------------------------------------------------------- decoder


def _probs(name, frames=3, seed=9):
    q = 2 * B_OF[name] + 1
    n = _h(name).shape[1]
    return np.random.RandomState(seed).dirichlet(np.ones(q), size=(frames, n)).astype(np.float32)


@functools.cache
def _jax_hard(name, iters, early_exit=False, frames=3):
    H = _h(name)
    dec = JaxQaryDecoder(H, B_OF[name], iters, early_exit=early_exit)
    return np.asarray(dec.min_sum(_probs(name, frames)))


@pytest.mark.parametrize("name", ["toy", "signed", "qary_qc", "regular_identity"])
@pytest.mark.parametrize("backend", ["plain", "chain", "fused"])
def test_decoder_matches_jax_xla_path(name, backend):
    H = _h(name)
    for iters in (1, 4):
        ours = QaryDecoder(H, B_OF[name], iters, backend=backend, device="cpu").min_sum(_probs(name))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), _jax_hard(name, iters))


@pytest.mark.parametrize("name", ["toy", "qary_qc", "regular_identity"])
@pytest.mark.parametrize("backend", ["plain", "chain"])
def test_decoder_early_exit_matches_jax(name, backend):
    H = _h(name)
    ours = QaryDecoder(H, B_OF[name], 4, backend=backend, early_exit=True, device="cpu").min_sum(_probs(name))
    np.testing.assert_array_equal(ours.numpy(), _jax_hard(name, 4, early_exit=True))


def test_decoder_matches_jax_pallas_fused_in_interpret_mode():
    """The JAX fused Pallas kernel (interpret mode) and the port's fused
    backend give the same hard decisions."""
    H = _h("qary_qc")
    dec = JaxQaryDecoder(H, 2, max_iter=4, backend="fused")
    llr = jminplus.clip_inf(jllr.probs_to_llr(_probs("qary_qc", 5, seed=7)))
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(qary_min_sum_fused(llr, *dec._fused_args(), 2, 4))
    ours = QaryDecoder(H, 2, 4, backend="fused", device="cpu").min_sum(_probs("qary_qc", 5, seed=7))
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_medium_450_decode_at_batch_one():
    """decoder.rs:818-854: (3,6)+I regular code, B=7, 10 iterations, one
    noisy symbol -> all zero; and a noisy Dirichlet frame equal to JAX."""
    H = _h("medium")
    channel = np.zeros((450, 15), np.float32)
    channel[:, 7] = 1.0
    channel[1, 7] = 0.1
    channel[1, 14] = 0.9
    for backend in ("plain", "chain", "fused"):
        out = QaryDecoder(H, 7, 10, backend=backend, device="cpu").min_sum(channel)
        assert out.shape == (450,) and not out.any()
    probs = _probs("medium", frames=1, seed=4)[0]
    ours = QaryDecoder(H, 7, 3, backend="fused", device="cpu").min_sum(probs)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(JaxQaryDecoder(H, 7, 3).min_sum(probs)))


@pytest.mark.parametrize("name", CODES)
def test_variable_side_arrays_derived_from_check_side(name):
    """The decode loop derives var_sign/var_mask from chk_sign and var_flat:
    they equal the layout's own (and so the JAX package's)."""
    lay = codes.CodeLayout.from_h(_h(name), dv=4)
    var_sign, var_mask = _var_sign_mask(torch.from_numpy(lay.chk_sign.astype(np.int32)),
                                        torch.from_numpy(lay.var_flat))
    np.testing.assert_array_equal(var_sign.numpy(), lay.var_sign)
    np.testing.assert_array_equal(var_mask.numpy(), lay.var_mask)


@pytest.mark.parametrize("iters", [1, 5])
def test_decoder_matches_enumeration_reference(iters):
    """Exact agreement with the Python model of the Rust enumeration
    semantics (decoder.rs:560-666) on single-error frames."""
    rng = make_random_state(3)
    H = codes.make_regular_ldpc_parity_check_matrix_identity(30, 15, 3, 6, rng).astype(np.int8)
    n, b, q = H.shape[1], 1, 3
    p = 1.0 / q
    good = np.full(q, p, np.float32)
    bad = np.full(q, p, np.float32)
    good[[b, -1]] = [1.75 * p, 0.25 * p]
    bad[[-1, b]] = [1.75 * p, 0.25 * p]
    decs = [QaryDecoder(H, b, iters, backend=be, device="cpu") for be in ("plain", "chain", "fused")]
    for _ in range(3):
        ch = np.tile(good, (n, 1)).astype(np.float32)
        ch[rng.choice(n, 1, replace=False)] = bad
        ref = ref_min_sum(H, b, iters, ch)
        for dec in decs:
            np.testing.assert_array_equal(dec.min_sum(ch).numpy(), ref)


def test_decoder_rejects_bad_arguments():
    with pytest.raises(ValueError):
        QaryDecoder(TOY, 7, 3, backend="xla", device="cpu")
    with pytest.raises(ValueError):
        QaryDecoder(TOY, 7, 3, backend="fused", early_exit=True, device="cpu")
    assert QaryDecoder(TOY, 7, 3, device="cpu").backend == "plain"
    with pytest.raises(ValueError):
        QaryDecoder(TOY, 7, 3, device="cpu").min_sum(np.full((6, 5), 0.2, np.float32))


def test_decoder_registry():
    H = _h("medium").astype(np.int8)
    name = decoder_name_for(H, 1)
    assert name == "DecoderN450R150V3C7B1"
    dec = get_decoder_by_name(name, H, iterations=5, backend="fused", device="cpu")
    assert (dec.b, dec.max_iter, dec.layout.dc, dec.layout.dv, dec.backend) == (1, 5, 7, 3, "fused")
    ch = np.zeros((450, 3), np.float32)
    ch[:, 1] = 1.0
    assert not dec.min_sum(ch).any()
    hk = gen_ldpc_matrix(6, 0, check_blocks=2)
    deck = get_decoder_by_name("DecoderN1280R512SW6", hk, iterations=3, device="cpu")  # the two-alphabet decoder
    assert (deck.n, deck.r, deck.sw, deck.b, deck.bsum, deck.backend) == (1280, 512, 6, 2, 12, "plain")
    with pytest.raises(ValueError):
        get_decoder_by_name("DecoderBogus", H, 5, device="cpu")
    with pytest.raises(ValueError):
        get_decoder_by_name("DecoderN450R150V3C7B1", H[:, :-1], 5, device="cpu")


# ---------------------------------------------------------------- FER


def test_qary_fer_doctest_case():
    """decode.py:192-209: seed 1, one run at rate 0.005 -> (1, 2, None),
    the reference's exact frame, for every backend."""
    for backend in ("plain", "chain", "fused"):
        rng = make_random_state(1)
        H = codes.make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, rng)
        assert simulate_frame_error_rate_qary(H, 1, 0.005, 1, rng, iterations=5, host_sampling=True,
                                              backend=backend, device="cpu") == (1, 2, None)


@pytest.mark.parametrize("b_range", [1, 2])
def test_qary_fer_host_sampling_matches_jax(b_range):
    """64 runs of the doctest configuration (seed 1, rate 0.005, 5
    iterations) at B = 1 and 2: the same triple as the JAX function."""
    def run(sim, make, **kw):
        rng = make_random_state(1)
        H = make(300, 150, 3, 6, rng)
        return sim(H, b_range, 0.005, 64, rng, iterations=5, host_sampling=True, **kw)

    ours = run(simulate_frame_error_rate_qary, codes.make_regular_ldpc_parity_check_matrix_identity, device="cpu")
    theirs = run(jax_fer_qary, jcodes.make_regular_ldpc_parity_check_matrix_identity)
    assert ours == theirs
    assert 0 < ours[0] < 64


def test_qary_fer_device_sampling_is_deterministic():
    H = codes.make_regular_ldpc_parity_check_matrix_identity(60, 30, 3, 6, 1)
    rng = make_random_state(5)
    a = simulate_frame_error_rate_qary(H, 1, 0.05, 40, rng, iterations=3, batch_size=16, device="cpu")
    # three batches, none with an error-free frame at this rate: three host draws
    expected = make_random_state(5)
    for _ in range(3):
        expected.randint(0, 2**31 - 1)
    assert rng.randint(0, 100) == expected.randint(0, 100)
    assert simulate_frame_error_rate_qary(H, 1, 0.05, 40, 5, iterations=3, batch_size=16, device="cpu") == a
    assert simulate_frame_error_rate_qary(H, 1, 0.05, 40, 5, iterations=3, batch_size=16,
                                          backend="fused", device="cpu") == a
    assert 0 <= a[0] <= 40


def test_qary_modules_run_without_jax():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        from sca_ldpc_tpu_torch.channels import probs_to_llr
        from sca_ldpc_tpu_torch.codes import make_regular_ldpc_parity_check_matrix_identity
        from sca_ldpc_tpu_torch.ops import QaryDecoder, get_decoder_by_name, minplus, qary_special, registry
        from sca_ldpc_tpu_torch.ops.kernels import qary_cuda
        from sca_ldpc_tpu_torch.models import kyber
        from sca_ldpc_tpu_torch.sim import simulate_frame_error_rate_qary
        H = make_regular_ldpc_parity_check_matrix_identity(60, 30, 3, 6, 1)
        ch = np.zeros((90, 3), np.float32)
        ch[:, 1] = 1.0
        assert not QaryDecoder(H, 1, 3, backend="fused", device="cpu").min_sum(ch).any()
        assert simulate_frame_error_rate_qary(H, 1, 0.01, 4, 0, device="cpu")[0] <= 4
        Hk = kyber.gen_ldpc_matrix(6, 0, 1)
        dec = qary_special.QarySpecialDecoder(Hk, 2, 12, 2, backend="fused", device="cpu")
        assert get_decoder_by_name("DecoderN1024R256SW6", Hk, 2, device="cpu").sw == 6
        pb = np.full((768, 5), 0.02, np.float32)
        pb[:, 2] = 0.92
        ps = np.zeros((256, 25), np.float32)
        ps[:, 12] = 1.0
        assert not dec.min_sum(pb, ps).any()
        assert kyber.simulate_kyber_attack(7, accuracy=0.995, runs=1, device="cpu")[0]["total_coefficients"] == 768
        leaked = [m for m in sys.modules if m == "sca_ldpc_tpu" or m.startswith("sca_ldpc_tpu.")
                  or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not leaked, leaked
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
