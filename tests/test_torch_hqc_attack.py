"""PyTorch port conformance: the HQC attack's decoders and its entry point
(``sca_ldpc_tpu_torch.models.hqc.attack``) against the JAX package's, on the
CPU.  The decoders give the JAX decoders' ``decoder_stats`` on the cases of
``tests/test_hqc_attack.py``, take the JAX decoders' ``state_dict()``, and
the attack's checkpoints resume bit for bit and refuse another noise level.
The end-to-end attacks are in ``test_torch_hqc_attack_{general,circulant}.py``."""

import inspect

import numpy as np
import pytest
import torch

from sca_ldpc_tpu.codes.make_code import make_random_ldpc_parity_check_matrix, random_circulant_first_row
from sca_ldpc_tpu.models.hqc import Hqc128 as JaxHqc128
from sca_ldpc_tpu.models.hqc import attack as jattack
from sca_ldpc_tpu.models.hqc.tracking import HqcSimulationParams as JaxParams
from sca_ldpc_tpu.models.hqc.tracking import HqcSimulationTracking as JaxTracking
from sca_ldpc_tpu_torch.models.hqc import Hqc128, simulate_hqc_idealized_oracle, sparse_times_sparse
from sca_ldpc_tpu_torch.models.hqc import attack
from sca_ldpc_tpu_torch.models.hqc.tracking import HqcSimulationParams, HqcSimulationTracking
from sca_ldpc_tpu_torch.utils import make_random_state

torch.set_num_threads(1)

KEY = "fixtures/test-hqc128.key"
TOY_Y = [4, 5, 7, 9]
TWO_Y = [3, 11, 17, 29, 35]
DECODERS = {"general": "CheckDecoder", "padded": "PaddedCheckDecoder", "circulant": "MaskedCirculantCheckDecoder"}


def _toy_rows():
    hgen = make_random_ldpc_parity_check_matrix(20, 3, make_random_state(0))
    return [(hgen[0], range(20))]


def _two_rows():
    return [(random_circulant_first_row(40, 3, make_random_state(seed)), range(0, 40, 2)) for seed in (10, 11)]


def _fill(mod, decoder, rows, y, n):
    checks = []
    for first_row, bits in rows:
        shifts = np.flatnonzero(first_row)
        y_times_r1 = sparse_times_sparse(sorted(y), [int(i) for i in shifts], n)
        for bit_n in bits:
            mod.add_check(decoder, shifts, checks, y_times_r1, bit_n, bit_n in y_times_r1, certainty=1.0)
    return checks


def _pair(kind, n, rows, y, **kw):
    """The port's and the JAX package's decoder of one kind over the same
    checks, with the decode's stats: ((decoder, checks, tracking) port, JAX)."""
    out = []
    for mod, hqc, params_cls, tracking_cls, extra in (
        (attack, Hqc128, HqcSimulationParams, HqcSimulationTracking, {"device": "cpu"}),
        (jattack, JaxHqc128, JaxParams, JaxTracking, {}),
    ):
        params = params_cls(hqc, None, None, None, WEIGHT=3, N_OVERRIDE=n)
        decoder = getattr(mod, DECODERS[kind])(params, **kw, **extra)
        checks = _fill(mod, decoder, rows, y, n)
        tracking = tracking_cls(params)
        assert decoder.decode(tracking, checks, sorted(y))
        out.append((decoder, checks, tracking))
    return out


@pytest.mark.parametrize("kind", ["general", "circulant"])
def test_toy_decode_stats_equal_jax(kind):
    (dec, _c, tr), (_jd, _jc, jtr) = _pair(kind, 20, _toy_rows(), TOY_Y)
    assert tr.decoder_stats == jtr.decoder_stats
    assert tr.decoder_stats[-1]["good_flips"] == 4 and tr.decoder_stats[-1]["bad_flips"] == 0
    assert tr.decode_seconds == 0.0  # only add_checks times the decodes


@pytest.mark.parametrize("kind", ["general", "circulant"])
def test_multi_plaintext_decode_stats_equal_jax(kind):
    (dec, _c, tr), (_jd, _jc, jtr) = _pair(kind, 40, _two_rows(), TWO_Y)
    assert tr.decoder_stats == jtr.decoder_stats
    if kind == "circulant":
        assert len(dec._block_shifts) == 2


def test_padded_decode_stats_equal_jax_and_general():
    (dec, _c, tr), (_jd, _jc, jtr) = _pair("padded", 20, _toy_rows(), TOY_Y, r_cap=64, dv_cap=4)
    assert tr.decoder_stats == jtr.decoder_stats
    (_g, _gc, gtr), _ = _pair("general", 20, _toy_rows(), TOY_Y)
    assert tr.decoder_stats == gtr.decoder_stats


def test_padded_capacity_doubling_equal_jax():
    (dec, checks, tr), (jdec, _jc, jtr) = _pair("padded", 20, _toy_rows(), TOY_Y, r_cap=8, dv_cap=1)
    assert tr.decoder_stats == jtr.decoder_stats
    assert len(checks) > 8
    assert (dec.r_cap, dec.dv_cap) == (jdec.r_cap, jdec.dv_cap)
    assert dec.r_cap >= len(checks) and dec.dv_cap >= dec.needed_dv()


@pytest.mark.parametrize("kind", ["general", "padded", "circulant"])
def test_load_state_dict_of_a_jax_decoder(kind):
    """A port decoder loaded with a JAX decoder's state_dict() holds the same
    state and builds the JAX arrays (the general decode without the JAX
    package's bucket padding rows)."""
    kw = {"r_cap": 64, "dv_cap": 4} if kind == "padded" else {}
    (_d, checks, _t), (jdec, _jc, jtr) = _pair(kind, 40, _two_rows(), TWO_Y, **kw)
    params = HqcSimulationParams(Hqc128, None, None, None, WEIGHT=3, N_OVERRIDE=40)
    dec = getattr(attack, DECODERS[kind])(params, device="cpu")
    dec.load_state_dict(jdec.state_dict())
    state, jstate = dec.state_dict(), jdec.state_dict()
    assert state.keys() == jstate.keys()
    for k in state:
        if k == "row_supports":
            assert all(np.array_equal(a, b) for a, b in zip(state[k], jstate[k]))
        else:
            assert state[k] == jstate[k]
    y = sorted(TWO_Y)
    if kind == "circulant":
        for a, b in zip(dec.build_masked_arrays(checks, y), jdec.build_masked_arrays(checks, y)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(dec.build_masked_arrays(checks, y, p_pad=8), jdec.build_masked_arrays(checks, y, p_pad=8)):
            np.testing.assert_array_equal(a, b)
    n_r = len(checks)
    lay, channel, msg = dec.build_arrays(checks, y)
    jlay, jchannel, jmsg = jdec.build_arrays(checks, y)
    assert (lay.r, lay.n) == (n_r, 40 + n_r) and jlay.r == 256  # the JAX bucket
    np.testing.assert_array_equal(lay.chk_var, jlay.chk_var[:n_r])
    np.testing.assert_array_equal(lay.chk_mask, jlay.chk_mask[:n_r])
    np.testing.assert_array_equal(channel, jchannel[: 40 + n_r])
    np.testing.assert_array_equal(msg, jmsg[: 40 + n_r])
    tracking = HqcSimulationTracking(params)
    assert dec.decode(tracking, checks, y)
    assert tracking.decoder_stats == jtr.decoder_stats


COMMON = dict(decode_every=50, weight=20, keyfile=KEY, error_rate=0.0, param_set="128", decode_backend="general",
              device="cpu")


@pytest.fixture(scope="module")
def cut_checkpoint(tmp_path_factory):
    """A run stopped by its budget mid-attack, with its checkpoint."""
    path = str(tmp_path_factory.mktemp("ckpt") / "attack.ckpt")
    ok, tracking = simulate_hqc_idealized_oracle(make_random_state(3), max_oracle_calls=5000, checkpoint_path=path,
                                                 **COMMON)
    assert not ok
    return path, tracking


def test_checkpoint_resume_follows_the_uninterrupted_run(cut_checkpoint):
    path, cut = cut_checkpoint
    ok_ref, ref = simulate_hqc_idealized_oracle(make_random_state(3), max_oracle_calls=12000, **COMMON)
    assert cut.num_oracle_calls < ref.num_oracle_calls
    ok_res, res = simulate_hqc_idealized_oracle(make_random_state(3), max_oracle_calls=12000, checkpoint_path=path,
                                                resume=True, **COMMON)
    assert ok_res == ok_ref
    assert res.num_oracle_calls == ref.num_oracle_calls
    assert res.decoder_stats == ref.decoder_stats
    assert len(ref.decoder_stats) > len(cut.decoder_stats)


@pytest.mark.parametrize("change", [{"error_rate": 0.01}, {"crosscheck_every": 10}, {"decode_every": 100},
                                    {"decode_backend": "circulant"}])
def test_resume_under_other_parameters_is_refused(cut_checkpoint, change):
    """The JAX package's config omits error_rate and crosscheck_every; the
    port's holds both."""
    path, _ = cut_checkpoint
    kw = {**COMMON, **change}
    with pytest.raises(ValueError, match="different attack parameters"):
        simulate_hqc_idealized_oracle(make_random_state(3), max_oracle_calls=6000, checkpoint_path=path,
                                      resume=True, **kw)


def test_nan_error_rate_matches_its_own_checkpoint(tmp_path):
    path = str(tmp_path / "nan.ckpt")
    kw = {**COMMON, "error_rate": float("nan")}
    simulate_hqc_idealized_oracle(make_random_state(3), max_oracle_calls=300, checkpoint_path=path, **kw)
    ok, tracking = simulate_hqc_idealized_oracle(make_random_state(3), max_oracle_calls=600, checkpoint_path=path,
                                                 resume=True, **kw)
    assert tracking.num_oracle_calls > 300


@pytest.mark.parametrize("name", ["simulate_hqc_idealized_oracle", "CheckDecoder", "PaddedCheckDecoder",
                                  "MaskedCirculantCheckDecoder"])
def test_entry_points_default_to_the_card(name):
    assert inspect.signature(getattr(attack, name)).parameters["device"].default == "cuda"


def test_attack_raises_without_a_card_and_for_the_timing_oracle(monkeypatch):
    """No card: the default device raises.  The timing oracle is ported: the
    attack calibrates the channel first (here a stand-in that raises, so the
    test measures nothing); an unknown oracle raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            simulate_hqc_idealized_oracle(make_random_state(0), 50, 20, KEY)
    from sca_ldpc_tpu_torch.models.hqc import oracle_timing

    def calibrate(*args, **kwargs):
        raise LookupError("calibration reached")

    monkeypatch.setattr(oracle_timing, "calibrate_timing_channel", calibrate)
    with pytest.raises(LookupError, match="calibration reached"):
        simulate_hqc_idealized_oracle(make_random_state(0), 50, 20, KEY, oracle_backend="timing", device="cpu")
    with pytest.raises(ValueError, match="oracle_backend"):
        simulate_hqc_idealized_oracle(make_random_state(0), 50, 20, KEY, oracle_backend="bogus", device="cpu")
    with pytest.raises(ValueError, match="decode_backend"):
        simulate_hqc_idealized_oracle(make_random_state(0), 50, 20, KEY, decode_backend="bogus", device="cpu")
