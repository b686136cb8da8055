"""PyTorch port conformance: the batched multi-instance HQC attack's decode
rounds against the JAX package, on the CPU.

- K8's plain version with per-instance shifts ``[B, P, W]``
  (``multi_circulant_bp_plain``, what ``_multi_circulant_bp`` runs on CPU
  tensors) against the JAX ``_multi_circulant_bp`` called once an instance,
  on the cases of ``tests/test_hqc_attack.py`` (N = 20; N = 40 with P = 2,
  also padded to P = 8) beside other instances: decisions, ``conv`` and
  iteration counts exactly equal.
- The batched general decode (``ops.binary_bp.decode_received_instances``)
  against the JAX ``_batched_decode_received``: decisions exactly equal.
- Each executor's round (``_execute``) on small decoders against the JAX
  executor's: the decode statistics exactly equal.  The port pads a round to
  its own largest check and block counts, the JAX package to its buckets;
  inert padding leaves the decisions unchanged.
- The barrier: every waiter gets the round's error; an instance that ends
  deregisters.  Checkpoints of two instances with one seed do not collide.
"""

import inspect
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sca_ldpc_tpu.codes.make_code import make_random_ldpc_parity_check_matrix, random_circulant_first_row
from sca_ldpc_tpu.models.hqc import Hqc128 as JaxHqc128
from sca_ldpc_tpu.models.hqc import attack as jattack
from sca_ldpc_tpu.models.hqc import batched as jbatched
from sca_ldpc_tpu.models.hqc.tracking import HqcSimulationParams as JaxParams
from sca_ldpc_tpu.models.hqc.tracking import HqcSimulationTracking as JaxTracking
from sca_ldpc_tpu.ops.circulant_bp import _multi_circulant_bp as jax_multi_circulant_bp
from sca_ldpc_tpu.utils import make_random_state
from sca_ldpc_tpu_torch.models.hqc import Hqc128, attack, batched, simulate_hqc_attacks_batched, sparse_times_sparse
from sca_ldpc_tpu_torch.models.hqc.tracking import HqcSimulationParams, HqcSimulationTracking
from sca_ldpc_tpu_torch.ops.binary_bp import decode_received_instances
from sca_ldpc_tpu_torch.ops.circulant_bp import _multi_circulant_bp
from sca_ldpc_tpu_torch.ops.kernels import multi_circulant_bp_plain

torch.set_num_threads(1)

KEY = "fixtures/test-hqc128.key"
METHODS = ["product_sum", "min_sum"]
DECODERS = {"general": "CheckDecoder", "padded": "PaddedCheckDecoder", "circulant": "MaskedCirculantCheckDecoder"}
EXECUTORS = {"general": "BatchedDecodeExecutor", "padded": "BatchedPaddedDecodeExecutor",
             "circulant": "BatchedCirculantDecodeExecutor"}


def _rows(n, seeds, step=2):
    """(first row, measured row indices) of one circulant a seed."""
    return [(random_circulant_first_row(n, 3, make_random_state(seed)), range(seed % step, n, step)) for seed in seeds]


# (N, rows of each block, the secret): test_hqc_attack.py's N = 20 toy and
# N = 40 two-plaintext case, and other instances beside them
TOY = (20, [(make_random_ldpc_parity_check_matrix(20, 3, make_random_state(0))[0], range(20))], [4, 5, 7, 9])
TWO = (40, _rows(40, (10, 11)), [3, 11, 17, 29, 35])
ONE = (40, _rows(40, (12,), step=1), [1, 8, 20, 33])
THREE = (40, _rows(40, (13, 14, 15)), [0, 6, 19, 27])
FEW = (40, _rows(40, (16,), step=5), [2, 13, 25, 31, 38])  # too few rows: it does not converge


def _instance(mod, kind, case, **kw):
    """A decoder of ``kind`` from ``mod`` (the port or the JAX package) with
    the checks of ``case`` at their true values: (decoder, tracking,
    checks, y)."""
    n, rows, y = case
    if mod is attack:
        params, tracking_cls, extra = HqcSimulationParams(Hqc128, None, None, None, WEIGHT=3, N_OVERRIDE=n), \
            HqcSimulationTracking, {"device": "cpu"}
    else:
        params, tracking_cls, extra = JaxParams(JaxHqc128, None, None, None, WEIGHT=3, N_OVERRIDE=n), JaxTracking, {}
    decoder = getattr(mod, DECODERS[kind])(params, **kw, **extra)
    checks = []
    for first_row, bits in rows:
        shifts = np.flatnonzero(first_row)
        y_times_r1 = sparse_times_sparse(sorted(y), [int(i) for i in shifts], n)
        for bit_n in bits:
            mod.add_check(decoder, shifts, checks, y_times_r1, bit_n, bit_n in y_times_r1, certainty=1.0)
    return decoder, tracking_cls(params), checks, sorted(y)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("cases,p_pad", [((TOY, TOY), 1), ((TWO, ONE, THREE, FEW), 3), ((TWO, ONE, FEW), 8)])
def test_per_instance_shifts_equal_jax_per_instance(cases, p_pad, method):
    """One [I, P_pad, W] plain decode against the JAX decode of each instance
    alone on the same padded arrays (all equal), and the decisions against
    its decode on its own unpadded blocks (padding is inert; at odd W the
    padded rows' syndrome can take an iteration longer to settle)."""
    frames = []
    for case in cases:
        dec, _tr, checks, y = _instance(jattack, "circulant", case)
        frames.append((dec.build_masked_arrays(checks, y, p_pad=p_pad), dec.build_masked_arrays(checks, y)))
    stacked = [torch.as_tensor(np.stack([f[0][k] for f in frames])) for k in range(4)]
    e_c, e_i, conv, iters = multi_circulant_bp_plain(*stacked, 100, method)
    it = _multi_circulant_bp(*stacked, 100, method)[3]
    assert int(it) == int(iters.max())
    for i, (padded, unpadded) in enumerate(frames):
        ref, ref_unpadded = (jax_multi_circulant_bp(*(jnp.asarray(a[None]) for a in arrays[:3]),
                                                    jnp.asarray(arrays[3]), 100, method)
                             for arrays in (padded, unpadded))
        np.testing.assert_array_equal(e_c[i].numpy(), np.asarray(ref[0][0]))
        np.testing.assert_array_equal(e_i[i].numpy(), np.asarray(ref[1][0]))
        assert bool(conv[i]) == bool(ref[2][0]) and int(iters[i]) == int(ref[3])
        p = unpadded[3].shape[0]
        np.testing.assert_array_equal(e_c[i].numpy(), np.asarray(ref_unpadded[0][0]))
        np.testing.assert_array_equal(e_i[i, :p].numpy(), np.asarray(ref_unpadded[1][0]))
        assert bool(conv[i]) == bool(ref_unpadded[2][0])
    if method == "product_sum":
        assert [bool(c) for c in conv] == [case is not FEW for case in cases]


def test_batched_general_decode_equals_jax():
    """decode_received_instances against the JAX _batched_decode_received on
    the port's and the JAX decoders' arrays at one shared (R_pad, DV)."""
    cases = (TWO, ONE, THREE, FEW)
    ours = [_instance(attack, "general", c) for c in cases]
    theirs = [_instance(jattack, "general", c) for c in cases]
    r_pad = max(len(c) for _d, _t, c, _y in ours)
    dv = max(d.needed_dv() for d, *_ in ours)
    builds = [d.build_arrays(c, y, r_pad=r_pad, dv=dv) for d, _t, c, y in ours]
    jbuilds = [d.build_arrays(c, y, r_pad=r_pad, dv=dv) for d, _t, c, y in theirs]
    for (lay, ch, msg), (jlay, jch, jmsg) in zip(builds, jbuilds):
        np.testing.assert_array_equal(lay.chk_var, jlay.chk_var)
        np.testing.assert_array_equal(lay.var_flat, jlay.var_flat)
        np.testing.assert_array_equal(ch, jch)
        np.testing.assert_array_equal(msg, jmsg)
    got = decode_received_instances(*zip(*builds), device="cpu")
    want = jbatched._batched_decode_received(*zip(*jbuilds))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (4, 40 + r_pad)


def _round(mod, kind, cases, **kw):
    """One round of ``kind``'s executor from ``mod`` over ``cases``: the
    decoders' trackings after it and the executor."""
    ex_cls = getattr(batched if mod is attack else jbatched, EXECUTORS[kind])
    ex = ex_cls(len(cases), **kw, **({"device": "cpu"} if mod is attack else {}))
    items = [(tid, _instance(mod, kind, case)) for tid, case in enumerate(cases)]
    ex._execute(items)
    assert sorted(ex._results) == list(range(len(cases)))
    return [item[1][1] for item in items], ex


@pytest.mark.parametrize("kind", ["general", "padded", "circulant"])
def test_executor_round_equals_jax(kind):
    kw = {"r_cap": 16, "dv_cap": 2} if kind == "padded" else {}  # both capacities double in the round
    cases = (TWO, ONE, THREE, FEW)
    ours, ex = _round(attack, kind, cases, **kw)
    theirs, jex = _round(jattack, kind, cases, **kw)
    assert [t.decoder_stats for t in ours] == [t.decoder_stats for t in theirs]
    successes = [t.decoder_stats[-1]["success"] for t in ours]
    assert successes[1:] == [True, True, False]  # FEW has too few rows; TWO converges through "circulant" only
    assert [ex._results[i] for i in range(4)] == [jex._results[i] for i in range(4)]
    if kind == "padded":
        assert (ex.r_cap, ex.dv_cap) == (jex.r_cap, jex.dv_cap) == (64, 8)


def test_circulant_round_is_one_decode(monkeypatch):
    """A circulant round decodes every instance in one _multi_circulant_bp
    call on per-instance shifts [I, P_pad, W]."""
    calls = []

    def spy(prior_c, prior_i, syn, shifts, max_iter, method):
        calls.append(tuple(shifts.shape))
        return _multi_circulant_bp(prior_c, prior_i, syn, shifts, max_iter, method)

    monkeypatch.setattr(batched, "_multi_circulant_bp", spy)
    _round(attack, "circulant", (TWO, ONE, THREE))
    assert calls == [(3, 3, 3)]


def test_every_waiter_gets_the_round_error():
    class Boom(batched.BatchedDecodeExecutor):
        def _execute(self, items):
            raise ZeroDivisionError("the round failed")

    ex = Boom(3, device="cpu")
    errors = []

    def wait():
        try:
            ex.decode(None, None, [], [])
        except ZeroDivisionError as e:
            errors.append(e)

    threads = [threading.Thread(target=wait) for _ in range(2)]
    for t in threads:
        t.start()
    ex.deregister()  # the third instance ends: the two pending decodes run as a round
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(errors) == 2 and ex.batched_calls == 1


def test_instances_take_turns(monkeypatch):
    """One instance's host code runs at a time: its thread holds the
    batcher's turn and gives it up only while it waits for its round."""
    running, most, rounds = [0], [0], []

    class Count(batched.BatchedDecodeExecutor):
        def _execute(self, items):
            rounds.append(len(items))
            for tid, _ in items:
                self._results[tid] = True

    def instance(rng, *args, decode_executor, **kw):
        for _ in range(3):
            running[0] += 1
            most[0] = max(most[0], running[0])
            time.sleep(0.01)  # gives up the GIL, as numpy's larger calls do
            running[0] -= 1
            assert decode_executor.decode(None, None, [], [])
        return True, None

    monkeypatch.setattr(batched, "simulate_hqc_idealized_oracle", instance)
    results, calls = simulate_hqc_attacks_batched([1, 2, 3], 50, 20, executor=Count(3, device="cpu"), device="cpu")
    assert most[0] == 1 and rounds == [3, 3, 3] and calls == 3 and results == [(True, None)] * 3


@pytest.fixture
def fixture_keys(monkeypatch):
    """Every instance attacks the fixture key (keypair() comes from the OS)."""
    keypair = attack.read_or_generate_keypair(Hqc128, KEY)
    monkeypatch.setattr(Hqc128, "keypair", classmethod(lambda cls: keypair))
    return keypair


def test_equal_seeds_get_their_own_checkpoints(tmp_path, fixture_keys):
    """Two instances of one seed write two checkpoints (the JAX package names
    both ``instance_5.ckpt``), and a relaunch resumes each from its own."""
    ckpt_dir = tmp_path / "ckpts"
    kw = dict(decode_every=100, weight=20, decode_backend="general", checkpoint_dir=str(ckpt_dir), device="cpu")
    results, calls = simulate_hqc_attacks_batched([5, 5], max_oracle_calls=1500, **kw)
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["instance_0_5.ckpt", "instance_1_5.ckpt"]
    assert [ok for ok, _t in results] == [False, False]
    cut = [t.num_oracle_calls for _ok, t in results]
    resumed, _ = simulate_hqc_attacks_batched([5, 5], max_oracle_calls=3000, **kw)
    assert all(t.num_oracle_calls > c for (_ok, t), c in zip(resumed, cut))
    assert [t.decoder_stats for _ok, t in resumed][0] == [t.decoder_stats for _ok, t in resumed][1]


def test_entry_points_default_to_the_card():
    assert inspect.signature(simulate_hqc_attacks_batched).parameters["device"].default == "cuda"
    for name in EXECUTORS.values():
        assert inspect.signature(getattr(batched, name)).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            simulate_hqc_attacks_batched([1], 50, 20)
    with pytest.raises(ValueError, match="decode_backend"):
        simulate_hqc_attacks_batched([1], 50, 20, decode_backend="bogus", device="cpu")


@pytest.mark.parametrize("batch,p,w,per_frame,stage", [
    (16, 8, 20, False, 0),  # shared shifts [P, W]: staged once, whatever the batch
    (16, 8, 20, True, 1),  # a round of 16 instances at P = 8: 2,561 ints (10 KB) staged whole
    (1, 8, 20, True, 1),
    (64, 10, 20, True, 2),  # 12,802 ints: above the 48 KB a block takes without an opt-in
    (32, 383, 1, True, 1),  # 12,256 + 1 ints: the largest that fits ...
    (32, 384, 1, True, 2),  # ... and one shift a frame more
])
def test_staging_choice(batch, p, w, per_frame, stage):
    from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import MULTI_MAX_STAGED, multi_circulant_stage

    assert multi_circulant_stage(batch, p, w, per_frame) == stage
    src = (Path(__file__).resolve().parents[1] / "sca_ldpc_tpu_torch" / "csrc" / "circulant_multi.cu").read_text()
    assert f"constexpr int kMaxStaged = {MULTI_MAX_STAGED};" in src  # the kernel checks the same limit
