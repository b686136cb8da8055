"""PyTorch port conformance: the several-rank layer (``parallel/``) in one
process, on the CPU, against the JAX package.

The counterparts of ``tests/test_parallel.py``.  A W-rank run is W calls of
a rank's plain function (its rows of the batch or of the instances), summed
or concatenated as the collectives would; ``tests/test_torch_parallel_world.py``
runs real gloo worlds.

- the mesh: shapes and the JAX package's errors in the world of one;
  ``init_distributed``'s no-op;
- the FER step's ``"decode"`` branch (the JAX ``"xla"`` branch): decisions,
  ``conv`` and ``iters`` equal to the JAX ``_circulant_bp`` (with and without
  the identity) and ``_bp_decode_syndrome`` on fixed errors, non-uniform
  rates included;
- the sharded FER: 1, 2 and 4 ranks count for count equal, and equal to
  ``fer_simulation`` at the same batch, for ``"decode"`` and ``"fused"``;
  the JAX tests' circulant and general-layout runs;
- the sharded masked decode: every instance equal to the JAX
  ``_multi_circulant_bp`` at 1 and 2 instances a rank;
- the sharded q-ary FER: equal over 1, 2 and 4 ranks, the "nothing failed"
  value the global batch (one rank failing alone), within 3 binomial sigma of
  the JAX sharded step;
- the sharded special decode equal to the JAX ``QarySpecialDecoder.min_sum``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sca_ldpc_tpu.ops.binary_bp import _bp_decode_syndrome as jax_bp_decode_syndrome
from sca_ldpc_tpu.ops.circulant_bp import _circulant_bp as jax_circulant_bp
from sca_ldpc_tpu.ops.circulant_bp import _multi_circulant_bp as jax_multi_circulant_bp
from sca_ldpc_tpu_torch.codes import (
    CirculantLayout,
    CodeLayout,
    make_qc_parity_check_matrix,
    make_regular_ldpc_parity_check_matrix,
    make_regular_ldpc_parity_check_matrix_identity,
    random_circulant_first_row,
)
from sca_ldpc_tpu_torch.ops.qary import QaryDecoder
from sca_ldpc_tpu_torch.ops.qary_special import QarySpecialDecoder
from sca_ldpc_tpu_torch.parallel import (
    Mesh,
    fer_simulation,
    init_distributed,
    make_fer_step,
    make_mesh,
    make_sharded_fer_step,
    make_sharded_masked_decode,
    make_sharded_qary_fer_step,
    make_sharded_special_decode,
    sharded_fer_simulation,
    sharded_qary_fer_simulation,
)
from sca_ldpc_tpu_torch.parallel.attack import decode_rows
from sca_ldpc_tpu_torch.parallel.fer import _decoder
from sca_ldpc_tpu_torch.parallel.mesh import shard_rows
from sca_ldpc_tpu_torch.parallel.qary import make_qary_fer_rows, qary_channel_rows
from sca_ldpc_tpu_torch.utils import make_random_state
from torch_world_worker import attack_instances

torch.set_num_threads(1)


def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def _circulant(n, w, seed, with_identity=True):
    return CirculantLayout.from_first_row(random_circulant_first_row(n, w, make_random_state(seed)), with_identity)


# -- the mesh -------------------------------------------------------------------


def test_mesh_shapes_and_errors():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1 and mesh.rank == 0
    assert mesh.device == torch.device("cpu") and mesh.group is None
    assert make_mesh(data=1, model=1, ranks=[0], device="cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="mesh 4x2 != 1 ranks"):
        make_mesh(data=4, model=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by model=2"):
        make_mesh(model=2, device="cpu")
    with pytest.raises(ValueError, match="needs a process group"):
        Mesh(4, 2, 0, "cpu")
    assert [shard_rows(16, r, 4) for r in range(4)] == [slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]
    with pytest.raises(ValueError):
        shard_rows(10, 0, 4)
    x = torch.arange(6)
    assert mesh.all_gather(x) is x and mesh.all_reduce(x, "max") is x
    mesh.check_same([1, 2], "nothing")


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        make_mesh()


def test_init_distributed_single_process_is_a_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="needs a coordinator address"):
        init_distributed(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        init_distributed("localhost:1", 2, 0, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="outside a world"):
        init_distributed("localhost:1", 2, 2, device="cpu")


# -- the FER step's decode branch -------------------------------------------------


def _jax_prior(probs):
    p = jnp.clip(jnp.asarray(probs), 1e-30, 1 - 1e-12)
    return jnp.log((1.0 - p) / p)


@pytest.mark.parametrize("method", ["product_sum", "min_sum"])
@pytest.mark.parametrize("with_identity", [True, False])
def test_decode_branch_circulant_matches_jax(with_identity, method):
    """Non-uniform rates, 24 frames at about 3% errors (some do not
    converge within 12 iterations)."""
    n = 128
    lay = _circulant(n, 4, 5, with_identity)
    rng = np.random.RandomState(2)
    probs = rng.uniform(0.01, 0.05, lay.n_vars).astype(np.float32)
    errors = (rng.rand(24, lay.n_vars) < probs).astype(np.int32)
    e, conv, it = _decoder(lay, probs, "cpu", 12, method)(torch.from_numpy(errors))

    ec, ei = errors[:, :n], errors[:, n:]
    syn = sum(np.roll(ec, k, axis=-1) for k in lay.shifts) + (ei if with_identity else 0)
    prior = _jax_prior(probs)
    pc = jnp.broadcast_to(prior[:n], (24, n))
    pi = jnp.broadcast_to(prior[n:], (24, n)) if with_identity else jnp.zeros((24, n))
    ej, cj, ij = jax_circulant_bp(pc, pi, jnp.asarray(syn % 2), lay.shifts, with_identity, 12, method)
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(cj))
    assert int(it) == int(ij) and 1 <= int(it) <= 12


@pytest.mark.parametrize("method", ["product_sum", "min_sum"])
def test_decode_branch_general_layout_matches_jax(method):
    H = make_regular_ldpc_parity_check_matrix(96, 48, 3, 6, make_random_state(1))
    lay = CodeLayout.from_h(H)
    rng = np.random.RandomState(3)
    probs = rng.uniform(0.01, 0.04, lay.n).astype(np.float32)
    errors = (rng.rand(32, lay.n) < probs).astype(np.int32)
    e, conv, it = _decoder(lay, probs, "cpu", 15, method)(torch.from_numpy(errors))

    bits = np.concatenate([errors, np.zeros((32, 1), np.int32)], axis=1)[:, lay.chk_var]
    syn = np.where(lay.chk_mask, bits, 0).sum(-1) % 2
    ej, cj, ij = jax_bp_decode_syndrome(jnp.asarray(lay.chk_var), jnp.asarray(lay.chk_mask),
                                        jnp.asarray(lay.var_flat), jnp.asarray(lay.var_mask), _jax_prior(probs),
                                        jnp.asarray(syn), 15, method, lay.dc)
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(cj))
    assert int(it) == int(ij)


def test_decode_step_counts_its_frames():
    """The step's three values are those of its frames: successes and
    converged counted from the decisions, iters the batch's count."""
    lay = _circulant(64, 3, 2, with_identity=False)
    probs = np.full(lay.n_vars, 0.03, np.float32)
    ok, conv, it = make_fer_step(lay, probs, "cpu", max_iter=10, backend="decode")(_gen(4), 40)
    errors = (torch.rand((40, lay.n_vars), generator=_gen(4)) < torch.from_numpy(probs)).to(torch.int32)
    e, c, i = _decoder(lay, probs, "cpu", 10, "product_sum")(errors)
    assert int(ok) == int((e == errors).all(-1).sum()) and int(conv) == int(c.sum()) and int(it) == int(i) >= 1
    assert ok.dtype == conv.dtype == torch.int64 and it.dtype == torch.int32
    with pytest.raises(ValueError, match="entries for"):
        make_fer_step(lay, probs[:-1], "cpu", backend="decode")
    with pytest.raises(ValueError, match="unknown FER backend"):
        make_sharded_fer_step(lay, probs, make_mesh(device="cpu"), backend="xla")


# -- the sharded FER --------------------------------------------------------------


def _rank_loop(step, seed, batch, world):
    """The sharded step over ``world`` ranks, a rank at a time: each rank's
    generator seeded alike, its rows decoded, the counts summed and the
    iterations' largest taken, as the collectives do."""
    outs = [step(_gen(seed), batch, shard_rows(batch, r, world)) for r in range(world)]
    return int(sum(o[0] for o in outs)), int(sum(o[1] for o in outs)), int(max(o[2] for o in outs))


@pytest.mark.parametrize("case", ["decode-circulant", "decode-general", "fused"])
def test_sharded_fer_equal_over_world_sizes(case):
    if case == "decode-general":
        lay = CodeLayout.from_h(make_regular_ldpc_parity_check_matrix(96, 48, 3, 6, make_random_state(1)))
        probs = np.full(lay.n, 0.04, np.float32)
    else:
        lay = _circulant(128, 4, 5)
        probs = np.full(lay.n_vars, 0.03, np.float32)
    backend = "fused" if case == "fused" else "decode"
    step = make_fer_step(lay, probs, "cpu", max_iter=20, backend=backend)
    batch = 32
    counts = {w: _rank_loop(step, 9, batch, w) for w in (1, 2, 4)}
    assert counts[1] == counts[2] == counts[4]
    assert 0 < counts[1][0] < batch  # the rate has power: some frames fail
    # two batches: the 1-rank sharded run equals fer_simulation at that batch
    mesh = make_mesh(device="cpu")
    sharded = sharded_fer_simulation(lay, probs, 2 * batch, _gen(9), mesh, batch=batch, max_iter=20, backend=backend)
    single = fer_simulation(lay, probs, 2 * batch, _gen(9), "cpu", batch=batch, max_iter=20, backend=backend)
    assert sharded == single and sharded[1] == 2 * batch


def test_sharded_fer_circulant():
    lay = _circulant(64, 5, 0)
    probs = np.full(2 * 64, 0.01, np.float32)
    successes, frames = sharded_fer_simulation(lay, probs, 64, _gen(0), make_mesh(device="cpu"), max_iter=20)
    assert frames >= 64 and successes / frames > 0.9


def test_sharded_fer_general_layout():
    lay = CodeLayout.from_h(make_regular_ldpc_parity_check_matrix(48, 24, 3, 6, make_random_state(1)))
    probs = np.full(48, 0.01, np.float32)
    successes, frames = sharded_fer_simulation(lay, probs, 64, _gen(1), make_mesh(device="cpu"), max_iter=30)
    assert successes / frames > 0.9


def test_sharded_fer_batch_arithmetic():
    """The JAX package's rounding: a batch a multiple of the granule (8 a
    rank for the kernel backends), frames possibly above runs."""
    lay = _circulant(32, 3, 2)
    probs = np.full(64, 0.02, np.float32)
    mesh = make_mesh(device="cpu")
    assert sharded_fer_simulation(lay, probs, 20, _gen(1), mesh, max_iter=5, backend="fused")[1] == 24
    assert sharded_fer_simulation(lay, probs, 20, _gen(1), mesh, batch=6, max_iter=5)[1] == 20
    step = make_sharded_fer_step(lay, probs, mesh, max_iter=5, backend="fused")
    with pytest.raises(ValueError, match="not a multiple of 8"):
        step(_gen(1), 12)
    ok, conv, it = step(_gen(1), 16)
    assert int(it) == -1 and 0 <= int(ok) <= int(conv) <= 16


# -- the sharded masked decode ------------------------------------------------------


@pytest.mark.parametrize("per_rank", [1, 2])
def test_sharded_masked_decode_matches_jax(per_rank):
    """8 ranks, one or two instances each: every instance equal to its own
    JAX ``_multi_circulant_bp`` decode."""
    world = 8
    i_n = world * per_rank
    arrays = attack_instances(48, 2, 3, i_n, 9 + per_rank, 3)
    parts = [decode_rows(*arrays, shard_rows(i_n, r, world), "cpu", 30) for r in range(world)]
    e_c, e_i, conv = (torch.cat(p).numpy() for p in zip(*parts))
    prior_c, prior_i, syn, shifts = arrays
    for i in range(i_n):
        rc, ri, rconv, _ = jax_multi_circulant_bp(jnp.asarray(prior_c[i:i + 1]), jnp.asarray(prior_i[i:i + 1]),
                                                  jnp.asarray(syn[i:i + 1]), jnp.asarray(shifts[i]), 30,
                                                  "product_sum")
        assert (np.asarray(rc[0]) == e_c[i]).all() and (np.asarray(ri[0]) == e_i[i]).all()
        assert bool(rconv[0]) == bool(conv[i])
    assert conv.any()
    # the world of one decodes them all in one call, to the same decisions
    one = make_sharded_masked_decode(make_mesh(device="cpu"), max_iter=30)(*arrays)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(one, (e_c, e_i, conv)))


# -- the sharded q-ary FER ----------------------------------------------------------


def _qary_decoder(seed=5, b=1, iters=8):
    H = make_qc_parity_check_matrix(16, 3, 2, make_random_state(seed))
    return QaryDecoder(H.astype(np.int8), b_range=b, max_iter=iters, device="cpu")


def _qary_rank_loop(local, seed, batch, world):
    outs = [local(_gen(seed), batch, shard_rows(batch, r, world)) for r in range(world)]
    return [int(sum(o[0] for o in outs)), int(max(o[1] for o in outs)), int(min(o[2] for o in outs))]


def test_qary_channel_rows_equal_jax():
    from sca_ldpc_tpu.parallel.qary import qary_channel_rows as jax_rows

    for b in (1, 2, 7):
        assert all(np.array_equal(x, y) for x, y in zip(qary_channel_rows(b), jax_rows(b)))


def test_sharded_qary_fer_equal_over_world_sizes():
    dec = _qary_decoder()
    local = make_qary_fer_rows(dec, 0.05)
    stats = {w: _qary_rank_loop(local, 3, 32, w) for w in (1, 2, 4, 8)}
    assert stats[1] == stats[2] == stats[4] == stats[8]
    succ, max_ok, min_fail = stats[1]
    assert 0 < succ < 32 and max_ok >= 1 and 1 <= min_fail < 32
    step = make_sharded_qary_fer_step(dec, 0.05, make_mesh(device="cpu"))
    assert [int(x) for x in step(_gen(3), 32)] == [*stats[1], 32]


def _n450_decoder():
    """DecoderN450R150V3C7B1's shape: the (3, 6)-regular code of 300 columns
    with the identity, B = 1, 5 iterations."""
    H = make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, make_random_state(2))
    return H, QaryDecoder(H.astype(np.int8), b_range=1, max_iter=5, device="cpu")


def test_sharded_qary_min_errs_fail_is_the_global_batch():
    """One rank's frame fails, the other ranks' all succeed: their "nothing
    failed" is the global batch, so the MIN is the one real failure, also
    when it has more noisy symbols than a rank has frames."""
    local = make_qary_fer_rows(_n450_decoder()[1], 0.003)
    batch, world = 4, 4
    for seed in range(300):
        outs = [local(_gen(seed), batch, shard_rows(batch, r, world)) for r in range(world)]
        failing = [r for r, o in enumerate(outs) if int(o[0]) < batch // world]
        if len(failing) == 1 and batch // world < int(outs[failing[0]][2]) < batch:
            break
    else:
        pytest.fail("no seed with one failing rank")
    assert all(int(outs[r][2]) == batch for r in range(world) if r not in failing)
    assert _qary_rank_loop(local, seed, batch, world)[2] == int(outs[failing[0]][2])
    assert _qary_rank_loop(local, seed, batch, 1) == _qary_rank_loop(local, seed, batch, world)


def test_sharded_qary_fer_within_3_sigma_of_jax():
    """The JAX sharded step on a one-device mesh and the port's, 1,024 frames
    each on DecoderN450R150V3C7B1's code at 0.002, where about a quarter of
    the frames decode."""
    from sca_ldpc_tpu.codes.make_code import make_regular_ldpc_parity_check_matrix_identity as jax_make
    from sca_ldpc_tpu.ops.qary import QaryDecoder as JaxQaryDecoder
    from sca_ldpc_tpu.parallel import make_mesh as jax_make_mesh
    from sca_ldpc_tpu.parallel.qary import sharded_qary_fer_simulation as jax_sim

    H, dec = _n450_decoder()
    assert np.array_equal(H, jax_make(300, 150, 3, 6, make_random_state(2)))
    runs, rate = 1024, 0.002
    jax_mesh = jax_make_mesh(data=1, model=1, devices=jax.devices()[:1])
    with jax_mesh:
        ref = jax_sim(JaxQaryDecoder(H.astype(np.int8), b_range=1, max_iter=5), rate, runs, jax.random.PRNGKey(1),
                      jax_mesh, batch=256)
    got = sharded_qary_fer_simulation(dec, rate, runs, _gen(1), make_mesh(device="cpu"), batch=256)
    assert ref[3] == got[3] == runs
    pooled = (ref[0] + got[0]) / (2 * runs)
    assert 0.1 < pooled < 0.9
    assert abs(ref[0] - got[0]) / runs <= 3 * np.sqrt(2 * pooled * (1 - pooled) / runs)


def test_sharded_qary_fer_simulation_runs():
    succ, max_ok, min_fail, frames = sharded_qary_fer_simulation(_qary_decoder(6), 0.05, 40, _gen(1),
                                                                 make_mesh(device="cpu"))
    assert frames >= 40 and 0 <= succ <= frames
    assert min_fail is None or min_fail >= 1


# -- the sharded special decode ------------------------------------------------------


def test_sharded_special_decode_matches_jax():
    from sca_ldpc_tpu.ops.qary_special import QarySpecialDecoder as JaxSpecialDecoder

    rng = make_random_state(7)
    nb, r, sw, b, bsum = 24, 8, 3, 2, 6
    H = np.zeros((r, nb + r), np.int8)
    for i in range(r):
        cols = rng.choice(nb, sw, replace=False)
        H[i, cols] = rng.choice([-1, 1], sw)
        H[i, nb + i] = 1
    i_n, world = 8, 4
    p_b = rng.rand(i_n, nb, 2 * b + 1).astype(np.float32) + 0.1
    p_b /= p_b.sum(-1, keepdims=True)
    p_s = rng.rand(i_n, r, 2 * bsum + 1).astype(np.float32) + 0.1
    p_s /= p_s.sum(-1, keepdims=True)
    dec = QarySpecialDecoder(H, b, bsum, max_iter=6, device="cpu")
    hard = torch.cat([dec.min_sum(p_b[shard_rows(i_n, k, world)], p_s[shard_rows(i_n, k, world)])
                      for k in range(world)]).numpy()
    ref = np.asarray(JaxSpecialDecoder(H, b, bsum, max_iter=6).min_sum(p_b, p_s))
    np.testing.assert_array_equal(hard, ref)
    one = make_sharded_special_decode(dec, make_mesh(device="cpu"))(p_b, p_s)
    np.testing.assert_array_equal(one.numpy(), ref)


@pytest.mark.parametrize("entry", ["parallel.mesh:make_mesh", "parallel.distributed:init_distributed",
                                   "parallel.distributed:rank_device"])
def test_entry_points_default_to_the_card(entry):
    """The sharded functions run on their mesh's device, which is the card
    unless the caller asks for the CPU."""
    import importlib
    import inspect

    module, name = entry.split(":")
    fn = getattr(importlib.import_module(f"sca_ldpc_tpu_torch.{module}"), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
