"""PyTorch port conformance: the HQC attack's masked multi-circulant decode
(``ops.circulant_bp._multi_circulant_bp`` and its per-frame form, the plain
version of the CUDA kernel K8) against the JAX package's
``_multi_circulant_bp``, on the arrays that the JAX
``MaskedCirculantCheckDecoder.build_masked_arrays`` builds for the cases of
``tests/test_hqc_attack.py``.  Decisions, convergence flags and the batch's
iteration count must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sca_ldpc_tpu.codes.make_code import make_random_ldpc_parity_check_matrix, random_circulant_first_row
from sca_ldpc_tpu.models.hqc import Hqc128, sparse_times_sparse
from sca_ldpc_tpu.models.hqc.attack import MaskedCirculantCheckDecoder, add_check
from sca_ldpc_tpu.models.hqc.tracking import HqcSimulationParams
from sca_ldpc_tpu.ops.circulant_bp import _multi_circulant_bp as jax_multi_circulant_bp
from sca_ldpc_tpu.utils import make_random_state
from sca_ldpc_tpu_torch.ops.circulant_bp import _circulant_bp_frames, _multi_circulant_bp, _multi_circulant_bp_frames
from sca_ldpc_tpu_torch.ops.kernels import multi_circulant_bp_cuda, multi_circulant_bp_plain
from sca_ldpc_tpu_torch.ops.kernels.bounds import circulant_messages, multi_circulant_messages

torch.set_num_threads(1)

METHODS = ["product_sum", "min_sum"]


def _masked(n, weight, rows_of_blocks, y_sparse, certainty=1.0):
    """A JAX masked decoder holding, for each (first row, row indices), the
    checks of those rows of that circulant with their true values."""
    params = HqcSimulationParams(Hqc128, None, None, None, WEIGHT=weight, N_OVERRIDE=n)
    decoder = MaskedCirculantCheckDecoder(params)
    checks = []
    for first_row, rows in rows_of_blocks:
        shifts = np.flatnonzero(first_row)
        y_times_r1 = sparse_times_sparse(sorted(y_sparse), [int(i) for i in shifts], n)
        for bit_n in rows:
            add_check(decoder, shifts, checks, y_times_r1, bit_n, bit_n in y_times_r1, certainty=certainty)
    return decoder, checks


def _toy():
    rng = make_random_state(0)
    hgen = make_random_ldpc_parity_check_matrix(20, 3, rng)
    return _masked(20, 3, [(hgen[0], range(20))], [4, 5, 7, 9])


def _two_blocks():
    rows = [(random_circulant_first_row(40, 3, make_random_state(seed)), range(0, 40, 2)) for seed in (10, 11)]
    return _masked(40, 3, rows, [3, 11, 17, 29, 35])


def _run(arrays, max_iter=100, method="product_sum"):
    """(port outputs, JAX outputs) of one frame's arrays, as numpy."""
    prior_c, prior_i, syn, shifts = arrays
    out = _multi_circulant_bp(torch.as_tensor(prior_c[None]), torch.as_tensor(prior_i[None]),
                              torch.as_tensor(syn[None]), torch.as_tensor(shifts), max_iter, method)
    ref = jax_multi_circulant_bp(jnp.asarray(prior_c[None]), jnp.asarray(prior_i[None]), jnp.asarray(syn[None]),
                                 jnp.asarray(shifts), max_iter, method)
    return [x.numpy() for x in out], [np.asarray(x) for x in ref]


def _assert_equal(out, ref):
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", METHODS)
def test_toy_matches_jax(method):
    """test_hqc_attack.py's N = 20 toy: every row of one circulant measured."""
    decoder, checks = _toy()
    out, ref = _run(decoder.build_masked_arrays(checks, [4, 5, 7, 9]), method=method)
    _assert_equal(out, ref)
    assert out[2].all()
    assert set(np.flatnonzero(out[0][0]).tolist()) == {4, 5, 7, 9}


@pytest.mark.parametrize("method", METHODS)
def test_two_blocks_and_padding_match_jax(method):
    """N = 40 with P = 2 (every other row of two circulants), and the same
    padded to P = 8 with all-inert blocks: equal to JAX, and the padded
    decisions bit-identical to the unpadded ones."""
    y = [3, 11, 17, 29, 35]
    decoder, checks = _two_blocks()
    assert len(decoder._block_shifts) == 2
    out, ref = _run(decoder.build_masked_arrays(checks, y), method=method)
    _assert_equal(out, ref)
    out8, ref8 = _run(decoder.build_masked_arrays(checks, y, p_pad=8), method=method)
    _assert_equal(out8, ref8)
    np.testing.assert_array_equal(out8[0], out[0])
    np.testing.assert_array_equal(out8[1][:, :2], out[1])
    np.testing.assert_array_equal(out8[2], out[2])
    assert int(out8[3]) == int(out[3])
    if method == "product_sum":
        assert out[2].all() and set(np.flatnonzero(out[0][0]).tolist()) == set(y)


def _batch3():
    """Three frames of the P = 2 code: all checks, half the checks with a
    certainty of 0.99, and the checks with the first two values flipped."""
    y = [3, 11, 17, 29, 35]
    decoder, checks = _two_blocks()
    frames = [decoder.build_masked_arrays(checks, y)]
    d2, c2 = _two_blocks()
    c2 = [(c, 0.99 if i % 2 else 1.0) for i, (c, _p) in enumerate(c2)]
    frames.append(d2.build_masked_arrays(c2, y))
    d3, c3 = _two_blocks()
    c3 = [(not c if i < 2 else c, p) for i, (c, p) in enumerate(c3)]
    frames.append(d3.build_masked_arrays(c3, y))
    return [np.stack([f[i] for f in frames]) for i in range(3)] + [frames[0][3]]


@pytest.mark.parametrize("method", METHODS)
def test_batch_of_three_frames(method):
    """Batch 3 with frames that converge at different iterations: equal to
    JAX; each frame's count equal to decoding it alone."""
    prior_c, prior_i, syn, shifts = _batch3()
    args = (torch.as_tensor(prior_c), torch.as_tensor(prior_i), torch.as_tensor(syn), torch.as_tensor(shifts))
    e_c, e_i, conv, iters = _multi_circulant_bp_frames(*args, 30, method)
    ref = jax_multi_circulant_bp(*(jnp.asarray(x) for x in (prior_c, prior_i, syn, shifts)), 30, method)
    _assert_equal([e_c.numpy(), e_i.numpy(), conv.numpy(), int(iters.max())], [np.asarray(x) for x in ref])
    for f in range(3):
        alone = _multi_circulant_bp_frames(*(x[f : f + 1] for x in args[:3]), args[3], 30, method)
        np.testing.assert_array_equal(alone[0].numpy()[0], e_c.numpy()[f])
        np.testing.assert_array_equal(alone[1].numpy()[0], e_i.numpy()[f])
        assert int(alone[3][0]) == int(iters[f])
    if method == "product_sum":
        assert len(set(iters.tolist())) > 1, iters


@pytest.mark.parametrize("method", METHODS)
def test_one_block_equals_circulant_bp(method):
    """P = 1 is the circulant decode of [circulant | I] with prior_i as the
    identity priors: equal decisions and per-frame iteration counts."""
    n, w, b = 128, 4, 8
    shifts = np.flatnonzero(random_circulant_first_row(n, w, make_random_state(5)))
    rng = np.random.RandomState(2)
    err = (rng.rand(b, 2 * n) < 0.02).astype(np.int32)
    syn = (sum(np.roll(err[:, :n], k, axis=-1) for k in shifts) + err[:, n:]) % 2
    prior_c = torch.full((b, n), float(np.log(0.98 / 0.02)))
    prior_i = torch.as_tensor(rng.uniform(1.0, 5.0, (b, n)).astype(np.float32))
    prior_i[:, :10] = 0.0  # inert rows
    e_c, e_i, conv, iters = _multi_circulant_bp_frames(prior_c, prior_i[:, None], torch.as_tensor(syn)[:, None],
                                                       torch.as_tensor(shifts)[None], 25, method)
    e, conv2, iters2 = _circulant_bp_frames(prior_c, prior_i, torch.as_tensor(syn), tuple(int(k) for k in shifts),
                                            True, 25, method)
    np.testing.assert_array_equal(torch.cat([e_c, e_i[:, 0]], dim=-1).numpy(), e.numpy())
    np.testing.assert_array_equal(conv.numpy(), conv2.numpy())
    np.testing.assert_array_equal(iters.numpy(), iters2.numpy())


def test_hqc128_size_decode_matches_jax():
    """test_full_decode's configuration: N = 17,669, weight 3, perfect
    value-1 checks only (the other rows inert)."""
    rng = make_random_state(0)
    y = [int(v) for v in rng.choice(17669, Hqc128.params("OMEGA"), replace=False)]
    first_row = random_circulant_first_row(17669, 3, rng)
    y_times_r1 = set(sparse_times_sparse(sorted(y), [int(i) for i in np.flatnonzero(first_row)], 17669))
    decoder, checks = _masked(17669, 3, [(first_row, sorted(y_times_r1))], y)
    out, ref = _run(decoder.build_masked_arrays(checks, y))
    _assert_equal(out, ref)
    assert out[2].all() and set(np.flatnonzero(out[0][0]).tolist()) == set(y)


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    prior_c, prior_i, syn, shifts = _batch3()
    args = (torch.as_tensor(prior_c), torch.as_tensor(prior_i), torch.as_tensor(syn), shifts)
    out = multi_circulant_bp_cuda(*args, 30)
    plain = multi_circulant_bp_plain(*args, 30)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert out[0].dtype == torch.int32 and out[1].dtype == torch.int32 and out[2].dtype == torch.bool
    # shifts outside [0, N) act modulo N, as jnp.roll's do
    wrapped = multi_circulant_bp_cuda(*args[:3], shifts + 40 * np.array([[1], [-2]]), 30)
    for a, b in zip(out, wrapped):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["prior_c_rank", "prior_i_shape", "shifts_rows", "shifts_dtype", "method",
                                 "max_iter", "dtype"])
def test_wrapper_rejects_unsupported_inputs(bad):
    prior_c, prior_i, syn, shifts = (torch.as_tensor(x) for x in _batch3())
    kw = dict(prior_c=prior_c, prior_i=prior_i, syndrome=syn, shifts=shifts, max_iter=5, method="product_sum")
    if bad == "prior_c_rank":
        kw["prior_c"] = prior_c[0]
    elif bad == "prior_i_shape":
        kw["prior_i"] = prior_i[:, :1]
    elif bad == "shifts_rows":
        kw["shifts"] = shifts[:1]
    elif bad == "shifts_dtype":
        kw["shifts"] = shifts.float()
    elif bad == "method":
        kw["method"] = "bogus"
    elif bad == "max_iter":
        kw["max_iter"] = -1
    else:
        kw["prior_i"] = prior_i.double()
    with pytest.raises((ValueError, TypeError)):
        multi_circulant_bp_cuda(**kw)


def test_message_count_reads_like_the_circulant_count():
    """K8's message count at P = 1 is K1/K2's with the identity; P blocks
    count P times the checks."""
    assert multi_circulant_messages(7, 1, 20, 17669) == circulant_messages(7, 20, 17669)
    assert multi_circulant_messages(7, 3, 20, 17669) == 3 * circulant_messages(7, 20, 17669)
