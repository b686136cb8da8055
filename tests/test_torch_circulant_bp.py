"""PyTorch port conformance: circulant BP, plain version and kernel wrappers
on the CPU, against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
Pallas kernels run in interpret mode, as tests/test_pallas_kernel.py runs
them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sca_ldpc_tpu.ops.circulant_bp import _circulant_bp as jax_circulant_bp
from sca_ldpc_tpu.ops.circulant_bp import _plane_check_update as jax_plane_check_update
from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops.circulant_bp import _circulant_bp, _plane_check_update
from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
    circulant_bp_cuda,
    circulant_bp_plain,
    circulant_fer_cuda,
    circulant_fer_plain,
)

torch.set_num_threads(1)

METHODS = ["product_sum", "min_sum"]


def _layout(n, seed=5, w=4):
    return CirculantLayout.from_first_row(random_circulant_first_row(n, w, seed), with_identity=True)


def _correctable(lay, seed):
    """test_pallas_kernel.py's frames: B = 8, one or two errors each."""
    rng = np.random.RandomState(seed)
    b, n = 8, lay.n
    err = np.zeros((b, 2 * n), np.int32)
    for i in range(b):
        err[i, rng.choice(2 * n, 1 + i % 2, replace=False)] = 1
    return err


def _noisy(lay, seed, b=64, rate=0.03):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 2 * lay.n) < rate).astype(np.int32)


def _uniform_priors(b, n, p=0.01):
    prior = np.float32(np.log((1 - p) / p))
    return np.full((b, n), prior, np.float32), np.full((b, n), prior, np.float32)


def _both(pc, pi, syn, lay, method, max_iter=20):
    ej, cj, ij = jax_circulant_bp(
        jnp.asarray(pc), jnp.asarray(pi), jnp.asarray(syn), lay.shifts, True, max_iter, method
    )
    et, ct, it = _circulant_bp(
        torch.from_numpy(pc), torch.from_numpy(pi), torch.from_numpy(syn), lay.shifts, True, max_iter, method
    )
    return (np.asarray(ej), np.asarray(cj), int(ij)), (et.numpy(), ct.numpy(), int(it))


@pytest.mark.parametrize("method", METHODS)
def test_plane_check_update_matches_jax(method):
    """Min-sum is exact (mins and one multiply), ties and magnitudes beyond
    the clip included; product-sum within rtol = atol = 1e-5 on LLRs of the
    decoder's working range, since torch's and XLA's log/tanh differ in ulps
    (with |LLR| near 60, phi(tot - pm) cancels and amplifies those ulps)."""
    rng = np.random.RandomState(0)
    planes = (rng.randn(8, 5, 128) * 3).astype(np.float32)
    if method == "min_sum":
        planes[:, :, :16] = np.round(planes[:, :, :16])  # ties
        planes[:, 0, 16:24] = 69.0  # |prior| above the clip, as _to_llr allows
        planes[:, 1, 24:32] = 0.0
    sign_syn = np.where(rng.rand(8, 128) < 0.5, 1.0, -1.0).astype(np.float32)
    got = _plane_check_update(torch.from_numpy(planes), torch.from_numpy(sign_syn), method).numpy()
    ref = np.asarray(jax_plane_check_update(jnp.asarray(planes), jnp.asarray(sign_syn), method))
    if method == "min_sum":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_plane_check_update_rejects_unknown_method():
    with pytest.raises(ValueError):
        _plane_check_update(torch.zeros(1, 2, 4), torch.ones(1, 4), "sum_product")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [128, 150])
def test_circulant_bp_matches_jax_on_correctable_frames(n, method):
    lay = _layout(n)
    err = _correctable(lay, 5)
    syn = (err @ lay.to_dense().T) % 2
    pc, pi = _uniform_priors(len(err), n)
    (ej, cj, ij), (et, ct, it) = _both(pc, pi, syn, lay, method)
    np.testing.assert_array_equal(et, ej)
    np.testing.assert_array_equal(ct, cj)
    assert it == ij
    np.testing.assert_array_equal(et, err)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [128, 150])
def test_circulant_bp_matches_jax_on_noisy_batch(n, method):
    """B = 64 at rate 0.03 with channel priors varied per position, some
    beyond the +-60 clip: conv flags and iteration count equal, decisions
    equal on the converged frames."""
    lay = _layout(n)
    err = _noisy(lay, 7)
    syn = (err @ lay.to_dense().T) % 2
    rng = np.random.RandomState(8)
    pc, pi = _uniform_priors(len(err), n, 0.03)
    pc = pc + rng.uniform(-1.0, 1.0, pc.shape).astype(np.float32)
    pc[:, :4] = 69.0
    (ej, cj, ij), (et, ct, it) = _both(pc, pi, syn, lay, method)
    np.testing.assert_array_equal(ct, cj)
    assert it == ij
    np.testing.assert_array_equal(et[cj], ej[cj])
    assert 0 < cj.sum()


def test_circulant_bp_without_identity_matches_jax():
    n = 128
    lay = CirculantLayout.from_first_row(random_circulant_first_row(n, 4, 5), with_identity=False)
    rng = np.random.RandomState(2)
    err = np.zeros((8, n), np.int32)
    for i in range(8):
        err[i, rng.choice(n, 1, replace=False)] = 1
    syn = (err @ lay.to_dense().T) % 2
    pc, pi = _uniform_priors(8, n)
    ej, cj, ij = jax_circulant_bp(
        jnp.asarray(pc), jnp.asarray(pi), jnp.asarray(syn), lay.shifts, False, 20, "product_sum"
    )
    et, ct, it = _circulant_bp(
        torch.from_numpy(pc), torch.from_numpy(pi), torch.from_numpy(syn), lay.shifts, False, 20, "product_sum"
    )
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(it) == int(ij)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [128, 150])
def test_fer_plain_matches_pallas_kernels(n, method):
    """The K1 plain version against circulant_fer_pallas, and the K2 plain
    version against circulant_bp_pallas, in interpret mode: success flags
    and decisions equal on correctable frames (the TPU kernels store bf16
    messages, so only hard results are compared)."""
    from jax.experimental.pallas import tpu as pltpu

    from sca_ldpc_tpu.ops.kernels.circulant_pallas import circulant_bp_pallas, circulant_fer_pallas

    lay = _layout(n)
    err = _correctable(lay, 5)
    syn = (err @ lay.to_dense().T) % 2
    pc, pi = _uniform_priors(len(err), n)
    with pltpu.force_tpu_interpret_mode():
        ok_pal, _ = circulant_fer_pallas(jnp.asarray(err, jnp.int8), lay.shifts, 0.01, 20, tb=8, method=method)
        e_pal, conv_pal = circulant_bp_pallas(
            jnp.asarray(pc), jnp.asarray(pi), jnp.asarray(syn), lay.shifts, 20, tb=8, method=method
        )
    ok, conv = circulant_fer_plain(torch.from_numpy(err).to(torch.int8), lay.shifts, 0.01, 20, method)
    e, conv_bp, _ = circulant_bp_plain(
        torch.from_numpy(pc), torch.from_numpy(pi), torch.from_numpy(syn), lay.shifts, 20, method
    )
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_pal))
    assert ok.all() and conv.all()
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_pal))
    np.testing.assert_array_equal(conv_bp.numpy(), np.asarray(conv_pal))


@pytest.mark.parametrize("method", METHODS)
def test_wrappers_take_the_plain_version_on_cpu(method):
    """On CPU tensors the wrappers run their plain version and launch nothing."""
    lay = _layout(150)
    err = _noisy(lay, 3, b=16, rate=0.02)
    syn = (err @ lay.to_dense().T) % 2
    pc, pi = _uniform_priors(len(err), lay.n, 0.02)
    args = (torch.from_numpy(pc), torch.from_numpy(pi), torch.from_numpy(syn), lay.shifts, 20, method)
    bp_before, fer_before = circulant_bp_cuda.launches, circulant_fer_cuda.launches
    e, conv, iters = circulant_bp_cuda(*args)
    e_p, conv_p, iters_p = circulant_bp_plain(*args)
    assert torch.equal(e, e_p) and torch.equal(conv, conv_p) and torch.equal(iters, iters_p)
    _, _, it = _circulant_bp(*args[:4], True, 20, method)
    assert int(iters.max()) == int(it)
    errors = torch.from_numpy(err)
    ok, conv = circulant_fer_cuda(errors, lay.shifts, 0.02, 20, method)
    ok_p, conv_p = circulant_fer_plain(errors, lay.shifts, 0.02, 20, method)
    assert torch.equal(ok, ok_p) and torch.equal(conv, conv_p)
    assert (circulant_bp_cuda.launches, circulant_fer_cuda.launches) == (bp_before, fer_before)


def test_wrappers_validate_inputs():
    lay = _layout(128)
    pc = torch.zeros(4, 128)
    syn = torch.zeros(4, 128, dtype=torch.int32)
    with pytest.raises(TypeError):
        circulant_bp_cuda(pc.double(), pc, syn, lay.shifts, 5)
    with pytest.raises(TypeError):
        circulant_bp_cuda(pc, pc, syn.float(), lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_cuda(pc, pc[:, :64], syn, lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_cuda(pc, pc, syn, lay.shifts, 5, method="sum_product")
    with pytest.raises(ValueError):
        circulant_bp_cuda(pc, pc, syn, (), 5)
    with pytest.raises(ValueError):
        circulant_fer_cuda(torch.zeros(4, 255, dtype=torch.uint8), lay.shifts, 0.01, 5)
    with pytest.raises(TypeError):
        circulant_fer_cuda(torch.zeros(4, 256), lay.shifts, 0.01, 5)
    with pytest.raises(ValueError):
        circulant_fer_cuda(torch.zeros(4, 256, dtype=torch.uint8), lay.shifts, 0.0, 5)
