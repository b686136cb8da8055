"""PyTorch port conformance: the lean circulant decode and FER step (the
plain versions of K3 and K4) against the JAX lean kernels, and the decoder
on a layout without the identity block, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
Pallas kernels run in interpret mode, as tests/test_pallas_kernel.py runs
them; their outputs are computed once for the module.  n = 150 takes the
JAX kernel's lane padding (m = 256), which the port does not have: the
decisions must agree all the same."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sca_ldpc_tpu.codes.layout import CirculantLayout as JaxCirculantLayout
from sca_ldpc_tpu.ops.circulant_bp import CirculantBPDecoder as JaxDecoder
from sca_ldpc_tpu.ops.kernels.circulant_pallas import circulant_bp_pallas_lean, circulant_fer_pallas_lean
from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops import CirculantBPDecoder
from sca_ldpc_tpu_torch.ops.kernels import (
    circulant_bp_cuda,
    circulant_bp_lean_cuda,
    circulant_bp_lean_plain,
    circulant_bp_plain,
    circulant_fer_lean_cuda,
    circulant_fer_lean_plain,
)
from sca_ldpc_tpu_torch.parallel import fer_simulation, make_fer_step
from sca_ldpc_tpu_torch.utils import make_random_state, rng_to_torch_generator

torch.set_num_threads(1)

CONFIGS = [(128, 4), (150, 4), (150, 8)]  # (n, w)
FER_RATE = 0.04
# The sharp case: noisy frames where storing the planes in bf16 changes
# decisions.  Seed 7 at rate 0.07 (B = 32, n = 150, w = 4) is the first seed
# of a search over seeds 0-39 and rates 0.05-0.08 at which the f32 decode
# differs from the lean decode at each of max_iter 1, 2 and 3 (on 2, 2 and 3
# frames).
SHARP_ITERS = (1, 2, 3)
SHARP_N, SHARP_W, SHARP_B, SHARP_SEED, SHARP_RATE = 150, 4, 32, 7, 0.07


def _layout(n, w):
    return CirculantLayout.from_first_row(random_circulant_first_row(n, w, 5), with_identity=True)


def _correctable(n, seed):
    """test_pallas_kernel.py's frames: B = 8, one or two errors each."""
    rng = np.random.RandomState(seed)
    err = np.zeros((8, 2 * n), np.int32)
    for i in range(8):
        err[i, rng.choice(2 * n, 1 + i % 2, replace=False)] = 1
    return err


def _decode_inputs(n, w):
    lay = _layout(n, w)
    err = _correctable(n, 5)
    syn = ((err @ lay.to_dense().T) % 2).astype(np.int32)
    prior = np.float32(np.log(0.99 / 0.01))
    pc = np.full((len(err), n), prior, np.float32)
    return lay, err, pc, pc.copy(), syn


def _fer_errors(n, seed=3, b=16):
    return (np.random.RandomState(seed).rand(b, 2 * n) < FER_RATE).astype(np.int8)


def _sharp_inputs():
    """Noisy frames with channel priors varied per position."""
    lay = _layout(SHARP_N, SHARP_W)
    rng = np.random.RandomState(SHARP_SEED)
    err = (rng.rand(SHARP_B, 2 * SHARP_N) < SHARP_RATE).astype(np.int32)
    syn = ((err @ lay.to_dense().T) % 2).astype(np.int32)
    prior = np.float32(np.log((1 - SHARP_RATE) / SHARP_RATE))
    pc = np.full((SHARP_B, SHARP_N), prior, np.float32) + rng.uniform(-1, 1, (SHARP_B, SHARP_N)).astype(np.float32)
    pi = np.full((SHARP_B, SHARP_N), prior, np.float32)
    return lay, pc, pi, syn


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.fixture(scope="module")
def jax_lean():
    """Outputs of the JAX lean kernels (interpret mode), as numpy arrays."""
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for n, w in CONFIGS:
            lay, _, pc, pi, syn = _decode_inputs(n, w)
            shifts = np.asarray(lay.shifts, np.int32)
            args = (jnp.asarray(pc), jnp.asarray(pi), jnp.asarray(syn), shifts, w, 20)
            out["bp", n, w] = circulant_bp_pallas_lean(*args, tb=8)
            out["static", n, w] = circulant_bp_pallas_lean(*args, tb=8, static_shifts=tuple(lay.shifts))
            out["fer", n, w] = circulant_fer_pallas_lean(jnp.asarray(_fer_errors(n)), shifts, w, FER_RATE, 20, tb=8)
        lay, pc, pi, syn = _sharp_inputs()
        for max_iter in SHARP_ITERS:
            out["sharp", max_iter] = circulant_bp_pallas_lean(
                jnp.asarray(pc), jnp.asarray(pi), jnp.asarray(syn), np.asarray(lay.shifts, np.int32), SHARP_W,
                max_iter, tb=8,
            )
    return {key: tuple(np.asarray(x) for x in val) for key, val in out.items()}


@pytest.mark.parametrize("variant", ["bp", "static"])
@pytest.mark.parametrize("n,w", CONFIGS)
def test_lean_decode_matches_jax_on_correctable_frames(jax_lean, n, w, variant):
    """Decisions and flags equal to the dynamic-shift and the static-shift
    JAX lean kernels (the static one groups planes, which changes its f32
    sums, so only correctable frames are compared with it)."""
    lay, err, pc, pi, syn = _decode_inputs(n, w)
    e, conv, iters = circulant_bp_lean_plain(*_torch(pc, pi, syn), lay.shifts, 20)
    ej, cj = jax_lean[variant, n, w]
    np.testing.assert_array_equal(e.numpy(), ej)
    np.testing.assert_array_equal(conv.numpy(), cj)
    np.testing.assert_array_equal(e.numpy(), err)
    assert e.dtype == torch.int32 and iters.dtype == torch.int32 and conv.all()
    assert 1 <= int(iters.min()) and int(iters.max()) <= 20


@pytest.mark.parametrize("n,w", CONFIGS)
def test_lean_fer_matches_jax(jax_lean, n, w):
    """Success and convergence flags equal to circulant_fer_pallas_lean on
    16 frames at rate 0.04, some of which fail."""
    lay = _layout(n, w)
    ok, conv = circulant_fer_lean_plain(*_torch(_fer_errors(n)), lay.shifts, FER_RATE, 20)
    okj, cj = jax_lean["fer", n, w]
    np.testing.assert_array_equal(ok.numpy(), okj)
    np.testing.assert_array_equal(conv.numpy(), cj)
    assert ok.any()


@pytest.mark.parametrize("max_iter", SHARP_ITERS)
def test_lean_decode_keeps_the_bf16_rounding_points(jax_lean, max_iter):
    """On noisy frames after 1, 2 and 3 iterations the lean decode equals the
    dynamic JAX lean kernel on every frame, while the port's f32 decode
    (circulant_bp_plain, product-sum) differs from it on at least one: the
    test tells bf16 storage from f32."""
    lay, pc, pi, syn = _sharp_inputs()
    args = (*_torch(pc, pi, syn), lay.shifts, max_iter)
    e, conv, iters = circulant_bp_lean_plain(*args)
    ej, cj = jax_lean["sharp", max_iter]
    np.testing.assert_array_equal(e.numpy(), ej)
    np.testing.assert_array_equal(conv.numpy(), cj)
    assert int(iters.max()) <= max_iter
    e_f32, conv_f32, _ = circulant_bp_plain(*args, "product_sum")
    differ = (e_f32.numpy() != ej).any(axis=-1) | (conv_f32.numpy() != cj)
    assert differ.sum() >= 1


def test_lean_with_zero_iterations_returns_channel_decisions():
    lay, pc, pi, syn = _sharp_inputs()
    e, conv, iters = circulant_bp_lean_plain(*_torch(pc, pi, syn), lay.shifts, 0)
    assert torch.equal(e, torch.from_numpy(np.concatenate([pc < 0, pi < 0], axis=-1).astype(np.int32)))
    assert not conv.any() and not iters.any()
    ok, conv = circulant_fer_lean_plain(torch.zeros(4, 2 * lay.n, dtype=torch.uint8), lay.shifts, 0.01, 0)
    assert ok.all() and not conv.any()


def test_lean_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the lean wrappers run their plain versions and launch nothing."""
    lay, pc, pi, syn = _sharp_inputs()
    args = (*_torch(pc, pi, syn), lay.shifts, 10)
    before = circulant_bp_lean_cuda.launches, circulant_fer_lean_cuda.launches
    for got, ref in zip(circulant_bp_lean_cuda(*args), circulant_bp_lean_plain(*args)):
        assert torch.equal(got, ref)
    errors = torch.from_numpy(_fer_errors(SHARP_N))
    for got, ref in zip(circulant_fer_lean_cuda(errors, lay.shifts, FER_RATE, 10),
                        circulant_fer_lean_plain(errors, lay.shifts, FER_RATE, 10)):
        assert torch.equal(got, ref)
    assert (circulant_bp_lean_cuda.launches, circulant_fer_lean_cuda.launches) == before


def test_lean_wrappers_validate_inputs():
    lay = _layout(128, 4)
    pc = torch.zeros(4, 128)
    syn = torch.zeros(4, 128, dtype=torch.int32)
    errors = torch.zeros(4, 256, dtype=torch.uint8)
    with pytest.raises(ValueError, match="product-sum"):
        circulant_bp_lean_cuda(pc, pc, syn, lay.shifts, 5, method="min_sum")
    with pytest.raises(ValueError, match="product-sum"):
        circulant_fer_lean_cuda(errors, lay.shifts, 0.01, 5, method="min_sum")
    with pytest.raises(TypeError):
        circulant_bp_lean_cuda(pc.double(), pc, syn, lay.shifts, 5)
    with pytest.raises(TypeError):
        circulant_bp_lean_cuda(pc, pc, syn.float(), lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_lean_cuda(pc, pc[:, :64], syn, lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_lean_cuda(pc[0], pc, syn, lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_lean_cuda(pc, pc, syn, tuple(range(65)), 5)
    with pytest.raises(ValueError):
        circulant_bp_lean_cuda(pc, pc, syn, lay.shifts, -1)
    with pytest.raises(TypeError):
        circulant_fer_lean_cuda(errors.float(), lay.shifts, 0.01, 5)
    with pytest.raises(ValueError):
        circulant_fer_lean_cuda(errors[:, 1:], lay.shifts, 0.01, 5)
    with pytest.raises(ValueError):
        circulant_fer_lean_cuda(errors, lay.shifts, 1.0, 5)


@pytest.mark.parametrize("method", ["product_sum", "min_sum"])
def test_decoder_without_identity_matches_jax_decoder(method):
    """A layout without the identity block: the decoder (and the K2 wrapper
    with ``with_identity=False``, which takes the plain version on the CPU)
    decodes as the JAX decoder does."""
    n = 128
    row = random_circulant_first_row(n, 4, 5)
    lay = CirculantLayout.from_first_row(row, with_identity=False)
    jax_lay = JaxCirculantLayout.from_first_row(row, with_identity=False)
    rng = np.random.RandomState(2)
    err = (rng.rand(16, n) < 0.02).astype(np.int32)
    syn = (err @ lay.to_dense().T) % 2
    probs = np.full((16, n), 0.02, np.float32) * rng.uniform(0.5, 1.5, (16, n)).astype(np.float32)
    e, conv, it = CirculantBPDecoder(lay, 20, method, device="cpu").decode_syndrome(syn, probs, return_aux=True)
    ej, cj, ij = JaxDecoder(jax_lay, 20, method).decode_syndrome(syn, probs, return_aux=True)
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(cj))
    assert int(it) == int(ij) and e.shape == (16, n) and conv.any()
    prior = CirculantBPDecoder._to_llr(torch.from_numpy(probs), n, 16).contiguous()
    ew, cw, iw = circulant_bp_cuda(prior, torch.zeros_like(prior), torch.from_numpy(syn), lay.shifts, 20, method,
                                   with_identity=False)
    np.testing.assert_array_equal(ew.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(cj))
    assert int(iw.max()) == int(ij)


def test_fer_step_lean_backend_on_cpu():
    """``backend="lean"`` steps through the lean FER plain version on the
    step's own device-sampled errors; unknown backends and min-sum raise."""
    lay = _layout(150, 4)
    probs = np.full(lay.n_vars, 0.03, np.float32)
    step = make_fer_step(lay, probs, "cpu", max_iter=20, backend="lean")
    gen = rng_to_torch_generator(make_random_state(1), "cpu")
    state = gen.get_state()
    ok, conv, iters = step(gen, 32)
    gen.set_state(state)
    errors = (torch.rand((32, lay.n_vars), generator=gen) < float(probs[0])).to(torch.uint8)
    ok_p, conv_p = circulant_fer_lean_plain(errors, lay.shifts, float(probs[0]), 20)
    assert (int(ok), int(conv)) == (int(ok_p.sum()), int(conv_p.sum()))
    assert iters.dtype == torch.int32 and iters.shape == () and int(iters) == -1
    gen = rng_to_torch_generator(make_random_state(0), "cpu")
    successes, frames = fer_simulation(lay, probs * 0.1, 20, gen, "cpu", batch=8, max_iter=20, backend="lean")
    assert frames == 20 and 18 <= successes <= 20
    with pytest.raises(ValueError):
        make_fer_step(lay, probs, "cpu", backend="pallas")
    with pytest.raises(ValueError, match="product-sum"):
        make_fer_step(lay, probs, "cpu", method="min_sum", backend="lean")(gen, 4)
