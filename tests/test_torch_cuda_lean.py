"""The lean CUDA kernels (K3 circulant_bp_lean_cuda, K4
circulant_fer_lean_cuda) and K2's decode of a layout without the identity
block against their plain PyTorch versions, on the card.  Without a CUDA
device every test skips.  This file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest tests/test_torch_cuda_lean.py
"""

import numpy as np
import pytest
import torch

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
from sca_ldpc_tpu_torch.parallel import fer_simulation
from sca_ldpc_tpu_torch.utils import make_random_state, rng_to_torch_generator

pytestmark = pytest.mark.cuda

# (n, w, batch, error rate): small codes at noisy rates, a batch of one, a
# batch that is a multiple of nothing, and HQC-256 (N = 57,637, w = 30).
CASES = [(128, 4, 64, 0.03), (150, 4, 13, 0.05), (1021, 20, 1, 0.03), (1021, 20, 64, 0.03), (57637, 30, 7, 0.01)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _layout(n, w, with_identity=True):
    return CirculantLayout.from_first_row(random_circulant_first_row(n, w, 5), with_identity=with_identity)


def _inputs(lay, b, rate, seed, device):
    rng = np.random.RandomState(seed)
    n = lay.n
    err = (rng.rand(b, lay.n_vars) < rate).astype(np.uint8)
    syn = np.zeros((b, n), np.int64)
    for k in lay.shifts:
        syn += np.roll(err[:, :n], k, axis=-1)
    if lay.with_identity:
        syn += err[:, n:]
    prior = np.float32(np.log((1 - rate) / rate))
    pc = np.full((b, n), prior, np.float32) + rng.uniform(-1, 1, (b, n)).astype(np.float32)
    pc[:, :3] = 69.0  # above the +-60 clip: the first messages are unclipped
    pi = np.full((b, n), prior, np.float32)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return to(err), to(pc), to(pi), to((syn % 2).astype(np.int32))


@pytest.mark.parametrize("n,w,b,rate", CASES)
def test_lean_bp_kernel_matches_plain(cuda, n, w, b, rate):
    """Decisions, flags and per-frame iteration counts equal on every frame:
    the kernel rounds to bf16 where the plain version does and adds the f32
    totals in the same plane order."""
    lay = _layout(n, w)
    _, pc, pi, syn = _inputs(lay, b, rate, 1, cuda)
    before = circulant_bp_lean_cuda.launches
    e, conv, iters = circulant_bp_lean_cuda(pc, pi, syn, lay.shifts, 20)
    e_p, conv_p, iters_p = circulant_bp_lean_plain(pc, pi, syn, lay.shifts, 20)
    torch.cuda.synchronize()
    assert circulant_bp_lean_cuda.launches == before + 1
    assert e.dtype == torch.int32 and e.shape == (b, 2 * n)
    assert torch.equal(e, e_p) and torch.equal(conv, conv_p) and torch.equal(iters, iters_p)


@pytest.mark.parametrize("n,w,b,rate", CASES)
def test_lean_fer_kernel_matches_plain(cuda, n, w, b, rate):
    lay = _layout(n, w)
    err, *_ = _inputs(lay, b, rate, 2, cuda)
    before = circulant_fer_lean_cuda.launches
    ok, conv = circulant_fer_lean_cuda(err, lay.shifts, rate, 20)
    ok_p, conv_p = circulant_fer_lean_plain(err, lay.shifts, rate, 20)
    torch.cuda.synchronize()
    assert circulant_fer_lean_cuda.launches == before + 1
    assert torch.equal(ok, ok_p) and torch.equal(conv, conv_p)


def test_lean_kernels_with_zero_iterations_and_empty_batch(cuda):
    lay = _layout(150, 4)
    err, pc, pi, syn = _inputs(lay, 8, 0.02, 3, cuda)
    e, conv, iters = circulant_bp_lean_cuda(pc, pi, syn, lay.shifts, 0)
    assert torch.equal(e, torch.cat([pc < 0, pi < 0], dim=-1).int()) and not conv.any() and not iters.any()
    ok, conv = circulant_fer_lean_cuda(err, lay.shifts, 0.02, 0)
    assert torch.equal(ok, ~err.bool().any(dim=-1)) and not conv.any()
    ok, conv = circulant_fer_lean_cuda(err[:0], lay.shifts, 0.02, 10)
    assert ok.shape == (0,) and conv.shape == (0,)


@pytest.mark.parametrize("method", ["product_sum", "min_sum"])
@pytest.mark.parametrize("n,w", [(128, 4), (1021, 20)])
def test_decode_without_identity_matches_plain(cuda, n, w, method):
    """K2 with ``with_identity=False``, through the wrapper and through
    CirculantBPDecoder: decisions [B, N] equal to the plain version's
    (product-sum may differ in the order of one f32 sum, as for K2)."""
    lay = _layout(n, w, with_identity=False)
    _, pc, _, syn = _inputs(lay, 64, 0.01, 4, cuda)
    zeros = torch.zeros_like(pc)
    before = circulant_bp_cuda.launches
    e, conv, iters = circulant_bp_cuda(pc, zeros, syn, lay.shifts, 20, method, with_identity=False)
    e_p, conv_p, iters_p = circulant_bp_plain(pc, zeros, syn, lay.shifts, 20, method, with_identity=False)
    torch.cuda.synchronize()
    assert circulant_bp_cuda.launches == before + 1
    assert e.shape == (64, n)
    mismatch = (e != e_p).any(dim=-1) | (conv != conv_p) | (iters != iters_p)
    assert int(mismatch.sum()) <= (0 if method == "min_sum" else 1)
    probs = torch.full((n,), 0.01, device=cuda)
    e_d, conv_d, it_d = CirculantBPDecoder(lay, 20, method, device=cuda).decode_syndrome(syn, probs, return_aux=True)
    prior = CirculantBPDecoder._to_llr(probs, n, 64).contiguous()
    e_q, conv_q, iters_q = circulant_bp_plain(prior, zeros, syn, lay.shifts, 20, method, with_identity=False)
    torch.cuda.synchronize()
    mismatch = (e_d != e_q).any(dim=-1) | (conv_d != conv_q)
    assert int(mismatch.sum()) <= (0 if method == "min_sum" else 1)
    assert e_d.shape == (64, n) and conv_d.any() and 1 <= int(it_d) <= 20


def test_fer_simulation_lean_backend_on_card(cuda):
    lay = _layout(1021, 20)
    probs = np.full(lay.n_vars, 0.01, np.float32)
    before = circulant_fer_lean_cuda.launches
    gen = rng_to_torch_generator(make_random_state(0), cuda)
    successes, frames = fer_simulation(lay, probs, 300, gen, cuda, batch=128, max_iter=20, backend="lean")
    assert frames == 300 and successes >= 297
    assert circulant_fer_lean_cuda.launches == before + 3


def test_lean_wrappers_raise_on_bad_inputs(cuda):
    lay = _layout(128, 4)
    err, pc, pi, syn = _inputs(lay, 8, 0.02, 3, cuda)
    with pytest.raises(ValueError, match="product-sum"):
        circulant_bp_lean_cuda(pc, pi, syn, lay.shifts, 5, method="min_sum")
    with pytest.raises(ValueError, match="product-sum"):
        circulant_fer_lean_cuda(err, lay.shifts, 0.02, 5, method="min_sum")
    with pytest.raises(TypeError):
        circulant_bp_lean_cuda(pc.double(), pi, syn, lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_lean_cuda(pc, pi[:, :64], syn, lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_lean_cuda(pc.t().contiguous().t(), pi, syn, lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_lean_cuda(pc, pi.cpu(), syn, lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_lean_cuda(pc, pi, syn, tuple(range(65)), 5)
    with pytest.raises(TypeError):
        circulant_fer_lean_cuda(err.float(), lay.shifts, 0.02, 5)
    with pytest.raises(ValueError):
        circulant_fer_lean_cuda(err[:, 1:], lay.shifts, 0.02, 5)
