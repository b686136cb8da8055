"""The lean CUDA kernels (K3 circulant_bp_lean_cuda, K4
circulant_fer_lean_cuda) and K2's decode of a layout without the identity
block against their plain PyTorch versions, on the card.  Without a CUDA
device every test skips.  This file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest tests/test_torch_cuda_lean.py
"""

import re

import numpy as np
import pytest
import torch

from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops import CirculantBPDecoder
from sca_ldpc_tpu_torch.ops.circulant_bp import _phi
from sca_ldpc_tpu_torch.ops.kernels import (
    circulant_bp_cuda,
    circulant_bp_lean_cuda,
    circulant_bp_lean_plain,
    circulant_bp_plain,
    circulant_fer_lean_cuda,
    circulant_fer_lean_plain,
)
from sca_ldpc_tpu_torch.ops.kernels._build import build
from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
    LEAN_STATIC_SMEM,
    circulant_lean_occupancy,
    circulant_lean_phi_table,
    circulant_lean_ptxas,
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


def test_phi_table_equals_direct_phi_for_every_bf16_value(cuda):
    """The table one block builds in shared memory, read through the
    kernel's index function for all 65,536 bf16 bit patterns, equals the
    direct phi() of the same value bit for bit (NaNs left out), holds
    phi(1e-9) under the clamp and phi(60) = -0.0 above it, and agrees with
    the plain version's phi to float32 rounding of log and tanh."""
    tab, direct = circulant_lean_phi_table(cuda)
    torch.cuda.synchronize()
    bits = torch.arange(1 << 16, dtype=torch.int32, device=cuda)
    keep = (bits & 0x7FFF) <= 0x7F80
    assert int(keep.sum()) == 2 * (0x7F80 + 1)
    assert torch.equal(tab.view(torch.int32)[keep], direct.view(torch.int32)[keep])
    x = bits.to(torch.int16).view(torch.bfloat16).float().abs()
    assert torch.equal(tab[keep & (x < 1e-9)].unique(), tab[:1]) and 20.0 < float(tab[0]) < 22.0
    above = tab[keep & (x >= 60.0)]
    assert bool((above == 0).all()) and bool(torch.signbit(above).all())
    torch.testing.assert_close(tab[keep], _phi(x[keep]), rtol=1e-5, atol=2e-7)


# (n, w, batch): odd and even N, a batch of one, the weights' two ends
EDGE_CASES = [(151, 1, 5), (150, 1, 1), (1021, 64, 3), (1024, 64, 1), (257, 7, 1)]


def _edge_priors(b, n, seed, device):
    """Channel priors at both ends of phi's clamp and beyond: above 60, under
    1e-9, zero, negative, and bf16 values that round across 60."""
    rng = np.random.RandomState(seed)
    pc = (4.0 + rng.uniform(-1, 1, (b, n))).astype(np.float32)
    pi = np.full((b, n), 4.0, np.float32)
    for col, val in enumerate((69.0, 1e-12, 0.0, -0.0, -0.75, 60.0, 60.2, 59.9, 9.9e-10, 1e-9, 1e30, -61.0)):
        pc[:, col] = val
        pi[:, n - 1 - col] = val
    return torch.from_numpy(pc).to(device), torch.from_numpy(pi).to(device)


@pytest.mark.parametrize("max_iter", [1, 2, 20])
@pytest.mark.parametrize("n,w,b", EDGE_CASES)
def test_lean_kernels_match_plain_at_the_edges(cuda, n, w, b, max_iter):
    """K3 and K4 against their plain versions at odd N, batch 1, w = 1 and
    w = 64, with priors at both ends of the clamp; max_iter 1 and 2 hold the
    first iteration, which reads no plane, and the first that does."""
    # any w distinct shifts: a first row of weight 64 with a flat distance spectrum needs a larger N
    shifts = tuple(int(k) for k in np.sort(np.random.RandomState(5).choice(n, w, replace=False)))
    lay = CirculantLayout(n=n, shifts=shifts, with_identity=True)
    rate = 0.005
    err, _, _, syn = _inputs(lay, b, rate, 7, cuda)
    pc, pi = _edge_priors(b, n, 8, cuda)
    got = circulant_bp_lean_cuda(pc, pi, syn, lay.shifts, max_iter)
    ref = circulant_bp_lean_plain(pc, pi, syn, lay.shifts, max_iter)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    for fer_rate in (rate, 0.3, 0.8):  # a prior that is large, small, and negative
        got = circulant_fer_lean_cuda(err, lay.shifts, fer_rate, max_iter)
        ref = circulant_fer_lean_plain(err, lay.shifts, fer_rate, max_iter)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def test_lean_kernels_are_deterministic(cuda):
    """Two runs of K3 and of K4 on the same noisy frames give the same bits:
    every sum keeps its order and nothing is accumulated with atomics."""
    lay = _layout(1021, 20)
    err, pc, pi, syn = _inputs(lay, 64, 0.04, 9, cuda)
    runs = [circulant_bp_lean_cuda(pc, pi, syn, lay.shifts, 20) for _ in range(2)]
    fer = [circulant_fer_lean_cuda(err, lay.shifts, 0.04, 20) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(runs[0] + fer[0], runs[1] + fer[1]):
        assert torch.equal(a, b)
    assert not runs[0][1].all() and runs[0][1].any()


def test_lean_kernel_keeps_its_registers_and_occupancy(cuda):
    """Every instance within 64 registers a thread; those that w = 20 and
    w = 30 launch have no spills and hold two blocks of 512 threads (32
    warps) on an SM with their staged extrinsics."""
    ptxas = circulant_lean_ptxas()
    assert set(ptxas) == {(name, elems) for name in ("decode", "fer") for elems in (1, 2, 3, 4)}
    assert all(regs <= 64 for regs, _ in ptxas.values())
    for w in (20, 30):
        occ = circulant_lean_occupancy(w, cuda)
        assert set(occ) == {"decode", "fer"}
        for name, got in occ.items():
            assert ptxas[name, got["elems"]][1] == 0
            assert (got["blocks_per_sm"], got["resident_blocks"], got["resident_warps"]) == (2, 2, 32)


def test_lean_launch_counts_the_static_shared_memory_ptxas_reports(cuda):
    """``circulant_lean_launch`` budgets ``LEAN_STATIC_SMEM`` bytes a block for
    the phi table and the shifts: what ptxas reports for each of the kernel's
    eight instances (18,688 B)."""
    log = build("circulant_lean").with_suffix(".log").read_text()
    smem = re.findall(r"circulant_lean_kernel[^\n]*\n(?:(?!Compiling entry)[^\n]*\n)*?[^\n]*?(\d+) bytes smem", log)
    assert len(smem) == 8 and {int(x) for x in smem} == {LEAN_STATIC_SMEM} == {18688}


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
