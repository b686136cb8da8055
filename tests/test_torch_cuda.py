"""The CUDA circulant-BP kernels against their plain PyTorch versions, on
the card.  Without a CUDA device every test skips.  This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
    circulant_bp_cuda,
    circulant_bp_plain,
    circulant_fer_cuda,
    circulant_fer_plain,
    circulant_launch,
    circulant_occupancy,
    circulant_ptxas,
    smem_limits,
)

pytestmark = pytest.mark.cuda
METHODS = ["product_sum", "min_sum"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _layout(n, w=4, seed=5):
    return CirculantLayout.from_first_row(random_circulant_first_row(n, w, seed), with_identity=True)


def _inputs(lay, b, rate, seed, device):
    rng = np.random.RandomState(seed)
    err = (rng.rand(b, 2 * lay.n) < rate).astype(np.uint8)
    e_c = err[:, : lay.n].astype(np.int64)
    syn = (sum(np.roll(e_c, k, axis=1) for k in lay.shifts) + err[:, lay.n :]) % 2  # [circulant | I] @ err
    prior = np.float32(np.log((1 - rate) / rate))
    pc = np.full((b, lay.n), prior, np.float32) + rng.uniform(-1, 1, (b, lay.n)).astype(np.float32)
    pc[:, :3] = 69.0  # above the +-60 clip: the first messages are unclipped
    pi = np.full((b, lay.n), prior, np.float32)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return to(err), to(pc), to(pi), to(syn.astype(np.int32))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,w", [(128, 4), (150, 4), (1021, 20)])
def test_bp_kernel_matches_plain(cuda, n, w, method):
    """Decisions, flags and per-frame iteration counts equal on every frame,
    noisy ones included: min-sum is exact arithmetic in both, and product-sum
    differs only in the order of one f32 sum."""
    lay = _layout(n, w)
    _, pc, pi, syn = _inputs(lay, 64, 0.03, 1, cuda)
    before = circulant_bp_cuda.launches
    e, conv, iters = circulant_bp_cuda(pc, pi, syn, lay.shifts, 20, method)
    e_p, conv_p, iters_p = circulant_bp_plain(pc, pi, syn, lay.shifts, 20, method)
    torch.cuda.synchronize()
    assert circulant_bp_cuda.launches == before + 1
    assert e.dtype == torch.int32 and e.shape == (64, 2 * n)
    mismatch = (e != e_p).any(dim=-1) | (conv != conv_p) | (iters != iters_p)
    if method == "min_sum":
        assert not mismatch.any()
    else:
        assert int(mismatch.sum()) <= 1
    assert conv.any()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,w", [(150, 4), (1021, 20)])
def test_fer_kernel_matches_plain(cuda, n, w, method):
    lay = _layout(n, w)
    err, *_ = _inputs(lay, 64, 0.02, 2, cuda)
    before = circulant_fer_cuda.launches
    ok, conv = circulant_fer_cuda(err, lay.shifts, 0.02, 20, method)
    ok_p, conv_p = circulant_fer_plain(err, lay.shifts, 0.02, 20, method)
    torch.cuda.synchronize()
    assert circulant_fer_cuda.launches == before + 1
    assert int((ok != ok_p).sum()) <= (0 if method == "min_sum" else 1)
    assert ok.any()


def test_kernels_with_zero_iterations_and_empty_batch(cuda):
    lay = _layout(128)
    err, pc, pi, syn = _inputs(lay, 8, 0.02, 3, cuda)
    e, conv, iters = circulant_bp_cuda(pc, pi, syn, lay.shifts, 0)
    assert torch.equal(e[:, :128], (pc < 0).int()) and not conv.any() and not iters.any()
    ok, conv = circulant_fer_cuda(err[:0], lay.shifts, 0.02, 10)
    assert ok.shape == (0,) and conv.shape == (0,)


def test_wrappers_raise_on_bad_inputs(cuda):
    lay = _layout(128)
    err, pc, pi, syn = _inputs(lay, 8, 0.02, 3, cuda)
    with pytest.raises(TypeError):
        circulant_bp_cuda(pc.double(), pi, syn, lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_cuda(pc, pi[:, :64], syn, lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_cuda(pc.t().contiguous().t(), pi, syn, lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_cuda(pc, pi.cpu(), syn, lay.shifts, 5)
    with pytest.raises(ValueError):
        circulant_bp_cuda(pc, pi, syn, tuple(range(65)), 5)
    with pytest.raises(TypeError):
        circulant_fer_cuda(err.float(), lay.shifts, 0.02, 5)
    with pytest.raises(ValueError):
        circulant_fer_cuda(err[:, 1:], lay.shifts, 0.02, 5)


def _agree(got, ref, method):
    """Decisions, flags and iteration counts equal on every frame for
    min-sum (exact arithmetic in both); for product-sum on all but at most
    one frame, since the plain version's f32 sum over the planes may run in
    another order."""
    mismatch = (got[0] != ref[0]).any(dim=-1) | (got[1] != ref[1]) | (got[2] != ref[2])
    assert int(mismatch.sum()) <= (0 if method == "min_sum" else 1)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,w,b,placement", [(17669, 20, 8, "shared"), (57637, 30, 4, "shared"),
                                              (65003, 4, 8, "device")])
def test_both_placements_match_plain(cuda, n, w, b, placement, method):
    """tot in shared memory at the HQC-128 and HQC-256 sizes, and in device
    memory at an N above the shared-memory cap."""
    assert circulant_launch(n, w, *smem_limits(cuda)).placement == placement
    lay = _layout(n, w)
    rate = 40 / (2 * n)  # about 40 errors a frame
    _, pc, pi, syn = _inputs(lay, b, rate, 11, cuda)
    got = circulant_bp_cuda(pc, pi, syn, lay.shifts, 20, method)
    ref = circulant_bp_plain(pc, pi, syn, lay.shifts, 20, method)
    torch.cuda.synchronize()
    _agree(got, ref, method)
    assert got[1].any()
    err, *_ = _inputs(lay, b, rate, 12, cuda)
    ok, conv = circulant_fer_cuda(err, lay.shifts, rate, 20, method)
    ok_p, conv_p = circulant_fer_plain(err, lay.shifts, rate, 20, method)
    assert int((ok != ok_p).sum() + (conv != conv_p).sum()) <= (0 if method == "min_sum" else 2)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("w", [1, 8, 20, 30, 64])
def test_every_weight_bucket_matches_plain(cuda, w, method):
    """The bucket edges and the exact instances, at an odd N, with and
    without the identity block."""
    shifts = np.random.RandomState(w).choice(1021, w, replace=False)
    lay = CirculantLayout(n=1021, shifts=tuple(int(k) for k in shifts), with_identity=True)
    err, pc, pi, syn = _inputs(lay, 16, 0.002, w, cuda)
    syn_c = sum(torch.roll(err[:, :1021].int(), k, dims=-1) for k in lay.shifts) % 2
    for with_id, s in ((True, syn), (False, syn_c)):
        got = circulant_bp_cuda(pc, pi, s, lay.shifts, 20, method, with_id)
        ref = circulant_bp_plain(pc, pi, s, lay.shifts, 20, method, with_id)
        torch.cuda.synchronize()
        assert got[0].shape == (16, 2042 if with_id else 1021)
        _agree(got, ref, method)


@pytest.mark.parametrize("method", METHODS)
def test_batch_one_odd_n(cuda, method):
    lay = _layout(997, 20)
    err, pc, pi, syn = _inputs(lay, 1, 0.01, 13, cuda)
    got = circulant_bp_cuda(pc, pi, syn, lay.shifts, 30, method)
    ref = circulant_bp_plain(pc, pi, syn, lay.shifts, 30, method)
    _agree(got, ref, method)
    ok, conv = circulant_fer_cuda(err, lay.shifts, 0.01, 30, method)
    assert torch.equal(ok, circulant_fer_plain(err, lay.shifts, 0.01, 30, method)[0])


@pytest.mark.parametrize("method", METHODS)
def test_two_launches_are_bit_identical(cuda, method):
    """No atomics and a fixed summation order: the same inputs give the same
    bits, noisy frames that never converge included."""
    lay = _layout(1021, 20)
    err, pc, pi, syn = _inputs(lay, 32, 0.04, 14, cuda)
    first = circulant_bp_cuda(pc, pi, syn, lay.shifts, 25, method)
    second = circulant_bp_cuda(pc, pi, syn, lay.shifts, 25, method)
    assert not first[1].all()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    fer = [circulant_fer_cuda(err, lay.shifts, 0.04, 25, method) for _ in range(2)]
    assert torch.equal(fer[0][0], fer[1][0]) and torch.equal(fer[0][1], fer[1][1])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [17669, 35851, 57637])
@pytest.mark.parametrize("w", [20, 30])
def test_instances_keep_32_warps_without_spills(cuda, n, w, method):
    """At the HQC sizes: tot in shared memory, 64 registers or fewer and no
    spills (ptxas, for the exact instance of w), and 32 warps resident per
    SM (the occupancy calculator)."""
    occ = circulant_occupancy(n, w, method, cuda)
    assert occ["placement"] == "shared"
    regs, spill = circulant_ptxas()[(w, method, "shared")]
    assert regs <= 64 and spill == 0, (regs, spill)
    assert occ["resident_warps"] >= 32, occ
