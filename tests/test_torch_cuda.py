"""The CUDA circulant-BP kernels against their plain PyTorch versions, on
the card.  Without a CUDA device every test skips.  This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops.kernels import circulant_cuda
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
    assert occ["form"] == ("shared" if n == 57637 else "staged")
    regs, spill = circulant_ptxas()[(w, method, occ["form"])]
    assert regs <= 64 and spill == 0, (regs, spill)
    assert occ["resident_warps"] >= 32, occ


def test_no_instance_spills(cuda):
    """Every staged K1/K2 instance, and every instance of the HQC weights 20
    and 30: 64 registers or fewer (the 1024-thread launch bound) and no
    spills.  (The unstaged buckets of 32 and 64 hold up to 32 and 64
    magnitudes in registers and spill, as they did before staging.)"""
    rep = circulant_ptxas()
    assert len(rep) == 6 * 2 * 3, sorted(rep)
    assert {form for *_, form in rep} == {"device", "shared", "staged"}
    bad = {k: v for k, v in rep.items() if (k[2] == "staged" or k[0] in (20, 30)) and (v[0] > 64 or v[1])}
    assert not bad, bad


# ---- the staged form against the unstaged one and the plain version


def _near_n_layout(n, w):
    """A code whose shifts include N - 1 and N - 2: nearly every variable's
    span (j + k_t) mod N wraps."""
    shifts = list(_layout(n, w).shifts)
    shifts[:2] = [n - 1, n - 2]
    assert len(set(shifts)) == w
    return CirculantLayout(n=n, shifts=tuple(shifts), with_identity=True)


def _mixed_errors(n, b, seed):
    """[B, 2N] error bits from none (one iteration) through a few (2-3) to
    hundreds and thousands (every one of max_iter iterations)."""
    rng = np.random.RandomState(seed)
    counts = [0, 1, 3, 8, 20, 40, 300, 3000][:b] + [int(x) for x in rng.randint(0, 60, max(b - 8, 0))]
    err = np.zeros((b, 2 * n), np.uint8)
    for f, c in enumerate(counts):
        err[f, rng.choice(2 * n, c, replace=False)] = 1
    return err


def _direct(cuda, kind, staged, lay, max_iter, method, err=None, rate=None, pc=None, pi=None, syn=None):
    """K1 (kind "fer") or K2 ("bp") through the library at (N, w)'s launch,
    staged or through the unstaged shared-placement instance of the same
    shape: the outputs and the c2v planes [B, w, N] the decode left."""
    n, w = lay.n, len(lay.shifts)
    cfg = circulant_launch(n, w, *smem_limits(cuda))
    assert cfg.placement == "shared" and cfg.stage_warps > 0
    smem, slotted = (cfg.smem_bytes + cfg.stage_bytes, cfg.stage_warps) if staged else (cfg.smem_bytes, 0)
    b = (err if kind == "fer" else pc).shape[0]
    k = torch.tensor(lay.shifts, dtype=torch.int32, device=cuda)
    c2v = torch.full((b, w, cfg.ld), float("nan"), dtype=torch.float32, device=cuda)
    conv = torch.empty((b,), dtype=torch.uint8, device=cuda)
    iters = torch.empty((b,), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    lib = circulant_cuda._lib()
    if kind == "fer":
        syn_s, e_i = (torch.empty((b, n), dtype=torch.uint8, device=cuda) for _ in range(2))
        ok = torch.empty((b,), dtype=torch.uint8, device=cuda)
        rc = lib.circulant_fer_step(err.data_ptr(), float(np.log((1 - rate) / rate)), k.data_ptr(), w, n, cfg.ld, b,
                                    max_iter, circulant_cuda._METHODS[method], cfg.threads, smem, slotted,
                                    c2v.data_ptr(), None, syn_s.data_ptr(), e_i.data_ptr(), ok.data_ptr(),
                                    conv.data_ptr(), iters.data_ptr(), stream)
        out = (ok.bool(), e_i)
    else:
        s = syn.to(torch.uint8).contiguous()
        e = torch.empty((b, 2 * n), dtype=torch.uint8, device=cuda)
        rc = lib.circulant_bp_decode(pc.data_ptr(), pi.data_ptr(), s.data_ptr(), k.data_ptr(), w, n, cfg.ld, b,
                                     max_iter, circulant_cuda._METHODS[method], 1, cfg.threads, smem, slotted,
                                     c2v.data_ptr(), None, e.data_ptr(), conv.data_ptr(), iters.data_ptr(), stream)
        out = (e.int(),)
    assert rc == 0, rc
    torch.cuda.synchronize()
    return (*out, conv.bool(), iters, c2v[:, :, :n])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,w,b", [(17669, 20, 12), (17669, 30, 8), (35851, 30, 10)])
def test_staged_form_is_bit_equal(cuda, n, w, b, method):
    """HQC-128 (2 x 512 threads; every warp slotted at w = 20, 11 of 16 at w =
    30) and HQC-192 (1 x 1024, 23 of 32 slotted): the staged K1 and K2 equal
    the unstaged instance of the same shape bit for bit, outputs and the c2v
    planes alike, and the plain version frame for frame (product-sum's plain
    sum may run in another order: at most one frame apart).  Frames leave
    after 1 to 3 iterations or run all 20; N is no multiple of the 32-check
    tile, and two shifts lie next to N."""
    lay = _near_n_layout(n, w)
    max_iter = 20
    err_np = _mixed_errors(n, b, n + w)
    err = torch.from_numpy(err_np).to(cuda)
    rate = 0.002
    ok, e_i, conv, iters, planes = _direct(cuda, "fer", True, lay, max_iter, method, err=err, rate=rate)
    ref = _direct(cuda, "fer", False, lay, max_iter, method, err=err, rate=rate)
    assert all(torch.equal(x, y) for x, y in zip((ok, e_i, conv, iters), ref[:4]))
    assert torch.equal(planes.view(torch.int32), ref[4].view(torch.int32))
    assert {1, max_iter} <= set(iters.tolist()) and min(iters.tolist()) <= 3 < max(iters.tolist())
    before = circulant_fer_cuda.launches
    iters_w = torch.empty((b,), dtype=torch.int32, device=cuda)
    ok_w, conv_w = circulant_fer_cuda(err, lay.shifts, rate, max_iter, method, iters_out=iters_w)
    assert circulant_fer_cuda.launches == before + 1
    assert torch.equal(ok_w, ok) and torch.equal(conv_w, conv) and torch.equal(iters_w, iters)
    iters_p = torch.empty((b,), dtype=torch.int32, device=cuda)
    ok_p, conv_p = circulant_fer_plain(err, lay.shifts, rate, max_iter, method, iters_out=iters_p)
    mismatch = (ok != ok_p) | (conv != conv_p) | (iters != iters_p)
    assert int(mismatch.sum()) <= (0 if method == "min_sum" else 1)

    # K2: per-position priors, the syndromes of the same frames
    _, pc, pi, _ = _inputs(lay, b, rate, 7, cuda)
    e_c = err[:, :n].int()
    syn = (sum(torch.roll(e_c, k, dims=-1) for k in lay.shifts) + err[:, n:].int()) % 2
    got = _direct(cuda, "bp", True, lay, max_iter, method, pc=pc, pi=pi, syn=syn)
    ref = _direct(cuda, "bp", False, lay, max_iter, method, pc=pc, pi=pi, syn=syn)
    assert all(torch.equal(x, y) for x, y in zip(got[:3], ref[:3]))
    assert torch.equal(got[3].view(torch.int32), ref[3].view(torch.int32))
    assert 1 in got[2].tolist() and max_iter in got[2].tolist()
    wrapped = circulant_bp_cuda(pc, pi, syn, lay.shifts, max_iter, method)
    assert all(torch.equal(x, y) for x, y in zip(wrapped, got[:3]))
    _agree(got[:3], circulant_bp_plain(pc, pi, syn, lay.shifts, max_iter, method), method)


@pytest.mark.parametrize("method", METHODS)
def test_hqc256_keeps_the_unstaged_form(cuda, method):
    """HQC-256's totals fill shared memory: its launch stages nothing and the
    kernel equals the plain version as before."""
    n, w = 57637, 30
    cfg = circulant_launch(n, w, *smem_limits(cuda))
    assert (cfg.placement, cfg.stage_warps, cfg.stage_bytes) == ("shared", 0, 0)
    assert not circulant_cuda.circulant_staged(n, w, cuda)
    lay = _near_n_layout(n, w)
    err = torch.from_numpy(_mixed_errors(n, 6, 3)).to(cuda)
    iters = torch.empty((6,), dtype=torch.int32, device=cuda)
    ok, conv = circulant_fer_cuda(err, lay.shifts, 0.002, 20, method, iters_out=iters)
    iters_p = torch.empty((6,), dtype=torch.int32, device=cuda)
    ok_p, conv_p = circulant_fer_plain(err, lay.shifts, 0.002, 20, method, iters_out=iters_p)
    mismatch = (ok != ok_p) | (conv != conv_p) | (iters != iters_p)
    assert int(mismatch.sum()) <= (0 if method == "min_sum" else 1)
