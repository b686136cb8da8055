"""The CUDA kernel K8 (``multi_circulant_bp_cuda``, the HQC attack's masked
multi-circulant decode) against its plain PyTorch version and, at P = 1,
against K2, on the card.  Without a CUDA device every test skips.  This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda_multi.py
"""

import numpy as np
import pytest
import torch

from sca_ldpc_tpu_torch.codes import random_circulant_first_row
from sca_ldpc_tpu_torch.models.hqc import sparse_times_sparse
from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
    circulant_bp_cuda,
    multi_circulant_blocks,
    multi_circulant_bp_cuda,
    multi_circulant_bp_plain,
    multi_circulant_ptxas,
)

pytestmark = pytest.mark.cuda
METHODS = ["product_sum", "min_sum"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def masked_frames(n, w, p, b, zeros, seed, weight=10):
    """b frames of the masked decode's inputs for P circulants of weight w
    (shared by the frames), each frame its own secret y of ``weight``: in
    every block the rows where y times the circulant's row is 1 and
    ``zeros`` rows where it is 0 are measured, certainties 0.9942 and 1.0 in
    turn (identity prior LLRs as ``build_masked_arrays`` makes them), the
    first two 0.9942 rows of a block flipped; the other rows inert."""
    shifts = np.array([np.flatnonzero(random_circulant_first_row(n, w, seed + q)) for q in range(p)], np.int32)
    prior_c, prior_i, syn = [], [], []
    for f in range(b):
        rng = np.random.RandomState(1000 * seed + f)
        y = sorted(int(v) for v in rng.choice(n, weight, replace=False))
        pi, sy = np.zeros((p, n), np.float32), np.zeros((p, n), np.int32)
        for q in range(p):
            ones = np.zeros(n, bool)
            ones[sparse_times_sparse(y, [int(k) for k in shifts[q]], n)] = True
            rows = np.concatenate([np.flatnonzero(ones), rng.choice(np.flatnonzero(~ones), zeros, replace=False)])
            rng.shuffle(rows)
            p_err = np.where(np.arange(rows.size) % 2, 1e-9, 1.0 - 0.9942)
            pi[q, rows] = np.log((1.0 - p_err) / p_err)
            sy[q, rows] = ones[rows]
            sy[q, rows[0:4:2]] ^= 1
        prior_c.append(np.full(n, np.log((1.0 - weight / n) / (weight / n)), np.float32))
        prior_i.append(pi)
        syn.append(sy)
    return np.stack(prior_c), np.stack(prior_i), np.stack(syn), shifts


def _to(arrays, device):
    prior_c, prior_i, syn, shifts = arrays
    return (torch.from_numpy(prior_c).to(device), torch.from_numpy(prior_i).to(device),
            torch.from_numpy(syn.astype(np.uint8)).to(device), torch.from_numpy(shifts).to(device))


def _check_equal(out_k, out_p):
    """conv and the iteration counts equal on every frame, and the decisions
    too: the kernel sums in the plain version's order, so even a frame that
    runs all its iterations without converging gives the same bits."""
    e_c, e_i, conv, it = out_k
    e_cp, e_ip, convp, itp = out_p
    assert torch.equal(conv, convp)
    assert torch.equal(it, itp), (conv, it, itp)
    diff_c = (e_c != e_cp).sum(dim=-1)
    diff_i = (e_i != e_ip).flatten(1).sum(dim=-1)
    assert int(diff_c.sum() + diff_i.sum()) == 0, (conv, diff_c, diff_i)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("p,b", [(1, 1), (1, 16), (3, 1), (3, 16), (8, 1), (8, 16)])
def test_kernel_matches_plain(cuda, p, b, method):
    n, w = 1021, 20
    args = _to(masked_frames(n, w, p, b, 300, seed=p), cuda)
    before = multi_circulant_bp_cuda.launches
    out_k = multi_circulant_bp_cuda(*args, 100, method)
    out_p = multi_circulant_bp_plain(*args, 100, method)
    torch.cuda.synchronize()
    assert multi_circulant_bp_cuda.launches == before + 1
    _check_equal(out_k, out_p)
    if method == "product_sum":
        assert bool(out_k[2].all())  # enough measured rows: every frame recovers


@pytest.mark.parametrize("max_iter", [1, 3, 5, 100])
def test_unconverged_frames_and_the_exit_test(cuda, max_iter):
    """Few measured rows: frames run all their iterations beside frames that
    converge.  The kernel reads how many frames still run only every few
    iterations and stops at 0; these max_iter end the decode before the first
    read, between two and on one.  A batch whose frames all converge (the
    second) exits at a read point after its last frame converged, yet the
    outputs of both batches are the plain version's, which tests every
    iteration."""
    n, w = 1021, 20
    few = masked_frames(n, w, 1, 4, 50, seed=7)
    many = masked_frames(n, w, 1, 4, 400, seed=7)
    args = _to([np.concatenate([a, c]) for a, c in zip(few[:3], many[:3])] + [few[3]], cuda)
    out_k = multi_circulant_bp_cuda(*args, max_iter)
    _check_equal(out_k, multi_circulant_bp_plain(*args, max_iter))
    assert not bool(out_k[2][:4].any()) and int(out_k[3][:4].min()) == max_iter
    args = _to(many, cuda)
    out_k = multi_circulant_bp_cuda(*args, max_iter)
    _check_equal(out_k, multi_circulant_bp_plain(*args, max_iter))
    if max_iter == 100:
        assert bool(out_k[2].all())


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("b", [1, 16])
def test_one_block_equals_k2(cuda, b, method):
    n, w = 1021, 20
    prior_c, prior_i, syn, shifts = _to(masked_frames(n, w, 1, b, 400, seed=11), cuda)
    e_c, e_i, conv, it = multi_circulant_bp_cuda(prior_c, prior_i, syn, shifts, 100, method)
    e2, conv2, it2 = circulant_bp_cuda(prior_c, prior_i[:, 0].contiguous(), syn[:, 0].contiguous(),
                                       shifts[0].tolist(), 100, method)
    either = conv | conv2
    assert torch.equal(conv, conv2)
    same = (torch.cat([e_c, e_i[:, 0]], dim=-1) == e2).all(dim=-1) & (it == it2)
    assert bool(same[either].all())


@pytest.mark.parametrize("max_iter", [0, 1])
def test_zero_and_one_iteration(cuda, max_iter):
    args = _to(masked_frames(509, 8, 2, 3, 100, seed=3, weight=6), cuda)
    out_k = multi_circulant_bp_cuda(*args, max_iter)
    out_p = multi_circulant_bp_plain(*args, max_iter)
    for a, r in zip(out_k, out_p):
        assert torch.equal(a, r)


def test_launch_shape_and_registers(cuda):
    blocks = multi_circulant_blocks(1, 1, 17669)
    assert blocks["check"] > 1 and blocks["variable"] > 1  # one frame spread over many blocks
    assert blocks["check"] == blocks["variable"] == -(-17669 // blocks["threads"])
    rep = multi_circulant_ptxas()
    assert {k[0] for k in rep} == {"init", "check", "var", "syndrome", "status", "final"}
    assert all(spill == 0 for _regs, spill in rep.values())


def test_rejects_unsupported_inputs(cuda):
    args = list(_to(masked_frames(509, 8, 2, 2, 50, seed=3, weight=6), cuda))
    with pytest.raises(ValueError):
        multi_circulant_bp_cuda(args[0], args[1], args[2].cpu(), args[3], 5)
    with pytest.raises(ValueError):
        multi_circulant_bp_cuda(*args, -1)
    with pytest.raises(ValueError):
        multi_circulant_bp_cuda(args[0], args[1][:, :, ::2], args[2], args[3], 5)
