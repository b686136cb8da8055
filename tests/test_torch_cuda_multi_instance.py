"""The CUDA kernel K8 with per-frame shifts ``[B, P, W]`` (the batched HQC
attack's round: one launch decodes every instance, each with its own
circulants) against its plain PyTorch version and against one ``[P, W]``
launch an instance, on the card.  Without a CUDA device every test skips.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda_multi_instance.py
"""

import numpy as np
import pytest
import torch

from sca_ldpc_tpu_torch.codes import random_circulant_first_row
from sca_ldpc_tpu_torch.models.hqc import sparse_times_sparse
from sca_ldpc_tpu_torch.ops.kernels import circulant_cuda
from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
    multi_circulant_bp_cuda,
    multi_circulant_bp_plain,
    multi_circulant_occupancy,
    multi_circulant_stage,
)

pytestmark = pytest.mark.cuda
METHODS = ["product_sum", "min_sum"]
N, W = 1021, 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _first_row_support(seed):
    """A random circulant's support: the first of seeds ``seed``, ``seed +
    1000``, ... whose greedy draw reaches weight W at size N."""
    while True:
        try:
            return np.flatnonzero(random_circulant_first_row(N, W, seed))
        except RuntimeError:  # the draw stalled below weight W
            seed += 1000


def instance_frames(blocks, p_pad, zeros, seed, weight=10):
    """One frame an instance, instance f with ``blocks[f]`` circulants of its
    own (seeds apart from every other instance's) and its own secret y of
    ``weight``, padded to ``p_pad`` blocks as the batched round pads them
    (all-inert rows, shifts 0).  In each real block the rows where y times
    the circulant's row is 1 and ``zeros`` rows where it is 0 are measured,
    certainties 0.9942 and 1.0 in turn, the first two 0.9942 rows flipped.
    Returns numpy (prior_c [I, N], prior_i [I, P_pad, N], syn, shifts
    [I, P_pad, W])."""
    prior_c, prior_i, syn, shifts = [], [], [], []
    for f, p in enumerate(blocks):
        rng = np.random.RandomState(1000 * seed + f)
        k = np.zeros((p_pad, W), np.int32)
        k[:p] = [_first_row_support(100 * seed + 10 * f + q) for q in range(p)]
        y = sorted(int(v) for v in rng.choice(N, weight, replace=False))
        pi, sy = np.zeros((p_pad, N), np.float32), np.zeros((p_pad, N), np.int32)
        for q in range(p):
            ones = np.zeros(N, bool)
            ones[sparse_times_sparse(y, [int(s) for s in k[q]], N)] = True
            rows = np.concatenate([np.flatnonzero(ones), rng.choice(np.flatnonzero(~ones), zeros, replace=False)])
            rng.shuffle(rows)
            p_err = np.where(np.arange(rows.size) % 2, 1e-9, 1.0 - 0.9942)
            pi[q, rows] = np.log((1.0 - p_err) / p_err)
            sy[q, rows] = ones[rows]
            sy[q, rows[0:4:2]] ^= 1
        prior_c.append(np.full(N, np.log((1.0 - weight / N) / (weight / N)), np.float32))
        prior_i.append(pi)
        syn.append(sy)
        shifts.append(k)
    return np.stack(prior_c), np.stack(prior_i), np.stack(syn), np.stack(shifts)


def _to(arrays, device):
    prior_c, prior_i, syn, shifts = arrays
    return (torch.from_numpy(prior_c).to(device), torch.from_numpy(prior_i).to(device),
            torch.from_numpy(syn.astype(np.uint8)).to(device), torch.from_numpy(shifts).to(device))


def _check_equal(out_a, out_b):
    """Decisions, conv and iteration counts equal on every frame."""
    for x, y in zip(out_a, out_b):
        assert x.shape == y.shape and torch.equal(x, y), (out_a[2], out_a[3], out_b[2], out_b[3])


def _force(monkeypatch, grid=None, stage=None):
    """Have the wrapper launch ``grid`` blocks and stage the per-frame
    shifts as ``stage`` in place of its own choices."""
    if grid is not None:
        pick = circulant_cuda.multi_circulant_launch
        monkeypatch.setattr(circulant_cuda, "multi_circulant_launch", lambda *a: pick(*a)._replace(grid=grid))
    if stage is not None:
        monkeypatch.setattr(circulant_cuda, "multi_circulant_stage", lambda b, p, w, per_frame: stage if per_frame
                            else 0)


def _mixed():
    """Six instances with 1 to 4 blocks, padded to 4: frames that converge at
    different iterations (8, 14 and 62 on the plain version) and three that never
    do (few measured rows)."""
    a = instance_frames([1, 2, 3, 4], 4, 160, seed=7)
    b = instance_frames([2, 1], 4, 30, seed=4)
    return [np.concatenate([x, y]) for x, y in zip(a, b)]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("grid", ["1", "2", "max"])
@pytest.mark.parametrize("max_iter", [0, 1, 3, 100])
def test_instances_match_plain_and_one_launch_each(cuda, monkeypatch, max_iter, grid, stage, method):
    """One [I, P, W] launch equals the plain version (frame by frame, each
    with its own shifts) and one [P, W] launch an instance, at every exit
    point, with the grid forced to 1 block, 2 blocks and the resident
    maximum, and the shifts staged whole (stage 1) or a tile at a time
    (stage 2)."""
    arrays = _mixed()
    args = _to(arrays, cuda)
    out_p = multi_circulant_bp_plain(*args, max_iter, method)
    solo = [multi_circulant_bp_cuda(*(x[f:f + 1] for x in args[:3]), args[3][f], max_iter, method)
            for f in range(len(arrays[0]))]
    occ = multi_circulant_occupancy(W, method, 4, cuda, len(arrays[0]), stage)
    g = {"1": 1, "2": 2, "max": occ["blocks_per_sm"] * occ["sms"]}[grid]
    _force(monkeypatch, g, stage)
    before = multi_circulant_bp_cuda.launches
    out_k = multi_circulant_bp_cuda(*args, max_iter, method)
    torch.cuda.synchronize()
    assert multi_circulant_bp_cuda.launches == before + 1
    _check_equal(out_k, out_p)
    _check_equal(out_k, tuple(torch.cat(parts) for parts in zip(*solo)))
    if max_iter == 100 and method == "product_sum":
        assert len(set(out_p[3].tolist())) >= 3 and not bool(out_p[2].all())


@pytest.mark.parametrize("stage", [1, 2])
def test_padding_blocks_change_nothing(cuda, monkeypatch, stage):
    """An instance padded with all-inert blocks decodes as it does alone."""
    arrays = instance_frames([1, 3, 2], 5, 300, seed=6)
    _force(monkeypatch, stage=stage)
    out = multi_circulant_bp_cuda(*_to(arrays, cuda), 100)
    for f, p in enumerate([1, 3, 2]):
        alone = multi_circulant_bp_cuda(*_to([arrays[0][f:f + 1], arrays[1][f:f + 1, :p], arrays[2][f:f + 1, :p],
                                               arrays[3][f, :p]], cuda), 100)
        assert torch.equal(out[0][f], alone[0][0]) and torch.equal(out[1][f, :p], alone[1][0])
        assert not bool(out[1][f, p:].any())
        assert bool(out[2][f] == alone[2][0]) and bool(out[3][f] == alone[3][0])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("stage", [1, 2])
def test_equal_rows_equal_the_shared_launch(cuda, monkeypatch, stage, method):
    """[B, P, W] shifts whose rows are all one [P, W] give the [P, W]
    launch's outputs bit for bit."""
    arrays = instance_frames([3] * 5, 3, 200, seed=8)
    prior_c, prior_i, syn, shifts = _to(arrays, cuda)
    shared = shifts[0]
    out_2d = multi_circulant_bp_cuda(prior_c, prior_i, syn, shared, 100, method)
    _force(monkeypatch, stage=stage)
    out_3d = multi_circulant_bp_cuda(prior_c, prior_i, syn, shared.expand(5, -1, -1).contiguous(), 100, method)
    _check_equal(out_3d, out_2d)


def test_staging_choice_and_occupancy(cuda):
    """A round of 16 instances at P = 8, w = 20 stages all its shifts (2,561
    ints, 10 KB); a round too large to stage whole stages a tile at a time,
    and the card holds the blocks of both resident."""
    assert multi_circulant_stage(16, 8, 20, True) == 1
    assert multi_circulant_stage(16, 8, 20, False) == 0
    assert multi_circulant_stage(64, 10, 20, True) == 2
    for stage, batch in ((0, 16), (1, 16), (2, 64)):
        occ = multi_circulant_occupancy(20, "product_sum", 8 if stage < 2 else 10, cuda, batch, stage)
        assert occ["cooperative"] and occ["blocks_per_sm"] >= 2


def test_rejects_bad_per_frame_shifts(cuda):
    args = list(_to(instance_frames([2, 2], 2, 50, seed=9), cuda))
    with pytest.raises(ValueError, match="shifts must be"):
        multi_circulant_bp_cuda(*args[:3], args[3][:1], 5)  # one instance's shifts for two frames
    with pytest.raises(ValueError, match="shifts must be"):
        multi_circulant_bp_cuda(*args[:3], args[3][:, :1], 5)  # fewer blocks than the priors
