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
    syn = (err.astype(np.int64) @ lay.to_dense().T) % 2
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
