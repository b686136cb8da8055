"""The FER step's iteration counter on the card: K1 and K4 write each frame's
iterations through ``iters_out`` while the step records, and the counted sum
equals the plain versions' on the same bits; counting a device sum makes the
host wait for nothing.  Without a CUDA device every test skips.  This file
imports no JAX:

    python -m pytest --noconftest tests/test_torch_cuda_spans.py
"""

import numpy as np
import pytest
import torch

from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops.circulant_bp import _circulant_bp_frames
from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
    _syndrome_and_prior,
    circulant_bp_lean_plain,
    circulant_fer_cuda,
    circulant_fer_lean_cuda,
    circulant_staged,
)
from sca_ldpc_tpu_torch.parallel.fer import fer_simulation
from sca_ldpc_tpu_torch.utils import spans

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spans.reset()
    yield torch.device("cuda:0")
    spans.reset()


@pytest.mark.parametrize("backend", ["fused", "lean"])
def test_counted_iterations_equal_the_plain_versions(cuda, backend):
    """512 HQC-128-sized frames at rate 0.05, in the waterfall: some frames
    converge early, some run all 30 iterations."""
    lay = CirculantLayout.from_first_row(random_circulant_first_row(17669, 20, 0), with_identity=True)
    rate, frames, max_iter = np.float32(0.05), 512, 30
    probs = np.full(lay.n_vars, rate, np.float32)
    kernel = {"fused": circulant_fer_cuda, "lean": circulant_fer_lean_cuda}[backend]
    launches = kernel.launches
    with spans.collect():
        fer_simulation(lay, probs, frames, torch.Generator(device=cuda).manual_seed(7), cuda, batch=frames,
                       max_iter=max_iter, backend=backend)
    counted = spans.snapshot()["counters"]
    assert kernel.launches == launches + 1

    g = torch.Generator(device=cuda).manual_seed(7)
    errors = (torch.rand((frames, lay.n_vars), generator=g, device=cuda) < rate).to(torch.uint8)
    syn, prior = _syndrome_and_prior(errors, lay.shifts, float(rate))
    if backend == "fused":
        _e, _conv, plain = _circulant_bp_frames(prior, prior, syn, tuple(lay.shifts), True, max_iter, "product_sum")
    else:
        _e, _conv, plain = circulant_bp_lean_plain(prior, prior, syn, lay.shifts, max_iter)
    iters = torch.full((frames,), -1, dtype=torch.int32, device=cuda)
    kernel(errors, lay.shifts, float(rate), max_iter, iters_out=iters)
    assert torch.equal(iters, plain.to(torch.int32))
    assert 1 <= int(plain.min()) < int(plain.max()) == max_iter
    # "fused" counts the frames K1 ran staged: all of them where the card stages HQC-128 (an H100 does)
    staged = {"fer.k1_staged_frames": frames * circulant_staged(lay.n, 20, cuda)} if backend == "fused" else {}
    assert counted == {"fer.frames": frames, "fer.frame_iterations": int(plain.sum()), **staged}


def test_counting_a_device_sum_does_not_sync(cuda):
    x = torch.arange(8, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    with spans.collect():
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                spans.count("t.n", x.sum())
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert spans.snapshot()["counters"] == {"t.n": 84}
