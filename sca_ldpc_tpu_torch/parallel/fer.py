"""Frame-error-rate simulation on one device.

One step: error sampling on the device from a ``torch.Generator`` -> syndrome
-> batched BP decode -> frame-exact comparison, for a ``[circulant | I]``
code at a uniform error rate.  On a CUDA device the step is the
:func:`~sca_ldpc_tpu_torch.ops.kernels.circulant_cuda.circulant_fer_cuda`
kernel (syndrome, decode and comparison in one launch); on the CPU it is the
kernel's plain version.  No host->device transfer scales with the batch.
"""

import numpy as np
import torch

from ..codes.layout import CirculantLayout
from ..ops.kernels.circulant_cuda import circulant_fer_cuda


def make_fer_step(layout, channel_probs, device, max_iter=50, method="product_sum"):
    """Build a step: (generator, batch) -> (successes, converged), both 0-d
    int64 tensors on ``device``.

    ``layout``: a ``[circulant | I]`` :class:`CirculantLayout`.
    ``channel_probs``: [n_vars] error probabilities, all equal.  ``generator``
    must live on ``device``.
    """
    if not isinstance(layout, CirculantLayout) or not layout.with_identity:
        raise ValueError("the FER step requires a [circulant | I] layout")
    probs = np.asarray(channel_probs, np.float32).ravel()
    err = float(probs[0])
    if probs.shape != (layout.n_vars,) or not np.allclose(probs, err):
        raise ValueError("the FER step supports one uniform error rate over all variables")
    device = torch.device(device)
    shifts = layout.shifts
    n_vars = layout.n_vars

    def step(generator, batch):
        u = torch.rand((batch, n_vars), generator=generator, device=device)
        errors = (u < err).to(torch.uint8)
        ok, conv = circulant_fer_cuda(errors, shifts, err, max_iter, method)
        return ok.sum(), conv.sum()

    return step


def fer_simulation(layout, channel_probs, runs, generator, device, batch=None, max_iter=50,
                   method="product_sum"):
    """Run ``runs`` frames in batches of at most ``batch``; returns
    (successes, frames)."""
    if batch is None:
        batch = min(max(runs, 1), 256)
    batch = max(1, int(batch))
    step = make_fer_step(layout, channel_probs, device, max_iter, method)
    successes = 0
    done = 0
    while done < runs:
        cur = min(batch, runs - done)
        ok, _conv = step(generator, cur)
        successes += int(ok)
        done += cur
    return successes, done
