"""Frame-error-rate simulation on one device.

One step: error sampling on the device from a ``torch.Generator`` -> syndrome
-> batched BP decode -> frame-exact comparison, for a ``[circulant | I]``
code at a uniform error rate.  On a CUDA device the step is one kernel launch
(syndrome, decode and comparison): ``backend="fused"``, the default, runs
:func:`~sca_ldpc_tpu_torch.ops.kernels.circulant_cuda.circulant_fer_cuda`
(K1, f32 messages; the JAX package's ``pallas`` branch) and
``backend="lean"`` runs
:func:`~sca_ldpc_tpu_torch.ops.kernels.circulant_cuda.circulant_fer_lean_cuda`
(K4, bf16 message planes, product-sum only; ``bench.py``'s ``lean``).  On
the CPU each backend runs its kernel's plain version.  No host->device
transfer scales with the batch.
"""

import numpy as np
import torch

from ..codes.layout import CirculantLayout
from ..ops.kernels.circulant_cuda import circulant_fer_cuda, circulant_fer_lean_cuda

BACKENDS = {"fused": circulant_fer_cuda, "lean": circulant_fer_lean_cuda}


def make_fer_step(layout, channel_probs, device, max_iter=50, method="product_sum", backend="fused"):
    """Build a step: (generator, batch) -> (successes, converged, iters), as
    the JAX package's FER step returns them: ``successes`` and ``converged``
    are 0-d int64 tensors on ``device``; ``iters`` is a 0-d int32 tensor of
    -1 on ``device`` for both backends, which are the counterparts of the JAX
    step's kernel branch (it reports no iteration count either).

    ``layout``: a ``[circulant | I]`` :class:`CirculantLayout`.
    ``channel_probs``: [n_vars] error probabilities, all equal.  ``generator``
    must live on ``device``.  ``backend``: ``"fused"`` or ``"lean"`` (see the
    module docstring).
    """
    if not isinstance(layout, CirculantLayout) or not layout.with_identity:
        raise ValueError("the FER step requires a [circulant | I] layout")
    if backend not in BACKENDS:
        raise ValueError(f"unknown FER backend {backend!r}; expected one of {sorted(BACKENDS)}")
    probs = np.asarray(channel_probs, np.float32).ravel()
    err = float(probs[0])
    if probs.shape != (layout.n_vars,) or not np.allclose(probs, err):
        raise ValueError("the FER step supports one uniform error rate over all variables")
    device = torch.device(device)
    shifts = layout.shifts
    n_vars = layout.n_vars
    fer_kernel = BACKENDS[backend]

    def step(generator, batch):
        u = torch.rand((batch, n_vars), generator=generator, device=device)
        errors = (u < err).to(torch.uint8)
        ok, conv = fer_kernel(errors, shifts, err, max_iter, method)
        return ok.sum(), conv.sum(), torch.full((), -1, dtype=torch.int32, device=device)

    return step


def fer_simulation(layout, channel_probs, runs, generator, device, batch=None, max_iter=50,
                   method="product_sum", backend="fused"):
    """Run ``runs`` frames in batches of at most ``batch``; returns
    (successes, frames)."""
    if batch is None:
        batch = min(max(runs, 1), 256)
    batch = max(1, int(batch))
    step = make_fer_step(layout, channel_probs, device, max_iter, method, backend)
    successes = 0
    done = 0
    while done < runs:
        cur = min(batch, runs - done)
        ok, _conv, _iters = step(generator, cur)
        successes += int(ok)
        done += cur
    return successes, done
