"""Frame-error-rate simulation, on one device or sharded over a mesh.

One step: error sampling on the device from a ``torch.Generator`` -> syndrome
-> batched BP decode -> frame-exact comparison.  ``backend`` names how the
decode runs (the JAX package's name in brackets):

- ``"fused"`` (``"pallas"``), the default of the single-device step: one
  kernel launch does syndrome, decode and comparison,
  :func:`~sca_ldpc_tpu_torch.ops.kernels.circulant_cuda.circulant_fer_cuda`
  (K1, f32 messages), on a ``[circulant | I]`` code at one uniform error rate;
- ``"lean"`` (``bench.py``'s ``lean``): the same through
  :func:`~sca_ldpc_tpu_torch.ops.kernels.circulant_cuda.circulant_fer_lean_cuda`
  (K4, bf16 message planes, product-sum only);
- ``"decode"`` (``"xla"``), the default of the sharded step: the syndromes
  are computed here and decoded by the decoder API, so any code and
  per-variable error rates: a :class:`CirculantLayout` with or without the
  identity block through :class:`~sca_ldpc_tpu_torch.ops.circulant_bp.CirculantBPDecoder`
  (K2 on a CUDA device), a general :class:`CodeLayout` through
  ``_bp_decode_syndrome`` (plain PyTorch); it reports the batch's
  iteration count.

On the CPU each kernel backend runs its kernel's plain version.  No
host->device transfer scales with the batch.

Spans and counters (``utils/spans.py``; recorded only while something reads
them): ``fer.simulation`` around one :func:`fer_simulation` or
:func:`sharded_fer_simulation` call, inside it ``fer.sample`` (the uniforms,
``< p`` and the cast), ``fer.decode`` (the decode: for the kernel backends the
wrapper's shifts, scratch and launch), ``fer.reduce`` (the counts' sums, and
their exchange over the ranks) and ``fer.count`` (the count on the host, which
waits for the device).  The kernel backends count ``fer.frames`` and
``fer.frame_iterations``: while recording they hand the kernel a [B] buffer
for each frame's iterations and count its sum on the device; otherwise the
launch is the one without it.  ``"fused"`` also counts ``fer.k1_staged_frames``,
the frames K1 decoded in its staged form (0 where its launch configuration,
:func:`~sca_ldpc_tpu_torch.ops.kernels.circulant_cuda.circulant_launch`, does
not stage the planes, and on the CPU).  ``"decode"`` counts nothing.

The sharded step splits the batch over the mesh's ranks.  Every rank draws
the whole ``[batch, n_vars]`` uniform tensor from its generator (seeded alike
on every rank) and keeps its own rows, so the frames do not depend on the
number of ranks: a W-rank run equals the 1-rank run count for count, and the
1-rank run equals :func:`fer_simulation` with the same batch.  The counts are
summed over the ranks and the iteration count is their largest.
"""

import numpy as np
import torch

from ..codes.layout import CirculantLayout
from ..ops.binary_bp import _bp_decode_syndrome
from ..ops.circulant_bp import CirculantBPDecoder
from ..ops.kernels.circulant_cuda import circulant_fer_cuda, circulant_fer_lean_cuda, circulant_staged
from ..sim.fer import _syndromes
from ..utils import spans

_KERNELS = {"fused": circulant_fer_cuda, "lean": circulant_fer_lean_cuda}
BACKENDS = (*_KERNELS, "decode")


def _decoder(layout, probs, device, max_iter, method):
    """``decode(errors [B, n_vars] int32) -> (e_hat, conv, it)`` of the
    ``"decode"`` backend: the errors' syndromes decoded under ``probs``."""
    p = torch.as_tensor(probs, device=device)
    if isinstance(layout, CirculantLayout):
        dec = CirculantBPDecoder(layout, max_iter, method, device)
        n = layout.n

        def decode(errors):
            syn = sum(torch.roll(errors[:, :n], k, dims=-1) for k in layout.shifts)
            if layout.with_identity:
                syn = syn + errors[:, n:]
            return dec.decode_syndrome(syn % 2, p, return_aux=True)

        return decode

    args = [torch.as_tensor(a, device=device) for a in (layout.chk_var, layout.chk_mask, layout.var_flat,
                                                        layout.var_mask)]
    chk_idx = args[0].long()
    clipped = torch.clamp(p, 1e-30, 1 - 1e-12)  # as the JAX step
    prior = torch.log((1.0 - clipped) / clipped)

    def decode(errors):
        syn = _syndromes(layout, errors, chk_idx, args[1])
        e_hat, conv, it = _bp_decode_syndrome(*args, prior, syn, max_iter, method, layout.dc)
        return e_hat, conv, it.to(device)

    return decode


def make_fer_step(layout, channel_probs, device, max_iter=50, method="product_sum", backend="fused"):
    """Build a step: ``(generator, batch, rows=None) -> (successes,
    converged, iters)``, as the JAX package's FER step returns them, each a
    0-d tensor on ``device`` (int64 counts; ``iters`` int32, -1 for the
    kernel backends, which report no iteration count, as the JAX step's
    kernel branch).  ``rows``: a slice of the batch to decode (a rank's rows
    in the sharded step); the whole batch is drawn either way.

    ``layout``: a ``[circulant | I]`` :class:`CirculantLayout` for ``"fused"``
    and ``"lean"``, any layout for ``"decode"``.  ``channel_probs``: [n_vars]
    error probabilities, all equal for the kernel backends.  ``generator``
    must live on ``device``.  ``backend``: one of :data:`BACKENDS` (module
    docstring).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown FER backend {backend!r}; expected one of {sorted(BACKENDS)}")
    device = torch.device(device)
    probs = np.asarray(channel_probs, np.float32).ravel()
    n_vars = layout.n_vars if isinstance(layout, CirculantLayout) else layout.n
    if probs.shape != (n_vars,):
        raise ValueError(f"channel_probs has {probs.size} entries for {n_vars} variables")
    if backend == "decode":
        p = torch.as_tensor(probs, device=device)
        decode = _decoder(layout, p, device, max_iter, method)

        def sample(u):
            return (u < p).to(torch.int32)

        def run(errors):
            with spans.span("fer.decode"):
                e_hat, conv, it = decode(errors)
            with spans.span("fer.reduce"):
                return torch.all(e_hat == errors, dim=-1).sum(), conv.sum(), it
    else:
        if not isinstance(layout, CirculantLayout) or not layout.with_identity:
            raise ValueError(f"FER backend {backend!r} requires a [circulant | I] layout")
        err = float(probs[0])
        if not np.allclose(probs, err):
            raise ValueError(f"FER backend {backend!r} supports one uniform error rate over all variables")
        fer_kernel = _KERNELS[backend]
        staged = backend == "fused" and circulant_staged(layout.n, len(layout.shifts), device)

        def sample(u):
            return (u < err).to(torch.uint8)

        def run(errors):
            with spans.span("fer.decode"):
                if spans.recording():
                    iters = torch.empty((errors.shape[0],), dtype=torch.int32, device=device)
                    ok, conv = fer_kernel(errors, layout.shifts, err, max_iter, method, iters_out=iters)
                    spans.count("fer.frames", errors.shape[0])
                    spans.count("fer.frame_iterations", iters.sum())
                    if backend == "fused":
                        spans.count("fer.k1_staged_frames", errors.shape[0] if staged else 0)
                else:
                    ok, conv = fer_kernel(errors, layout.shifts, err, max_iter, method)
            with spans.span("fer.reduce"):
                return ok.sum(), conv.sum(), torch.full((), -1, dtype=torch.int32, device=device)

    def step(generator, batch, rows=None):
        with spans.span("fer.sample"):
            u = torch.rand((batch, n_vars), generator=generator, device=device)
            errors = sample(u if rows is None else u[rows])
        return run(errors)

    return step


def fer_simulation(layout, channel_probs, runs, generator, device, batch=None, max_iter=50,
                   method="product_sum", backend="fused"):
    """Run ``runs`` frames in batches of at most ``batch``; returns
    (successes, frames)."""
    with spans.span("fer.simulation"):
        if batch is None:
            batch = min(max(runs, 1), 256)
        batch = max(1, int(batch))
        step = make_fer_step(layout, channel_probs, device, max_iter, method, backend)
        successes = 0
        done = 0
        while done < runs:
            cur = min(batch, runs - done)
            ok, _conv, _iters = step(generator, cur)
            with spans.span("fer.count"):
                successes += int(ok)
            done += cur
        return successes, done


def _granularity(backend, ranks):
    """The JAX package's batch granule: 8 frames a device for its kernel
    branch, one otherwise."""
    return 8 * ranks if backend in _KERNELS else ranks


def make_sharded_fer_step(layout, channel_probs, mesh, max_iter=50, method="product_sum", backend="decode"):
    """Build the sharded step: ``(generator, batch) -> (successes,
    converged, iters)`` reduced over ``mesh`` (sums; ``iters`` the largest),
    each a 0-d tensor on the mesh's device, which is where this rank
    decodes.  ``batch`` must be a multiple of the mesh's size (eight times
    it for the kernel backends).  Arguments as :func:`make_fer_step`.
    """
    local = make_fer_step(layout, channel_probs, mesh.device, max_iter, method, backend)
    gran = _granularity(backend, mesh.size)

    def step(generator, batch):
        if batch % gran:
            raise ValueError(f"batch {batch} is not a multiple of {gran} (backend {backend!r}, {mesh.size} ranks)")
        ok, conv, it = local(generator, batch, mesh.rows(batch))
        with spans.span("fer.reduce"):
            counts = mesh.all_reduce(torch.stack([ok, conv]), "sum")
            return counts[0], counts[1], mesh.all_reduce(it, "max")

    return step


def sharded_fer_simulation(layout, channel_probs, runs, generator, mesh, batch=None, max_iter=50,
                           method="product_sum", backend="decode"):
    """Run ``runs`` frames in sharded batches; returns (successes, frames).
    The JAX package's batch arithmetic: ``batch`` defaults to
    ``min(max(runs, g), 256 * ranks)`` and every batch is rounded down to a
    multiple of the granule ``g`` (at least one), so ``frames`` may exceed
    ``runs``.  ``generator``: on the mesh's device, seeded alike on every
    rank."""
    with spans.span("fer.simulation"):
        gran = _granularity(backend, mesh.size)
        if batch is None:
            batch = min(max(runs, gran), 256 * mesh.size)
        batch = max(gran, (batch // gran) * gran)
        step = make_sharded_fer_step(layout, channel_probs, mesh, max_iter, method, backend)
        successes = 0
        done = 0
        while done < runs:
            cur = min(batch, max(gran, runs - done))
            cur = max(gran, (cur // gran) * gran)
            ok, _conv, _it = step(generator, cur)
            with spans.span("fer.count"):
                successes += int(ok)
            done += cur
        return successes, done
