"""FER traffic: the frame-error-rate step of the port, called back to back.

Each step of the window is one call of the port's public entry named by the
mix (``fer_simulation``, or ``sharded_fer_simulation`` over the ranks of a
several-chip cell) on ``batch`` frames of the configuration's ``[circulant |
I]`` code at one error rate; the steps take the mix's ``error_rates`` in turn,
as a FER sweep does.  Error bits are drawn on the device from a generator the
benchmark seeds with ``--seed``, their syndromes decoded by product-sum BP
(``max_iter``, ``backend``), each frame compared with the bits sent.  Every
step ends with its count of decoded frames on the host.

The counts: ``attempted`` is the frames the window's steps asked the entry for
(``batch`` a step: the cell's global batch over several ranks), and ``failed``
those it gave no usable answer for: a step's missing frames when it says it ran
fewer than ``batch``, and all of its frames when its frame count is not an
integer in ``[0, batch]`` or its success count not one in ``[0, frames]``.  A
frame decoded to other bits than were sent is an answer: the sweep's
frame-error rate, which the reference gives on the same bits
(``fer.frame_gap``).  That rate is printed for each error rate on standard
error and kept on the run, and is not a count of failures.

Correctness: the generator's state before each step is kept.  After the
window, ``check_steps[r]`` steps at the ``r``-th rate, drawn from the seed, are
drawn again from those states as the port's step draws them (uniforms on the
device, ``< rate``; so the check depends on the port's draw), and their error
bits go through the kernel that the backend names in the port's step, which
gives each frame's success and convergence:

- ``fer.count_gap``: |the step's count in the window - the frames these
  per-frame answers count as decoded|, summed over the steps;
- ``fer.frame_gap``: frames whose success or convergence differs from the
  reference's (``benchmark/reference/bp.py``) on the same bits, over
  ``check_frames[r]`` frames of each such step drawn from the seed.

The reference's iteration counts give the work the frames need, which the
roofline reader takes.

Parameters (the mix's keys): ``entry``, ``batch``, ``error_rates``,
``max_iter``, ``method``, ``backend``, ``check_steps`` and ``check_frames``
(one count a rate), ``reference_block`` (frames the reference decodes at a
time) and ``limits`` {check: limit}.
"""

import datetime
import gc
import numbers
import sys
import time
from types import SimpleNamespace

import numpy as np

from .. import codegen
from ..common import check, pick
from ..reference.bp import fer_decode
from ..trace import Tracer


class _Group:
    """This rank's view of the cell's ranks: a host-side (gloo) group for the
    benchmark's own agreement, so that its messages stay off the card."""

    def __init__(self, ctx):
        self.world = ctx.world
        if self.world == 1:
            return
        import torch.distributed as dist

        self.dist = dist
        self.gloo = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=300))

    def any(self, flag):
        if self.world == 1:
            return bool(flag)
        import torch

        t = torch.tensor([int(bool(flag))])
        self.dist.all_reduce(t, self.dist.ReduceOp.MAX, group=self.gloo)
        return bool(t.item())

    def sum(self, values):
        if self.world == 1:
            return list(values)
        import torch

        t = torch.tensor(list(values), dtype=torch.float64)
        self.dist.all_reduce(t, group=self.gloo)
        return t.tolist()

    def gather(self, obj):
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        self.dist.all_gather_object(out, obj, group=self.gloo)
        return out

    def barrier(self):
        if self.world > 1:
            self.dist.barrier(group=self.gloo)


def _scalar(x):
    """A count as the entry gave it, as a Python number."""
    return x.item() if hasattr(x, "item") else x


def _usable(value, high):
    """Whether ``value`` is an integer in ``[0, high]``."""
    return isinstance(value, numbers.Real) and float(value).is_integer() and 0 <= value <= high


def _unanswered(ok, frames, batch):
    """The frames of one step of ``batch`` that the entry gave no usable
    answer for (it said it ran ``frames``, ``ok`` of them decoded)."""
    if not _usable(frames, batch) or not _usable(ok, frames):
        return batch
    return batch - int(frames)


def run(ctx):
    import torch

    from sca_ldpc_tpu_torch import parallel
    from sca_ldpc_tpu_torch.codes import CirculantLayout
    from sca_ldpc_tpu_torch.parallel.fer import _KERNELS as fer_kernels

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    row = codegen.first_row(cfg["n"], cfg["code_weight"], cfg["first_row_seed"])
    shifts = [int(k) for k in np.flatnonzero(row)]
    layout = CirculantLayout.from_first_row(row, with_identity=True)
    rates = [np.float32(r) for r in tr["error_rates"]]
    probs = [np.full(layout.n_vars, r, np.float32) for r in rates]
    batch, max_iter, method, backend = int(tr["batch"]), int(tr["max_iter"]), tr["method"], tr["backend"]
    cuda = dev.type == "cuda"

    mesh = None
    if ctx.world > 1:
        parallel.init_distributed(f"file://{ctx.rendezvous}", ctx.world, ctx.rank, device=str(dev))
        mesh = parallel.make_mesh(device=dev)
    group = _Group(ctx)

    entry = getattr(parallel, tr["entry"])

    def step(gen, i):
        where = dev if mesh is None else mesh
        return entry(layout, probs[i % len(rates)], batch, gen, where, batch=batch, max_iter=max_iter, method=method,
                     backend=backend)

    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed % (1 << 63))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(len(rates)):  # each rate once: builds and loads the kernel in a new checkout
        step(gen, i)
    if cuda:
        torch.cuda.synchronize(dev)
    group.barrier()

    states, counts = [], []
    tracer = Tracer(ctx.trace)
    with tracer:
        ctx.start_window()
        t0 = time.perf_counter()
        while True:
            states.append(gen.get_state())
            with tracer.span("bench.step"):
                ok, frames = step(gen, len(counts))
            counts.append((_scalar(ok), _scalar(frames)))
            if group.any(time.perf_counter() - t0 >= ctx.seconds):
                break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = tracer.summary()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # each frame of a sample of the window's steps: the step's kernel and the reference on the same bits
    t_ref = time.perf_counter()
    kernel = fer_kernels[backend]
    rows = mesh.rows(batch) if mesh is not None else slice(None)
    count_gap, frame_gap, checked, later_iters = 0, 0, 0, 0.0
    for r, (rate, k_steps, k_frames) in enumerate(zip(rates, tr["check_steps"], tr["check_frames"])):
        n_r = it_r = 0
        for i in pick(ctx.seed, range(r, len(states), len(rates)), int(k_steps), salt=1 + r):
            g = torch.Generator(device=dev)
            g.set_state(states[i])
            errors = (torch.rand((batch, layout.n_vars), generator=g, device=dev) < rate)[rows].to(torch.uint8)
            ok, conv = kernel(errors, layout.shifts, float(rate), max_iter, method)
            frames = torch.as_tensor(pick(ctx.seed + i, range(errors.shape[0]), int(k_frames), salt=101 + r),
                                     device=dev)
            ok_ref, conv_ref, iters = fer_decode(errors[frames], shifts, float(rate), max_iter,
                                                 block=tr["reference_block"])
            differ = (ok[frames].bool() != ok_ref) | (conv[frames].bool() != conv_ref)
            ok_all, n_differ, n_iters, n = group.sum([int(ok.sum()), int(differ.sum()), int(iters.sum()),
                                                      len(ok_ref)])
            count_gap += abs(counts[i][0] - int(ok_all))
            frame_gap += int(n_differ)
            n_r, it_r = n_r + int(n), it_r + int(n_iters)
            del errors, ok, conv, ok_ref, conv_ref, iters
        if n_r:  # the window's frames at this rate times the iterations after the first that a frame needs
            later_iters += sum(f for _ok, f in counts[r::len(rates)]) * (it_r / n_r - 1.0)
        checked += n_r
    ref_s = time.perf_counter() - t_ref

    traces = group.gather(summary) if ctx.trace else None
    peak = int(max(group.gather(int(peak))))
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    if ctx.rank != 0:
        return None

    frames = sum(f for _ok, f in counts)
    successes = sum(ok for ok, _f in counts)
    failed = sum(_unanswered(ok, f, batch) for ok, f in counts)
    # the sweep's frame-error rate: the share of frames not decoded, over the steps whose counts are usable
    tallies = [[(f - ok, f) for ok, f in counts[r::len(rates)] if _unanswered(ok, f, batch) < batch]
               for r in range(len(rates))]
    tallies = [(sum(u for u, _f in t), sum(f for _u, f in t)) for t in tallies]
    undecoded = {rate: u / n for rate, (u, n) in zip(tr["error_rates"], tallies) if n}
    undecoded_share = sum(u for u, _n in tallies) / max(sum(n for _u, n in tallies), 1)
    limits = tr["limits"]
    print(f"fer: {len(counts)} steps, {frames} frames, {successes} decoded in {window_s:.3f} s; reference on "
          f"{checked} frames in {ref_s:.3f} s, {later_iters / max(frames, 1):.4f} iterations a frame after the first",
          file=sys.stderr)
    print(f"fer: frames not decoded (the sweep's FER, not failures): {100 * undecoded_share:.3f}%; by rate "
          + ", ".join(f"{rate:g} {100 * share:.3f}%" for rate, share in undecoded.items())
          + f"; {failed} of {len(counts) * batch} frames asked for not answered", file=sys.stderr)
    run_data = SimpleNamespace(
        kind="fer", window_s=summary["window_s"] if summary else window_s, traces=traces,
        frames=frames, steps=len(counts), world=ctx.world, config=ctx.config, traffic=tr,
        later_iterations=later_iters, undecoded=undecoded, undecoded_share=undecoded_share,
    )
    return {
        "end_to_end": {"frames_per_s": frames / window_s, "setup_s": ctx.setup_s},
        "attempted": len(counts) * batch,
        "failed": failed,
        "memory_peak_bytes": peak,
        "checks": {"fer.count_gap": check(count_gap, limits["fer.count_gap"]),
                   "fer.frame_gap": check(frame_gap, limits["fer.frame_gap"])},
        "run": run_data,
    }
