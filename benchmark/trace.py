"""The traced run's reading of the device: ``torch.profiler`` over the window.

:class:`Tracer` profiles the CPU and the card over the measured window, which
it marks with the annotation ``bench.window``; the benchmark marks its own
spans (``bench.*``) inside it.  :func:`summarize` reduces the profiler's
events to what the metric readers and the result line take: the seconds in
which some operation ran on the device, device time by operation name, NCCL's
share, the device time inside each span, and the longest idle gaps named by
what the host was doing then.
"""

import bisect
import contextlib

WINDOW = "bench.window"
_DEVICE_KINDS = ("kernel", "memcpy", "memset")


def _kind(event):
    try:
        return str(event.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


class Tracer:
    """``with Tracer(on): ...`` profiles the block when ``on``; ``summary()``
    then reduces the trace (None when off)."""

    def __init__(self, enabled):
        self.enabled = bool(enabled)
        self.prof = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile, record_function

            import torch

            self.prof = self._stack.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            if torch.cuda.is_available():  # the profiler's first device activity before the window
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
            self._stack.enter_context(record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def span(self, name):
        """A named span of the benchmark's own (no-op when tracing is off)."""
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def summary(self):
        if self.prof is None:
            return None
        return summarize(self.prof.profiler.kineto_results.events())


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, starts, s, e):
    """Length of [s, e) covered by the sorted disjoint intervals ``merged``
    (``starts``: their start points)."""
    total = 0
    for a, b in merged[max(0, bisect.bisect_right(starts, s) - 1):]:
        if a >= e:
            break
        total += max(0, min(e, b) - max(s, a))
    return total


def summarize(events, top=10):
    """Reduce kineto events to a plain dict (seconds throughout):
    ``window_s``, ``busy_s``, ``device_ops`` {name: s},
    ``spans`` {name: [(host s, device s), ...] in the order they began} and ``idle_gaps`` [(what the
    host ran, s), ...] longest first."""
    cpu, dev = [], []
    for ev in events:
        name = ev.name()
        s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if "CUDA" in str(ev.device_type()):
            kind = _kind(ev)
            if "annotation" in kind or name.startswith("bench."):
                continue
            if kind and not any(k in kind for k in _DEVICE_KINDS):
                continue
            dev.append((name, s, e))
        else:
            cpu.append((name, s, e))
    windows = [(s, e) for name, s, e in cpu if name == WINDOW]
    if not windows:
        raise RuntimeError("the profiler's trace holds no window annotation")
    w0, w1 = windows[0]
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    merged = _union([(s, e) for _n, s, e in dev])
    busy = sum(e - s for s, e in merged)
    starts = [a for a, _b in merged]

    ops = {}
    for n, s, e in dev:
        ops[n] = ops.get(n, 0) + (e - s)

    spans = {}
    for n, s, e in sorted(cpu, key=lambda x: x[1]):
        if n.startswith("bench.") and n != WINDOW:
            spans.setdefault(n, []).append(((e - s) * 1e-9, _overlap(merged, starts, s, e) * 1e-9))

    # idle gaps, named by the innermost host operation running at the gap's middle
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    idle = []
    for length, s, e in gaps:
        mid = (s + e) // 2
        running = [(ce - cs, n) for n, cs, ce in cpu if cs <= mid < ce and n != WINDOW]
        idle.append((min(running)[1] if running else "host (no traced operation)", length * 1e-9))

    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy * 1e-9,
        "device_ops": sorted(((n, t * 1e-9) for n, t in ops.items()), key=lambda x: -x[1]),
        "spans": spans,
        "idle_gaps": idle,
    }
