"""Spans and counters inside the program, recorded only while something reads them.

The program marks its layers with named spans and counts its work at the same
places:

- :func:`span` (a context manager) and :func:`traced` (a decorator) mark a
  host range;
- :func:`count` adds an int, or a 0-d device tensor, to a named counter.

Recording is on inside :func:`collect` (for scripts) and while a
``torch.profiler`` session is active, checked at each call.  Under the
profiler a span is also a profiler range (a ``RecordFunction``, as
``torch.profiler.record_function`` opens, but in the function scope that
PyTorch's own operators use), so it lands in the profiler's trace with the
kernels, on the trace's clock, nested under whatever range is open around it.
The user scope of ``record_function`` would also mirror each range onto the
device's timeline as an annotation, which a reader of the device's events
would take for device work.  When recording is off a span costs one flag
check and allocates nothing, a traced function is called directly, and a
count does nothing.

:func:`snapshot` reads what was recorded: ``{"spans": {name: {"calls",
"host_s"}}, "counters": {name: int}}``; :func:`reset` clears it.  A span
opened inside an open span of the same name, on the same thread, is counted
once.  A tensor counter is summed on its device and read (one sync) only by
:func:`snapshot`.

Spans: ``fer.*`` in ``parallel/fer.py``, ``attack.*`` in
``models/hqc/attack.py``, ``kyber.*`` in ``parallel/kyber.py`` and
``ops/qary_special.py`` (PERF.md names each with what reads it).
"""

import contextlib
import functools
import threading
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_lock = threading.Lock()
_spans = {}  # name -> [calls, host seconds]
_counters = {}  # name -> int or 0-d tensor
_collecting = 0
_open = threading.local()  # .names: the span names open on this thread
_OFF = contextlib.nullcontext()


def recording():
    """True inside :func:`collect` or while a ``torch.profiler`` session is active."""
    return _collecting > 0 or _profiler._is_profiler_enabled


class _Span:
    """A recorded span, also a profiler range under the profiler; with
    ``record`` False it only reads the host clock (``seconds`` after the
    block)."""

    __slots__ = ("name", "seconds", "_record", "_outer", "_range", "_t0")

    def __init__(self, name, record=True):
        self.name, self.seconds, self._record = name, 0.0, record

    def __enter__(self):
        names = getattr(_open, "names", None)
        if names is None:
            names = _open.names = set()
        self._outer = self._record and self.name not in names
        self._range = None
        if self._outer:
            names.add(self.name)
            if _profiler._is_profiler_enabled:
                self._range = _RecordFunctionFast(self.name)
                self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._outer:
            if self._range is not None:
                self._range.__exit__(*exc)
            _open.names.discard(self.name)
            with _lock:
                entry = _spans.setdefault(self.name, [0, 0.0])
                entry[0] += 1
                entry[1] += self.seconds
        return False


def span(name, clock=False):
    """``with span(name): ...`` records the block as ``name`` while recording.

    With ``clock`` the span reads the host clock whether or not it records and
    yields an object whose ``seconds`` holds the block's duration after it, for
    callers that keep that time themselves."""
    if clock:
        return _Span(name, recording())
    return _Span(name) if recording() else _OFF


def traced(name):
    """Decorator: each call of the function is a span ``name`` while recording."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return wrapper

    return decorate


def count(name, value):
    """Add ``value`` (an int or a 0-d tensor, summed where it lives) to the
    counter ``name`` while recording."""
    if not recording():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


@contextlib.contextmanager
def collect():
    """Record spans and counters inside the block (nests)."""
    global _collecting
    with _lock:
        _collecting += 1
    try:
        yield
    finally:
        with _lock:
            _collecting -= 1


def snapshot():
    """What was recorded since the last :func:`reset`: ``{"spans": {name:
    {"calls", "host_s"}}, "counters": {name: int}}``."""
    with _lock:
        spans = {n: {"calls": c, "host_s": s} for n, (c, s) in _spans.items()}
        counters = dict(_counters)
    return {"spans": spans, "counters": {n: int(v) for n, v in counters.items()}}


def reset():
    """Forget every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _counters.clear()
