"""The port's spans and counters (``utils/spans.py``) and where the FER step
records them: nothing while off; calls, host seconds and profiler ranges
nested under their caller while on; the kernel backends' iteration counter
against the plain decode on the same bits; the step's returns unchanged by
recording."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops.circulant_bp import _circulant_bp_frames
from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
    _syndrome_and_prior,
    circulant_bp_lean_plain,
    circulant_fer_cuda,
    circulant_fer_lean_cuda,
)
from sca_ldpc_tpu_torch.parallel import make_mesh
from sca_ldpc_tpu_torch.parallel.fer import fer_simulation, make_fer_step, sharded_fer_simulation
from sca_ldpc_tpu_torch.utils import spans

FER_SPANS = ("fer.sample", "fer.decode", "fer.reduce", "fer.count")


@pytest.fixture(autouse=True)
def clean_registry():
    spans.reset()
    yield
    spans.reset()


def _layout(n=127, w=3, seed=5):
    return CirculantLayout.from_first_row(random_circulant_first_row(n, w, seed), with_identity=True)


def _parents(prof, names):
    """[(name, the enclosing profiler range's name)] of the events named in ``names``."""
    return [(e.name, e.cpu_parent.name if e.cpu_parent else None) for e in prof.events() if e.name in names]


@spans.traced("t.fn")
def _traced(x):
    return x + 1


def test_nothing_recorded_when_off():
    assert not spans.recording()
    with spans.span("t.a"):
        with spans.span("t.b"):
            assert _traced(1) == 2
    spans.count("t.n", 3)
    spans.count("t.n", torch.tensor(2))
    assert spans.snapshot() == {"spans": {}, "counters": {}}
    # off, a span is one shared no-op object: nothing is allocated a call
    assert spans.span("t.a") is spans.span("t.b")
    with spans.span("t.c", clock=True) as clocked:
        time.sleep(0.002)
    assert clocked.seconds >= 0.002 and spans.snapshot()["spans"] == {}


@pytest.mark.parametrize("via", ["collect", "profiler"])
def test_spans_record_calls_host_time_and_profiler_ranges(via):
    def work():
        with record_function("t.caller"):
            with spans.span("t.outer"):
                with spans.span("t.inner"):
                    time.sleep(0.002)
                _traced(1)
                _traced(2)
            spans.count("t.n", 2)
            spans.count("t.n", 5)

    if via == "collect":
        with spans.collect():
            assert spans.recording()
            work()
        assert not spans.recording()
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert spans.recording()
            work()
        assert not spans.recording()
        parents = _parents(prof, {"t.outer", "t.inner", "t.fn"})
        assert sorted(parents) == [("t.fn", "t.outer"), ("t.fn", "t.outer"), ("t.inner", "t.outer"),
                                   ("t.outer", "t.caller")]
    got = spans.snapshot()
    assert {n: s["calls"] for n, s in got["spans"].items()} == {"t.outer": 1, "t.inner": 1, "t.fn": 2}
    assert got["spans"]["t.outer"]["host_s"] >= got["spans"]["t.inner"]["host_s"] >= 0.002
    assert got["counters"] == {"t.n": 7}
    with spans.collect():
        with spans.span("t.c", clock=True) as clocked:
            time.sleep(0.001)
    assert spans.snapshot()["spans"]["t.c"]["host_s"] == clocked.seconds
    spans.reset()
    assert spans.snapshot() == {"spans": {}, "counters": {}}


def test_same_name_nested_span_counts_once():
    @spans.traced("t.rec")
    def rec(depth):
        return 0 if depth == 0 else 1 + rec(depth - 1)

    with spans.collect():
        with spans.span("t.a"):
            with spans.span("t.a"):
                time.sleep(0.001)
            with spans.span("t.b"):
                pass
        assert rec(3) == 3
        assert rec(2) == 2
    got = spans.snapshot()["spans"]
    assert {n: s["calls"] for n, s in got.items()} == {"t.a": 1, "t.b": 1, "t.rec": 2}


class _Watched(torch.Tensor):
    """A tensor that counts the reads that would make the host wait for it."""

    reads = 0

    def _read(self, fn):
        type(self).reads += 1
        return fn(self.as_subclass(torch.Tensor))

    def __int__(self):
        return self._read(int)

    def __index__(self):
        return self._read(int)

    def __float__(self):
        return self._read(float)

    def __bool__(self):
        return self._read(bool)

    def item(self):
        return self._read(lambda t: t.item())

    def tolist(self):
        return self._read(lambda t: t.tolist())


def test_tensor_counters_sum_where_they_live_and_read_once():
    _Watched.reads = 0
    with spans.collect():
        spans.count("t.n", 4)
        for v in (3, 10, 100):
            spans.count("t.n", torch.tensor(v, dtype=torch.int64).as_subclass(_Watched))
        spans.count("t.m", torch.tensor(7, dtype=torch.int32).as_subclass(_Watched))
    assert _Watched.reads == 0
    assert spans.snapshot()["counters"] == {"t.n": 117, "t.m": 7}
    assert _Watched.reads == 2


@pytest.mark.parametrize("entry", ["fer_simulation", "sharded_fer_simulation"])
@pytest.mark.parametrize("backend", ["fused", "lean", "decode"])
def test_fer_simulation_spans_nest_under_the_caller(entry, backend):
    lay = _layout()
    probs = np.full(lay.n_vars, 0.03, np.float32)
    g = torch.Generator().manual_seed(3)
    where = "cpu" if entry == "fer_simulation" else make_mesh(device="cpu")
    run = fer_simulation if entry == "fer_simulation" else sharded_fer_simulation
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("t.caller"):
            successes, frames = run(lay, probs, 48, g, where, batch=16, max_iter=8, backend=backend)
    assert frames == 48 and 0 < successes <= 48
    steps = 3
    parents = _parents(prof, {"fer.simulation", *FER_SPANS})
    assert parents.count(("fer.simulation", "t.caller")) == 1
    for name in ("fer.sample", "fer.decode", "fer.count"):
        assert parents.count((name, "fer.simulation")) == steps
    # the sharded step sums its counts over the ranks in a second fer.reduce
    reduces = steps * (1 if entry == "fer_simulation" else 2)
    assert parents.count(("fer.reduce", "fer.simulation")) == reduces
    assert len(parents) == 1 + 3 * steps + reduces
    got = spans.snapshot()
    assert {n: s["calls"] for n, s in got["spans"].items()} == {
        "fer.simulation": 1, "fer.sample": steps, "fer.decode": steps, "fer.reduce": reduces, "fer.count": steps}
    if backend == "decode":
        assert got["counters"] == {}
    else:
        assert got["counters"]["fer.frames"] == 48
        assert steps <= got["counters"]["fer.frame_iterations"] <= 48 * 8


@pytest.mark.parametrize("backend", ["fused", "lean"])
def test_kernel_backends_count_the_plain_decodes_iterations(backend):
    lay = _layout(150, 4, 7)
    rate, batch, runs, max_iter = 0.05, 32, 96, 12
    probs = np.full(lay.n_vars, rate, np.float32)
    with spans.collect():
        fer_simulation(lay, probs, runs, torch.Generator().manual_seed(11), "cpu", batch=batch, max_iter=max_iter,
                       backend=backend)
    g = torch.Generator().manual_seed(11)
    iterations = 0
    for _ in range(runs // batch):  # the same bits, drawn as the step draws them
        errors = (torch.rand((batch, lay.n_vars), generator=g) < np.float32(rate)).to(torch.uint8)
        syn, prior = _syndrome_and_prior(errors, lay.shifts, float(np.float32(rate)))
        if backend == "fused":
            _e, _conv, iters = _circulant_bp_frames(prior, prior, syn, tuple(lay.shifts), True, max_iter,
                                                    "product_sum")
        else:
            _e, _conv, iters = circulant_bp_lean_plain(prior, prior, syn, lay.shifts, max_iter)
        iterations += int(iters.sum())
    counters = spans.snapshot()["counters"]
    # "fused" also counts K1's staged frames: none on the CPU, where the plain version decodes
    staged = {"fer.k1_staged_frames": 0} if backend == "fused" else {}
    assert counters == {"fer.frames": runs, "fer.frame_iterations": iterations, **staged}
    assert runs < iterations < runs * max_iter  # some frames need more than one, not every frame all


@pytest.mark.parametrize("backend", ["fused", "lean", "decode"])
def test_make_fer_step_returns_the_same_recording_or_not(backend):
    lay = _layout(150, 4, 7)
    probs = np.full(lay.n_vars, 0.05, np.float32)
    step = make_fer_step(lay, probs, "cpu", 10, "product_sum", backend)
    off = step(torch.Generator().manual_seed(5), 24)
    with spans.collect():
        on = step(torch.Generator().manual_seed(5), 24)
    assert spans.snapshot()["spans"]["fer.decode"]["calls"] == 1
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and a.shape == b.shape == () and torch.equal(a, b)
    assert int(off[0]) > 0
    assert int(off[2]) == -1 if backend != "decode" else 1 <= int(off[2]) <= 10


@pytest.mark.parametrize("bad", [torch.empty(8, dtype=torch.int64), torch.empty(7, dtype=torch.int32)])
def test_fer_wrappers_check_iters_out(bad):
    lay = _layout()
    errors = torch.zeros((8, lay.n_vars), dtype=torch.uint8)
    for kernel in (circulant_fer_cuda, circulant_fer_lean_cuda):
        with pytest.raises((TypeError, ValueError), match="iters_out"):
            kernel(errors, lay.shifts, 0.05, 5, iters_out=bad)
        iters = torch.full((8,), -1, dtype=torch.int32)
        ok, _conv = kernel(errors, lay.shifts, 0.05, 5, iters_out=iters)
        assert ok.all() and torch.equal(iters, torch.ones(8, dtype=torch.int32))  # zero errors: converged at once
