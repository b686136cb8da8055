"""The reader of K1's staged share (``metrics/fer.k1_staged_share.py``):
nothing outside a FER run, on an empty registry, where the program has no
spans module or keeps no ``fer.k1_staged_frames`` counter (a program before
the staged form), or where no frame was counted; the right value on a
fabricated snapshot, 0 included; and in the line of a traced FER run on the
CPU, where an untraced run records nothing."""

import sys
from types import SimpleNamespace

import pytest
import torch

import sca_ldpc_tpu_torch.utils
from benchmark import run as bench
from benchmark.tests.test_bench_faults import TINY, TINY_FER
from sca_ldpc_tpu_torch.utils import spans

NAME = "fer.k1_staged_share"
FER_RUN = SimpleNamespace(kind="fer")
SNAPSHOT = {
    "spans": {"fer.simulation": {"calls": 4, "host_s": 2.0}, "fer.decode": {"calls": 4, "host_s": 0.3}},
    "counters": {"fer.frames": 16384, "fer.frame_iterations": 196608, "fer.k1_staged_frames": 12288},
}


@pytest.fixture(autouse=True)
def clean_registry():
    spans.reset()
    yield
    spans.reset()


def test_nothing_to_read(monkeypatch):
    read = bench.metric_reader(NAME)
    assert read(SimpleNamespace(kind="attack")) is None and read(SimpleNamespace()) is None
    assert read(FER_RUN) is None  # the registry is empty
    monkeypatch.setattr(spans, "snapshot", lambda: SNAPSHOT)
    assert read(SimpleNamespace(kind="attack")) is None
    # a program without the module
    monkeypatch.delattr(sca_ldpc_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "sca_ldpc_tpu_torch.utils.spans", None)
    assert read(FER_RUN) is None


def test_value_of_a_fabricated_snapshot(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: SNAPSHOT)
    assert bench.metric_reader(NAME)(FER_RUN) == pytest.approx(75.0)


@pytest.mark.parametrize("counters, value", [({"fer.frames": 4096}, None), ({"fer.k1_staged_frames": 0}, None),
                                             ({"fer.frames": 0, "fer.k1_staged_frames": 0}, None),
                                             ({"fer.frames": 4096, "fer.k1_staged_frames": 0}, 0.0),
                                             ({"fer.frames": 4096, "fer.k1_staged_frames": 4096}, 100.0)])
def test_needs_frames_and_its_counter(counters, value, monkeypatch):
    """None where no frame was counted or the program keeps no staged count,
    else the share, 0 included."""
    monkeypatch.setattr(spans, "snapshot", lambda: {"spans": {}, "counters": counters})
    assert bench.metric_reader(NAME)(FER_RUN) == value


@pytest.mark.parametrize("trace", [0, 1])
def test_fer_run_reads_it_only_when_traced(trace):
    cell = bench.Cell("hqc128.fer")
    cell.config = {**cell.config, **TINY}
    cell.traffic = {**cell.traffic, **TINY_FER}
    ctx = bench.Context(cell, 2**31 + 91, 1.0, trace, 0, 1, torch.device("cpu"))
    line = bench.result_line(cell, bench.driver_module(cell.traffic).run(ctx), trace, "cpu")
    recorded = spans.snapshot()
    assert line["correct"]
    if not trace:
        assert recorded == {"spans": {}, "counters": {}} and NAME not in line["metrics"]
        return
    # on the CPU the plain version decodes: no frame went through K1's staged form
    assert recorded["counters"]["fer.frames"] == line["attempted"]
    assert recorded["counters"]["fer.k1_staged_frames"] == 0
    assert line["metrics"][NAME] == {"value": 0.0, "unit": "%"}
