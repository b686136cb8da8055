"""The readers of the program's own spans and counters
(``metrics/fer.iterations_per_frame.py``, ``metrics/fer.step_host_ms.py``):
nothing outside a FER run, on an empty registry or where the program has no
such module; the right value on a fabricated snapshot; and both in the line of
a traced FER run on the CPU, where an untraced run records nothing."""

import sys
from types import SimpleNamespace

import pytest
import torch

import sca_ldpc_tpu_torch.utils
from benchmark import run as bench
from benchmark.tests.test_bench_faults import TINY, TINY_FER
from sca_ldpc_tpu_torch.utils import spans

READERS = ("fer.iterations_per_frame", "fer.step_host_ms")
FER_RUN = SimpleNamespace(kind="fer")
SNAPSHOT = {
    "spans": {"fer.simulation": {"calls": 4, "host_s": 2.0}, "fer.count": {"calls": 4, "host_s": 1.5},
              "fer.decode": {"calls": 4, "host_s": 0.3}, "fer.sample": {"calls": 4, "host_s": 0.01}},
    "counters": {"fer.frames": 16384, "fer.frame_iterations": 196608},
}


@pytest.fixture(autouse=True)
def clean_registry():
    spans.reset()
    yield
    spans.reset()


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name, monkeypatch):
    read = bench.metric_reader(name)
    assert read(SimpleNamespace(kind="attack")) is None and read(SimpleNamespace()) is None
    assert read(FER_RUN) is None  # the registry is empty
    monkeypatch.setattr(spans, "snapshot", lambda: SNAPSHOT)
    assert read(SimpleNamespace(kind="attack")) is None
    # a program without the module
    monkeypatch.delattr(sca_ldpc_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "sca_ldpc_tpu_torch.utils.spans", None)
    assert read(FER_RUN) is None


@pytest.mark.parametrize("name, value", [("fer.iterations_per_frame", 12.0), ("fer.step_host_ms", 125.0)])
def test_value_of_a_fabricated_snapshot(name, value, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: SNAPSHOT)
    assert bench.metric_reader(name)(FER_RUN) == pytest.approx(value)


@pytest.mark.parametrize("trace", [0, 1])
def test_fer_run_records_only_when_traced(trace):
    cell = bench.Cell("hqc128.fer")
    cell.config = {**cell.config, **TINY}
    cell.traffic = {**cell.traffic, **TINY_FER}
    ctx = bench.Context(cell, 2**31 + 77, 1.0, trace, 0, 1, torch.device("cpu"))
    line = bench.result_line(cell, bench.driver_module(cell.traffic).run(ctx), trace, "cpu")
    recorded = spans.snapshot()
    assert line["correct"]
    if not trace:
        assert recorded == {"spans": {}, "counters": {}} and not set(READERS) & set(line["metrics"])
        return
    frames = recorded["counters"]["fer.frames"]
    assert frames == line["attempted"]
    assert line["metrics"]["fer.iterations_per_frame"] == {
        "value": recorded["counters"]["fer.frame_iterations"] / frames, "unit": "iterations"}
    assert 1.0 <= line["metrics"]["fer.iterations_per_frame"]["value"] <= cell.traffic["max_iter"]
    assert line["metrics"]["fer.step_host_ms"]["unit"] == "ms" and line["metrics"]["fer.step_host_ms"]["value"] > 0
    assert recorded["spans"]["fer.decode"]["calls"] == recorded["spans"]["fer.simulation"]["calls"]
