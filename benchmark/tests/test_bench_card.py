"""Card tests of the benchmark (marked ``cuda``; they skip without a card).

A cell runs through the command and comes out correct; each cell's control, at
a size a test run holds, comes out not correct.  Run on the card with
``python -m pytest benchmark/tests -m cuda``.
"""

import json
import subprocess
import sys

import pytest

from benchmark.tests.test_bench_layout import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", ["hqc128.fer", "hqc128.attack"])
def test_cell_runs_correct(card, workload):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(2**31 + 99),
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] and line["device"]["platform"] == "gpu"


def test_fer_control_is_not_correct(card, monkeypatch):
    from benchmark import controls, run

    cell = run.Cell("hqc128.fer")
    monkeypatch.setattr(run, "Cell", lambda name: cell)
    cell.traffic = {**cell.traffic, "check_steps": [0, 0, 0, 0, 0, 4, 0, 0]}
    reading = controls.control_run("hqc128.fer", 2**31 + 7, 6.0)
    gap = reading["checks"]["fer.frame_gap"]
    assert gap["value"] > gap["limit"]


def test_attack_control_is_not_correct(card):
    from benchmark import controls

    reading = controls.control_run("hqc128.attack", 2**31 + 8, 2.0)
    gap = reading["checks"]["attack.decode_stats_gap"]
    assert gap["value"] > gap["limit"]
