"""The command on a machine without a card, and in a checkout that holds only
the benchmark: it fails and prints no result."""

import shutil
import subprocess
import sys

import pytest

from benchmark.tests.test_bench_layout import BENCH, ROOT


def _has_card():
    import torch

    return torch.cuda.is_available()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_fails_without_a_card(workload):
    if _has_card():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, *BENCH["command"][1:], "--workload", workload, "--seed", str(2**31 + 5),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *BENCH["command"][1:], "--workload", BENCH["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
