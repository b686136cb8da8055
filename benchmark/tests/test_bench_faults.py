"""The comparison that decides ``correct`` catches a broken timed path.

Each test drives the rest of a run on the CPU (the port's plain versions of its
kernels, without the harness's look for a card), first unchanged and then with
the timed path broken underneath, and sees ``correct`` come out false.  The
FER cells' faults: an answer altered where it is produced, half of the batch
left out with the count taken over the rest, a step that decodes nothing and
reports its frames as they came in, and (over four gloo ranks) the exchange
between the ranks left out.  The FER cells' ``failed`` counts the frames a step
gave no usable answer for, not the frames the code cannot decode: a sound run
with frames not decoded reads 0, and an entry that runs short or returns a
count that cannot be reads exactly its missing or unusable frames.  The attack cell's: a decision altered where the
decode produces it, and a decode that returns its prior unchanged.
"""

import os
import subprocess
import sys
import tempfile

import pytest
import torch

from benchmark import run as bench
from benchmark.tests.test_bench_layout import ROOT

TINY = {"n": 150, "code_weight": 4, "first_row_seed": 3}
TINY_FER = {"batch": 64, "error_rates": [0.03, 0.05], "reference_block": 32, "check_steps": [2, 4],
            "check_frames": [64, 64]}


def _drive(workload, config=None, traffic=None, seconds=1.0, seed=2**31 + 12345):
    """The driver's result and the result line of one run on the CPU."""
    cell = bench.Cell(workload)
    cell.config = {**cell.config, **(config or {})}
    cell.traffic = {**cell.traffic, **(traffic or {})}
    ctx = bench.Context(cell, seed, seconds, 0, 0, 1, torch.device("cpu"))
    result = bench.driver_module(cell.traffic).run(ctx)
    return result, bench.result_line(cell, result, 0, "cpu")


def _run(*args, **kwargs):
    return _drive(*args, **kwargs)[1]


def _fer_kernel(monkeypatch, fault):
    from sca_ldpc_tpu_torch.parallel import fer

    kernel = fer._KERNELS["fused"]

    def broken(errors, shifts, rate, max_iter, method="product_sum"):
        if fault == "unchanged":  # nothing decoded: every frame reported as it came in
            b = errors.shape[0]
            return torch.ones(b, dtype=torch.bool), torch.ones(b, dtype=torch.bool)
        if fault == "half":  # half of the batch decoded, its count taken for the whole
            ok, conv = kernel(errors[: errors.shape[0] // 2], shifts, rate, max_iter, method)
            return torch.cat([ok, ok]), torch.cat([conv, conv])
        ok, conv = kernel(errors, shifts, rate, max_iter, method)
        ok = ok.clone()
        ok[0] = ~ok[0]  # one frame's answer altered where it is produced
        return ok, conv

    monkeypatch.setitem(fer._KERNELS, "fused", broken)


def test_fer_sound_run_is_correct():
    result, line = _drive("hqc128.fer", TINY, TINY_FER)
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] == result["run"].steps * TINY_FER["batch"] > 0
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_fer_undecoded_frames_are_not_failures(capsys):
    result, line = _drive("hqc128.fer", TINY, TINY_FER)
    undecoded = result["run"].undecoded
    assert undecoded[0.05] > 0 and 0 < result["run"].undecoded_share < 1
    assert line["correct"] and line["failed"] == 0
    printed = [s for s in capsys.readouterr().err.splitlines() if s.startswith("fer: frames not decoded")]
    assert printed and f"0.05 {100 * undecoded[0.05]:.3f}%" in printed[0]


def _fer_entry(monkeypatch, fault):
    """The entry answers every third call wrongly; returns the window's calls
    as (asked, answered wrongly) and the frames each wrong answer leaves out."""
    from sca_ldpc_tpu_torch import parallel

    entry, calls = parallel.fer_simulation, []

    def broken(layout, probs, runs, generator, device, **kwargs):
        ok, frames = entry(layout, probs, runs, generator, device, **kwargs)
        calls.append(len(calls) % 3 == 2)
        if not calls[-1]:
            return ok, frames
        if fault == "short":  # the step says it ran 8 frames fewer than asked
            return min(ok, frames - 8), frames - 8
        if fault == "more_ok":  # more frames decoded than it ran
            return frames + 1, frames
        if fault == "fractional":
            return ok + 0.5, frames
        if fault == "negative":
            return -1, frames
        return ok, frames + 8  # more frames than asked

    monkeypatch.setattr(parallel, "fer_simulation", broken)
    return calls, 8 if fault == "short" else TINY_FER["batch"]


@pytest.mark.parametrize("fault", ["short", "more_ok", "fractional", "negative", "more_frames"])
def test_fer_unanswered_frames_are_failures(monkeypatch, fault):
    calls, missing = _fer_entry(monkeypatch, fault)
    result, line = _drive("hqc128.fer", TINY, TINY_FER)
    window = calls[len(TINY_FER["error_rates"]):]  # after one warm-up step a rate
    assert len(window) == result["run"].steps and sum(window) > 0
    assert line["attempted"] == len(window) * TINY_FER["batch"]
    assert line["failed"] == sum(window) * missing


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_fer_fault_is_not_correct(monkeypatch, fault):
    _fer_kernel(monkeypatch, fault)
    line = _run("hqc128.fer", TINY, TINY_FER)
    assert not line["correct"] and line["checks"]["fer.frame_gap"]["value"] > 0


def sharded_cell():
    """The FER cell through ``sharded_fer_simulation`` on four ranks at the
    tiny size: the harness's path for a cell of several chips."""
    cell = bench.Cell("hqc128.fer")
    cell.config = {**cell.config, **TINY}
    cell.traffic = {**cell.traffic, **TINY_FER, "entry": "sharded_fer_simulation", "batch": 256}
    cell.chips = 4
    return cell


def _world(fault):
    rdv = os.path.join(tempfile.mkdtemp(), "init")
    cmd = [sys.executable, "-m", "benchmark.tests.bench_world_rank", rdv, fault]
    procs = [subprocess.Popen(cmd + [str(r)], cwd=ROOT, stdout=subprocess.PIPE, text=True) for r in range(4)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0, 0]
    return outs[0].strip().splitlines()[-1]


@pytest.mark.parametrize("fault,correct", [("none", "True"), ("no_exchange", "False")])
def test_sharded_fer_exchange(fault, correct):
    assert _world(fault) == correct


ATTACK = {"max_oracle_calls": 2400, "warmup_oracle_calls": 300, "check_attacks": 1}


def _attack_decode(monkeypatch, fault):
    from sca_ldpc_tpu_torch.models.hqc import attack

    decode = attack._multi_circulant_bp

    def broken(prior_c, prior_i, syndrome, shifts, max_iter, method):
        e_c, e_i, conv, it = decode(prior_c, prior_i, syndrome, shifts, max_iter, method)
        if fault == "unchanged":  # the decode returns the decisions of its priors
            return (prior_c < 0).to(e_c.dtype), (prior_i < 0).to(e_i.dtype), conv, it
        e_c = e_c.clone()
        e_c[0, 0] ^= 1  # one decision altered where the decode produces it
        return e_c, e_i, conv, it

    monkeypatch.setattr(attack, "_multi_circulant_bp", broken)


def test_attack_sound_run_is_correct():
    line = _run("hqc128.attack", traffic=ATTACK, seconds=0.1)
    assert line["correct"] and line["attempted"] == 1
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("fault", ["altered", "unchanged"])
def test_attack_fault_is_not_correct(monkeypatch, fault):
    _attack_decode(monkeypatch, fault)
    line = _run("hqc128.attack", traffic=ATTACK, seconds=0.1)
    assert not line["correct"] and line["checks"]["attack.decode_stats_gap"]["value"] > 0
