"""The Kyber cell, ``kyber768.decode``: its readers, its ``failed`` count and its checks.

On the CPU, at a small code (N_b 48, R 32, SW 6; the port's plain versions of
its kernels): the three readers (``kyber.decode_roofline``,
``kyber.step_host_ms``, ``device.idle_share.kyber``) give nothing outside a
Kyber run and the right value on a fabricated one; a sound run is correct,
counts ``failed`` 0 and, traced, records the program's spans; an entry whose
counts cannot be counts exactly its unusable attacks as failed; and a decode
or a count broken underneath the step comes out not correct.  On the card
(marked ``cuda``): the cell through the command is correct, and its bf16
control (``controls.py``) is not.
"""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import run as bench
from benchmark.roofline_kyber import special_bound_ms
from benchmark.tests.test_bench_layout import ROOT
from sca_ldpc_tpu_torch.utils import spans

torch.set_num_threads(1)

SMALL = {"n": 16, "n_b": 48, "r": 32}
SMALL_MIX = {"batch": 16, "check_steps": [1, 1, 1], "check_frames": [8, 8, 8], "reference_block": 8}
READERS = ("kyber.decode_roofline", "kyber.step_host_ms", "device.idle_share.kyber")
CONFIG = {"n_b": 768, "r": 512, "sum_weight": 6, "eta": 2, "bsum": 12}
TRACE = {"window_s": 30.0, "busy_s": 28.5}
KYBER_RUN = SimpleNamespace(kind="kyber", traces=[TRACE], config=CONFIG)
SNAPSHOT = {
    "spans": {"kyber.simulation": {"calls": 400, "host_s": 25.0}, "kyber.count": {"calls": 400, "host_s": 23.8},
              "kyber.decode": {"calls": 400, "host_s": 0.4}},
    "counters": {"kyber.frames": 400 * 4096, "kyber.frame_iterations": 400 * 4096 * 10,
                 "kyber.wrong_coefficients": 12345},
}


@pytest.fixture(autouse=True)
def clean_registry():
    spans.reset()
    yield
    spans.reset()


def _drive(seconds=1.0, trace=0, mix=None, seed=2**31 + 4242):
    cell = bench.Cell("kyber768.decode")
    cell.config = {**cell.config, **SMALL}
    cell.traffic = {**cell.traffic, **SMALL_MIX, **(mix or {})}
    ctx = bench.Context(cell, seed, seconds, trace, 0, 1, torch.device("cpu"))
    result = bench.driver_module(cell.traffic).run(ctx)
    return result, bench.result_line(cell, result, trace, "cpu")


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name, monkeypatch):
    read = bench.metric_reader(name)
    assert read(SimpleNamespace(kind="fer", traces=[TRACE], config=CONFIG)) is None
    assert read(SimpleNamespace()) is None
    monkeypatch.setattr(spans, "snapshot", lambda: SNAPSHOT)
    assert read(SimpleNamespace(kind="attack", traces=[TRACE], config=CONFIG)) is None


@pytest.mark.parametrize("name", ["kyber.decode_roofline", "kyber.step_host_ms"])
def test_program_readers_need_the_program_record(name):
    assert bench.metric_reader(name)(KYBER_RUN) is None  # the registry is empty


def test_values_of_a_fabricated_run(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: SNAPSHOT)
    least_ms = special_bound_ms(400 * 4096 * 10, 400 * 4096, 400, 768, 512, 6, 2, 12)
    assert bench.metric_reader("kyber.decode_roofline")(KYBER_RUN) == pytest.approx(100 * least_ms * 1e-3 / 28.5)
    assert bench.metric_reader("kyber.step_host_ms")(KYBER_RUN) == pytest.approx(1000 * 1.2 / 400)
    assert bench.metric_reader("device.idle_share.kyber")(KYBER_RUN) == pytest.approx(5.0)


def test_least_time_is_the_program_bound():
    """The frozen bound equals ``chip_smoke.py``'s for K7 at its 512 frames."""
    from sca_ldpc_tpu_torch.ops.kernels.bounds import chain_bound_ms

    ours = special_bound_ms(512 * 10, 512, 1, 768, 512, 6, 2, 12)
    assert ours == pytest.approx(chain_bound_ms(512 * 512 * 10, 6, 2, 22, 2, 12, 1)[0])
    assert ours == pytest.approx(0.25796, rel=1e-4)


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(trace):
    result, line = _drive(trace=trace)
    assert line["correct"] and line["failed"] == 0
    assert line["attempted"] == result["run"].steps * SMALL_MIX["batch"] > 0
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device"] + ["breakdown"] * trace + ["checks"]
    assert set(line["checks"]) == {"kyber.count_gap", "kyber.flip_z", "kyber.channel_gap", "kyber.decision_gap"}
    recorded = spans.snapshot()
    if not trace:
        assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
        assert recorded == {"spans": {}, "counters": {}}
        return
    assert recorded["counters"]["kyber.frames"] == line["attempted"]
    assert recorded["counters"]["kyber.frame_iterations"] == 10 * line["attempted"]
    assert line["metrics"]["kyber.step_host_ms"]["value"] > 0
    assert line["metrics"]["device.idle_share.kyber"]["value"] == pytest.approx(100.0)  # no device on the CPU


def _entry(monkeypatch, fault):
    """The entry answers every third call wrongly, the first of the window
    among them; returns the calls (answered wrongly or not) and the attacks
    each wrong answer leaves out."""
    from sca_ldpc_tpu_torch import parallel

    entry, calls = parallel.kyber_attack_simulation, []

    def broken(*args, **kwargs):
        ok, wrong, frames = entry(*args, **kwargs)
        calls.append(len(calls) % 3 == 0)
        if not calls[-1]:
            return ok, wrong, frames
        if fault == "short":  # the step says it ran 4 attacks fewer than asked
            return min(ok, frames - 4), wrong, frames - 4
        if fault == "more_ok":
            return frames + 1, wrong, frames
        if fault == "fractional":
            return ok, wrong + 0.5, frames
        if fault == "negative":
            return ok, -1, frames
        if fault == "too_wrong":  # more wrong coefficients than the attacks hold
            return ok, frames * 48 + 1, frames
        return ok, wrong, frames + 4  # more attacks than asked

    monkeypatch.setattr(parallel, "kyber_attack_simulation", broken)
    return calls, 4 if fault == "short" else SMALL_MIX["batch"]


@pytest.mark.parametrize("fault", ["short", "more_ok", "fractional", "negative", "too_wrong", "more_frames"])
def test_unanswered_attacks_are_failures(monkeypatch, fault):
    calls, missing = _entry(monkeypatch, fault)
    result, line = _drive()
    window = calls[3:]  # after one warm-up step an accuracy
    assert len(window) == result["run"].steps and sum(window) > 0
    assert line["attempted"] == len(window) * SMALL_MIX["batch"]
    assert line["failed"] == sum(window) * missing


def _decoder_fault(monkeypatch, fault):
    """The decode broken where it produces its decisions (every call of
    ``QarySpecialDecoder._decode_llr``), or the step's count altered."""
    from sca_ldpc_tpu_torch.ops.qary_special import QarySpecialDecoder
    from sca_ldpc_tpu_torch.parallel import kyber

    if fault == "count":
        make = kyber.make_kyber_attack_step

        def make_broken(*args, **kwargs):
            step = make(*args, **kwargs)

            def broken(generator, batch):
                ok, wrong, frames = step(generator, batch)
                return ok, wrong + 1, frames

            broken.tables = step.tables
            return broken

        monkeypatch.setattr(kyber, "make_kyber_attack_step", make_broken)
        return
    decode = QarySpecialDecoder._decode_llr

    def broken(self, llr_b, llr_s_row):
        hard = decode(self, llr_b, llr_s_row).clone()
        if fault == "altered":  # one decision of each frame moved
            hard[:, 0] = torch.where(hard[:, 0] < self.b, hard[:, 0] + 1, hard[:, 0] - 1)
        else:  # "channel": the decisions of the channel alone
            hard[:, : self.n_b] = torch.argmin(llr_b, dim=-1).to(hard.dtype) - self.b
        return hard

    monkeypatch.setattr(QarySpecialDecoder, "_decode_llr", broken)


@pytest.mark.parametrize("fault, check", [("altered", "kyber.decision_gap"), ("channel", "kyber.decision_gap"),
                                          ("count", "kyber.count_gap")])
def test_fault_is_not_correct(monkeypatch, fault, check):
    _decoder_fault(monkeypatch, fault)
    _result, line = _drive()
    assert not line["correct"] and line["checks"][check]["value"] > line["checks"][check]["limit"]


def _channel_fault(monkeypatch, fault):
    from sca_ldpc_tpu_torch.parallel import kyber

    if fault == "llr":  # the sums' tables not reversed
        tables = kyber._channel_tables

        def broken(*args):
            *rest, llr_sum = tables(*args)
            return *rest, llr_sum.flip(-1)

        monkeypatch.setattr(kyber, "_channel_tables", broken)
        return
    from sca_ldpc_tpu_torch import parallel

    tables = kyber.kyber_tables

    def noiseless(*args):  # no uniform exceeds an accuracy of 1: no answer is flipped
        return tables(*args)._replace(accuracy=1.0)

    monkeypatch.setattr(kyber, "kyber_tables", noiseless)
    monkeypatch.setattr(parallel, "kyber_tables", noiseless)


@pytest.mark.parametrize("fault, check", [("llr", "kyber.channel_gap"), ("noiseless", "kyber.flip_z")])
def test_draw_or_channel_fault_is_not_correct(monkeypatch, fault, check):
    _channel_fault(monkeypatch, fault)
    _result, line = _drive(mix={"batch": 64, "check_frames": [8, 8, 8]})
    assert not line["correct"] and line["checks"][check]["value"] > line["checks"][check]["limit"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "kyber768.decode", "--seed",
                          str(2**31 + 99), "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0 and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(card):
    from benchmark import controls

    reading = controls.control_run("kyber768.decode", 2**31 + 9, 2.0)
    gap = reading["checks"]["kyber.decision_gap"]
    assert gap["value"] > gap["limit"]
