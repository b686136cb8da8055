"""PyTorch port conformance: the scripts (``sca_ldpc_tpu_torch.scripts``) and
the pandas-free tables they write (``utils/table.py``), on the CPU.

- ``sweep_hqc``: ``tests/test_sweep_driver.py``'s cases on the port (the
  attack stubbed, the stub taking ``device``), and the JAX script's
  ``(weight, seed)`` sequence for the same argv; the batched path's seeds.
- ``utils.table``: CSV bytes equal to ``DataFrame.to_csv(index=False)``
  (header once, rows appended), the stale-row drop equal to the JAX
  script's pandas drop.
- ``attack_phase_profile``: a bounded attack on the CPU; the JAX script's
  artifact keys, decode + oracle <= wall, the wrapped methods restored.
- The timing trio with the attack stubbed: an artifact with ``error`` is not
  merged into ``summary.json``; the checkpoint (the private key) is gone
  after a recovery.
- ``profile_trace``: raises without a card; ``build_code`` equals the JAX
  benchmark's; the idle-share arithmetic on synthetic device events.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

import sca_ldpc_tpu_torch.models.hqc as hqc_pkg
from sca_ldpc_tpu_torch.models.hqc import HqcSimulationTracking, batched
from sca_ldpc_tpu_torch.models.hqc.attack import make_params
from sca_ldpc_tpu_torch.scripts import (
    attack_phase_profile,
    profile_trace,
    sweep_hqc,
    timing_attack,
    timing_attack_batched,
    timing_attack_stats,
)
from sca_ldpc_tpu_torch.utils import table as tbl

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KEY = str(ROOT / "fixtures" / "test-hqc128.key")


# -- sweep_hqc ----------------------------------------------------------------


def _tracking(weight, seed, calls=None):
    tr = HqcSimulationTracking(make_params("128", 50, weight))
    tr.num_oracle_calls = 1000 + seed % 97 if calls is None else calls
    tr.add_decoder_stats(100, 0, 0, 0, 0, 0, True)
    return tr


def _run_sweep(tmp_path, monkeypatch, labels, calls_log, extra=()):
    csv = str(tmp_path / "sweep.csv")

    def fake_attack(rng, decode_every, weight, keyfile, error_rate, param_set, max_oracle_calls=None,
                    oracle_backend="fast", decode_backend="general", device="cuda"):
        assert device == "cpu"
        seed = rng.randint(2**31)
        calls_log.append((weight, seed))
        return True, _tracking(weight, seed)

    monkeypatch.setattr(hqc_pkg, "simulate_hqc_idealized_oracle", fake_attack)
    sweep_hqc.main(["--csv", csv, "--param-set", "128", "--weights", "20", "30", "--labels", *labels,
                    "--device", "cpu", *extra])
    return csv


def test_sweep_runs_all_and_resumes(tmp_path, monkeypatch):
    calls = []
    csv = _run_sweep(tmp_path, monkeypatch, ["a", "b"], calls)
    assert len(calls) == 4  # 2 labels x 2 weights
    df = pd.read_csv(csv)
    assert len(df) == 4
    assert sorted(df["label"]) == ["a", "a", "b", "b"]
    markers = sorted(os.listdir(csv + ".state"))
    assert markers == ["128-a-w20.done", "128-a-w30.done", "128-b-w20.done", "128-b-w30.done"]

    # Re-run: every config has a marker, nothing executes, CSV unchanged.
    calls2 = []
    _run_sweep(tmp_path, monkeypatch, ["a", "b"], calls2)
    assert calls2 == []
    assert len(pd.read_csv(csv)) == 4

    # Seeding is config-content-derived (crc32), not order-derived.
    calls3 = []
    _run_sweep(tmp_path, monkeypatch, ["c", "a"], calls3)
    assert len(calls3) == 2  # only label c runs
    calls4 = []
    os.remove(os.path.join(csv + ".state", "128-a-w20.done"))
    _run_sweep(tmp_path, monkeypatch, ["a"], calls4)
    assert len(calls4) == 1
    assert calls4[0] == calls[0]  # (a, w20) reproduces its original seed


def test_sweep_drops_stale_rows_on_rerun(tmp_path, monkeypatch):
    """A crash between CSV append and marker write must not double-count: the
    re-run drops the config's partial rows before re-appending."""
    calls = []
    csv = _run_sweep(tmp_path, monkeypatch, ["a"], calls)
    assert len(pd.read_csv(csv)) == 2

    os.remove(os.path.join(csv + ".state", "128-a-w20.done"))
    calls2 = []
    _run_sweep(tmp_path, monkeypatch, ["a"], calls2)
    assert len(calls2) == 1
    df2 = pd.read_csv(csv)
    assert len(df2) == 2  # still one row per config, not three
    assert sorted(df2["weight"]) == [20, 30]


def test_sweep_seed_sequence_equals_jax_script(tmp_path, monkeypatch):
    """The same argv gives the JAX script's (weight, seed) sequence."""
    import sca_ldpc_tpu.models.hqc as jax_hqc

    spec = importlib.util.spec_from_file_location("jax_sweep_hqc", ROOT / "scripts" / "sweep_hqc.py")
    jax_sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_sweep)
    labels = ["a", "7", "label with space"]
    jax_calls = []

    def jax_fake(rng, decode_every, weight, keyfile, error_rate, param_set, max_oracle_calls=None,
                 oracle_backend="fast", decode_backend="general"):
        seed = rng.randint(2**31)
        jax_calls.append((weight, seed))
        return True, SimpleNamespace(num_oracle_calls=1, decoder_stats_data_frame=lambda label: pd.DataFrame(
            [{"label": label, "weight": weight}]))

    monkeypatch.setattr(jax_hqc, "simulate_hqc_idealized_oracle", jax_fake)
    monkeypatch.setattr(sys, "argv", ["sweep_hqc.py", "--csv", str(tmp_path / "jax.csv"), "--param-set", "128",
                                      "--weights", "20", "30", "--labels", *labels, "--seed-base", "5",
                                      "--platform", "cpu"])
    jax_sweep.main()
    port_calls = []
    (tmp_path / "port").mkdir()
    _run_sweep(tmp_path / "port", monkeypatch, labels, port_calls, extra=("--seed-base", "5"))
    assert port_calls == jax_calls and len(port_calls) == 6


def test_sweep_batched_path(tmp_path, monkeypatch):
    """--batch-size > 1 runs simulate_hqc_attacks_batched on groups of labels
    with the configs' crc32 seeds; a died instance gets no marker."""
    import zlib

    groups = []

    def fake_batched(seeds, decode_every, weight, error_rate=0.0, param_set="128", max_oracle_calls=None,
                     oracle_backend="fast", decode_backend="general", device="cuda"):
        assert device == "cpu" and decode_backend == "circulant"
        groups.append((weight, list(seeds)))
        res = [(True, _tracking(weight, s)) for s in seeds]
        if weight == 30:
            res[-1] = None
        return res, 7

    monkeypatch.setattr(batched, "simulate_hqc_attacks_batched", fake_batched)
    csv = str(tmp_path / "sweep.csv")
    sweep_hqc.main(["--csv", csv, "--param-set", "128", "--weights", "20", "30", "--labels", "a", "b", "c",
                    "--batch-size", "2", "--decode-backend", "circulant", "--device", "cpu"])
    seed = lambda l, w: zlib.crc32(f"{l}-{w}".encode()) % (2**31)  # noqa: E731
    assert groups == [(20, [seed("a", 20), seed("b", 20)]), (20, [seed("c", 20)]),
                      (30, [seed("a", 30), seed("b", 30)]), (30, [seed("c", 30)])]
    assert sorted(os.listdir(csv + ".state")) == ["128-a-w20.done", "128-a-w30.done", "128-b-w20.done",
                                                  "128-c-w20.done"]
    assert len(pd.read_csv(csv)) == 4


# -- utils.table --------------------------------------------------------------


RECORD_SETS = {
    "decoder stats": [
        {"checks": 50, "oracle_calls": np.int64(405), "unsatisfied": 3, "good_flips": 0, "bad_flips": 1,
         "found_bad_satisfied_checks": 0, "found_bad_unsatisfied_checks": 0, "success": False},
        {"checks": 100, "oracle_calls": 812, "unsatisfied": 7, "good_flips": 2, "bad_flips": 0,
         "found_bad_satisfied_checks": 1, "found_bad_unsatisfied_checks": 0, "success": np.bool_(True)},
    ],
    "kyber": [{"recovered": True, "correct_coefficients": 768, "total_coefficients": 768,
               "avg_measurements_per_coeff": 2.5807291666666665, "sum_measurements": 3072}],
    "mixed": [
        {"label": 'a "quoted", label', "x": 1, "y": 0.1 + 0.2, "z": None, "w": "multi\nline"},
        {"label": "", "x": 2.5, "y": 1e-05, "z": 3, "w": 7},
        {"label": None, "x": 3, "y": 1.0, "z": np.float64(0.5), "w": True},
    ],
    "missing": [{"a": np.float64(0.9942), "b": 1, "c": float("nan")}, {"a": 2, "b": None, "c": 1.0}],
}


@pytest.mark.parametrize("name", sorted(RECORD_SETS))
def test_csv_bytes_equal_pandas(tmp_path, name):
    records = RECORD_SETS[name]
    df = pd.DataFrame(records)
    tab = tbl.table(records)
    assert tab[0] == list(df.columns)
    assert tbl.csv_text(tab) == df.to_csv(index=False)
    path = tmp_path / "t.csv"
    tbl.append_csv(str(path), tab)
    tbl.append_csv(str(path), tab)
    assert path.read_text() == df.to_csv(index=False) + df.to_csv(index=False, header=False)


@pytest.mark.parametrize("label", [None, "sweep-3", 'x,"y"'])
def test_stats_table_equals_data_frame(tmp_path, label):
    """The port's stats table and frame equal the JAX tracking's
    ``decoder_stats_data_frame`` on the same stats: columns, order, values
    and CSV bytes."""
    from sca_ldpc_tpu.models.hqc.attack import make_params as jax_make_params
    from sca_ldpc_tpu.models.hqc.tracking import HqcSimulationTracking as JaxTracking

    tracking = _tracking(20, 11)
    tracking.add_decoder_stats(150, 9, 4, 1, 0, 2, False)
    reference = JaxTracking(jax_make_params("128", 50, 20))
    for stats in tracking.decoder_stats:
        reference.num_oracle_calls = stats["oracle_calls"]
        reference.add_decoder_stats(*(stats[k] for k in list(stats) if k != "oracle_calls"))
    jax_df = reference.decoder_stats_data_frame(label=label)
    df = tracking.decoder_stats_data_frame(label=label)
    pd.testing.assert_frame_equal(df, jax_df)
    tab = tracking.decoder_stats_table(label=label)
    assert tab[0] == list(jax_df.columns)
    assert tbl.csv_text(tab) == jax_df.to_csv(index=False)
    empty = HqcSimulationTracking(make_params("128", 50, 20))
    jax_empty = JaxTracking(jax_make_params("128", 50, 20)).decoder_stats_data_frame(label).to_csv(index=False)
    assert tbl.csv_text(empty.decoder_stats_table(label)) == jax_empty
    assert empty.decoder_stats_data_frame(label).to_csv(index=False) == jax_empty
    kyber = tbl.with_columns(tbl.table(RECORD_SETS["kyber"]), label=label, accuracy=0.95)
    kdf = pd.DataFrame(RECORD_SETS["kyber"])
    kdf["label"] = label
    kdf["accuracy"] = 0.95
    assert tbl.csv_text(kyber) == kdf.to_csv(index=False)


def test_drop_config_rows_equals_pandas_drop(tmp_path):
    rows = [{"label": lab, "alg": "hqc-128", "weight": w, "epsilon0": 0.9942, "checks": c, "success": c > 100}
            for lab in ("a", "17", "b c") for w in (20, 30) for c in (50, 150)]
    path = tmp_path / "s.csv"
    pd.DataFrame(rows).to_csv(path, index=False)
    for label, weight in (("17", 20), ("a", 30), ("zz", 20), ("b c", 20)):
        df0 = pd.read_csv(path)
        mask = (df0["label"].astype(str) == str(label)) & (df0["weight"] == weight)
        expected = df0[~mask].to_csv(index=False)
        assert tbl.drop_config_rows(str(path), label, weight) == int(mask.sum())
        assert path.read_text() == expected


# -- attack_phase_profile -----------------------------------------------------

JAX_PROFILE_KEYS = ("experiment", "param_set", "code_weight", "decode_every", "decode_backend", "p_bucket",
                    "platform", "seed", "success", "wall_seconds", "decode_seconds", "oracle_seconds",
                    "other_seconds", "decode_share", "oracle_share", "num_decodes", "num_raw_queries",
                    "oracle_calls", "seconds_per_decode")


@pytest.mark.parametrize("backend", ["general", "circulant"])
def test_attack_phase_profile_bounded(tmp_path, backend):
    import sca_ldpc_tpu_torch.models.hqc.attack as atk

    def wrapped():
        return (atk.CheckDecoder.decode, atk.MaskedCirculantCheckDecoder.decode, atk.HqcOracle._raw,
                atk.HqcOracle.query_candidates, atk.HqcOracle.flip_bit, atk.CheckDecoder.stats_from_decoded)

    before = wrapped()
    out = tmp_path / "profile.json"
    art = attack_phase_profile.main(["--out", str(out), "--param-set", "128", "--code-weight", "20",
                                     "--decode-every", "50", "--seed", "0", "--key-file", KEY,
                                     "--decode-backend", backend, "--device", "cpu",
                                     "--max-oracle-calls", "1500"])
    assert json.loads(out.read_text()) == art
    for key in JAX_PROFILE_KEYS:
        assert key in art
    assert art["p_bucket"] is None and art["platform"] == "cpu" and art["k8_seconds"] is None
    assert art["num_decodes"] >= 1 and art["oracle_calls"] >= 1500
    assert 0 < art["decode_seconds"] and 0 < art["oracle_seconds"]
    assert art["decode_seconds"] + art["oracle_seconds"] <= art["wall_seconds"]
    assert art["decode_build_seconds"] + art["decode_stats_seconds"] <= art["decode_seconds"]
    assert art["num_flips"] >= 1 and 0 < art["oracle_flip_seconds"] <= art["other_seconds"]
    assert wrapped() == before


# -- the timing trio ----------------------------------------------------------


def _fake_timing_attack(ok, checkpoints):
    def fake(rng, decode_every, weight, keyfile, error_rate, param_set, oracle_backend="fast",
             checkpoint_path=None, device="cuda", **kw):
        assert oracle_backend == "timing" and device == "cpu"
        tracking = HqcSimulationTracking(make_params(param_set, decode_every, weight))
        tracking.num_oracle_calls = 123
        tracking.add_decoder_stats(50, 1, 0, 0, 0, 0, ok)
        if checkpoint_path:
            Path(checkpoint_path).write_bytes(b"private key")
            checkpoints.append(checkpoint_path)
        return ok, tracking

    return fake


@pytest.mark.parametrize("ok", [True, False])
def test_timing_attack_checkpoint_gone_after_recovery(tmp_path, monkeypatch, ok):
    ckpts = []
    monkeypatch.setattr(hqc_pkg, "simulate_hqc_idealized_oracle", _fake_timing_attack(ok, ckpts))
    ckpt, out, csv = tmp_path / "attack.ckpt", tmp_path / "art.json", tmp_path / "s.csv"
    art = timing_attack.main(["--out", str(out), "--checkpoint", str(ckpt), "--device", "cpu", "--csv", str(csv)])
    assert ckpts == [str(ckpt)]
    assert ckpt.exists() is (not ok)  # kept only to resume a run that did not recover
    assert json.loads(out.read_text()) == art
    assert art["success"] is ok and art["oracle_decisions"] == 123
    assert pd.read_csv(csv)["label"].tolist() == ["timing"]


def test_timing_attack_stats_never_merges_errors(tmp_path, monkeypatch):
    out_dir = tmp_path / "stats"
    out_dir.mkdir()
    old = {"run": "old-run", "param_set": "128", "success": False, "wall_seconds": 1.0, "error": "refused"}
    done = {"run": "done-run", "param_set": "128", "success": True, "wall_seconds": 2.0}
    (out_dir / "timing_old-run.json").write_text(json.dumps(old))
    (out_dir / "timing_done-run.json").write_text(json.dumps(done))

    def refuse(*a, **kw):
        raise RuntimeError("timing calibration refused")

    monkeypatch.setattr(hqc_pkg, "simulate_hqc_idealized_oracle", refuse)
    summary = timing_attack_stats.main(["--out-dir", str(out_dir), "--runs", "128-s2-general", "--device", "cpu"])
    errored = json.loads((out_dir / "timing_128-s2-general.json").read_text())
    assert errored["error"] == "timing calibration refused" and errored["success"] is False
    written = json.loads((out_dir / "summary.json").read_text())
    assert [a["run"] for a in written] == ["done-run"] == [a["run"] for a in summary]

    # the errored run is re-run, and its checkpoint goes once it recovers
    ckpts = []
    monkeypatch.setattr(hqc_pkg, "simulate_hqc_idealized_oracle", _fake_timing_attack(True, ckpts))
    summary = timing_attack_stats.main(["--out-dir", str(out_dir), "--runs", "128-s2-general", "--device", "cpu"])
    assert ckpts == [str(out_dir / "checkpoint_128-s2-general.pkl")] and not Path(ckpts[0]).exists()
    assert sorted(a["run"] for a in summary) == ["128-s2-general", "done-run"]


def test_timing_attack_stats_default_runs_ask_for_the_card(tmp_path, monkeypatch):
    """Without --device every default run decodes on "cuda", the general
    and the circulant ones alike; --device cpu moves them all."""
    asked = {}

    def record(rng, decode_every, weight, keyfile, error_rate, param_set, decode_backend="general",
               device="unset", **kw):
        asked.setdefault(device, []).append(decode_backend)
        raise RuntimeError("stubbed")

    monkeypatch.setattr(hqc_pkg, "simulate_hqc_idealized_oracle", record)
    timing_attack_stats.main(["--out-dir", str(tmp_path / "a")])
    backends = [run[5] for run in timing_attack_stats.DEFAULT_RUNS]
    assert asked == {"cuda": backends} and set(backends) == {"general", "circulant"}
    asked.clear()
    timing_attack_stats.main(["--out-dir", str(tmp_path / "b"), "--device", "cpu"])
    assert asked == {"cpu": backends}
    art = json.loads((tmp_path / "b" / "timing_128-s4-circulant.json").read_text())
    assert art["device"] == "cpu" and art["decode_backend"] == "circulant"


def test_timing_attack_batched_stubbed(tmp_path, monkeypatch):
    def fake_batched(seeds, decode_every, weight, oracle_backend="fast", device="cuda", **kw):
        assert oracle_backend == "timing" and device == "cpu"
        results = []
        for s in seeds:
            tr = HqcSimulationTracking(make_params("128", decode_every, weight))
            tr.num_oracle_calls = s
            results.append((True, tr))
        results[-1] = None
        return results, 5

    monkeypatch.setattr(batched, "simulate_hqc_attacks_batched", fake_batched)
    art = timing_attack_batched.main(["--out", str(tmp_path / "b.json"), "--seeds", "7", "8", "--device", "cpu"])
    assert art["batched_decode_calls"] == 5 and art["keys_recovered"] == 1
    assert art["runs"][0]["oracle_decisions"] == 7 and art["runs"][1]["error"] == "instance died"


# -- profile_trace ------------------------------------------------------------


def test_profile_trace_needs_a_card(tmp_path):
    out = str(tmp_path / "trace.json")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='pass device="cpu"'):
            profile_trace.main(["--out", out])
    with pytest.raises(RuntimeError, match="not a CUDA device"):
        profile_trace.main(["--out", out, "--device", "cpu"])


def test_profile_trace_code_equals_bench():
    from bench import build_code as jax_build_code

    ref, lay = jax_build_code(), profile_trace.build_code()
    assert (lay.n, lay.weight, tuple(lay.shifts), lay.with_identity) == (ref.n, ref.weight, tuple(ref.shifts), True)


def test_profile_trace_device_split():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def evt(name, start, end, dev=cuda):
        return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=start, end=end))

    events = [evt("void circulant_bp_kernel<20, 0, true>(Args)", 0, 40), evt("memset", 35, 50),
              evt("void circulant_bp_kernel<20, 0, true>(Args)", 60, 100), evt("cudaLaunchKernel", 0, 200, cpu)]
    k1, total, span, idle = profile_trace.device_split(events)
    assert (k1, total, span) == pytest.approx((80e-6, 95e-6, 100e-6))
    assert idle == pytest.approx(0.1)  # busy 0-50 and 60-100 of 0-100
    with pytest.raises(RuntimeError, match="no device activity"):
        profile_trace.device_split(events[-1:])
