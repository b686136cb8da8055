"""PyTorch port conformance: the last scripts (``sca_ldpc_tpu_torch.scripts``)
against the JAX package's, on the CPU.

- ``kyber_curve`` and ``kyber_noise_curve``: the CSV's bytes equal to the JAX
  script's for the same small argv, both run in this process;
- ``kyber_crossvalidate``: the artifact equal to the JAX script's apart from
  the timings, at ``--runs 1``; the float64 enumeration model equal to the
  JAX script's on the same channels;
- ``hqc192_diagnostics``: ``--phases A`` equal to the JAX script's at small
  sample counts; phases B and C over the modelled cycle counter
  (``tools/attack_cells.ModelledClock``): the artifact's keys, a ladder whose
  steps are the modelled expansion cost;
- ``fer_curve``: the copied reference decode equal to the JAX benchmark's
  ``cpu_reference_decode``; a small run through both backends writes its
  rows.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from sca_ldpc_tpu_torch.scripts import (
    fer_curve,
    hqc192_diagnostics,
    kyber_crossvalidate,
    kyber_curve,
    kyber_noise_curve,
    profile_trace,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _jax_script(name, monkeypatch, argv):
    """Run the JAX package's ``scripts/<name>.py`` in this process with
    ``argv``; returns the module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()
    return mod


def test_kyber_curve_csv_equals_jax(tmp_path, monkeypatch):
    argv = ["--runs", "1", "--accuracies", "0.995", "0.9", "--num-patterns", "3", "7"]
    _jax_script("kyber_curve", monkeypatch, ["--out", str(tmp_path / "jax.csv"), *argv, "--platform", "cpu"])
    rows = kyber_curve.main(["--out", str(tmp_path / "port.csv"), *argv, "--device", "cpu"])
    jax_csv, port_csv = ((tmp_path / f).read_bytes() for f in ("jax.csv", "port.csv"))
    assert port_csv == jax_csv and len(rows) == 2
    assert [r["recovered"] for r in rows] == [True, False]
    assert kyber_curve.secret_entropy(2) == pytest.approx(2.0306, abs=1e-4)


def test_kyber_noise_curve_csv_equals_jax(tmp_path, monkeypatch):
    argv = ["--runs", "2", "--accuracies", "0.995"]
    _jax_script("kyber_noise_curve", monkeypatch, ["--out", str(tmp_path / "jax.csv"), *argv, "--platform", "cpu"])
    rows = kyber_noise_curve.main(["--out", str(tmp_path / "sub" / "port.csv"), *argv, "--device", "cpu"])
    assert (tmp_path / "sub" / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert len(rows) == 17 and not (tmp_path / "sub" / "port.csv.tmp").exists()
    assert list(pd.read_csv(tmp_path / "sub" / "port.csv")["config"]) == [r["config"] for r in rows]


def test_kyber_crossvalidate_artifact_equals_jax(tmp_path, monkeypatch):
    _jax_script("kyber_crossvalidate", monkeypatch, ["--runs", "1", "--out", str(tmp_path / "jax.json")])
    port = kyber_crossvalidate.main(["--runs", "1", "--out", str(tmp_path / "port.json"), "--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == port
    for art in (ref, port):
        for row in art["runs"]:
            del row["t_ours_s"], row["t_enum_s"]
    assert port == ref
    assert port["runs"][0]["agreement"] == port["runs"][0]["n"] == 768  # the two decoders agree


def test_enum_special_decoder_equals_jax_scripts(monkeypatch):
    """The copied float64 model decodes a small regular [H'|I] code as the
    JAX script's does (the same d-grid arithmetic)."""
    spec = importlib.util.spec_from_file_location("jax_kyber_xval", ROOT / "scripts" / "kyber_crossvalidate.py")
    jax_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_mod)
    rng = np.random.RandomState(4)
    nb, r, sw, b = 16, 8, 3, 1
    H = np.zeros((r, nb + r), np.int8)
    for i in range(r):
        H[i, rng.choice(nb, sw, replace=False)] = rng.choice([-1, 1], sw)
        H[i, nb + i] = rng.choice([-1, 1])
    ch = rng.dirichlet(np.ones(2 * b + 1), nb)
    ch_sum = rng.dirichlet(np.ones(2 * sw * b + 1), r)
    args = (H, b, sw * b, 4)
    got = kyber_crossvalidate.EnumSpecialDecoder(*args).min_sum(ch, ch_sum, clip=1e4)
    np.testing.assert_array_equal(got, jax_mod.EnumSpecialDecoder(*args).min_sum(ch, ch_sum, clip=1e4))


def test_hqc192_diagnostics_phase_a_equals_jax(tmp_path, monkeypatch):
    argv = ["--phases", "A", "--param-set", "128", "--garbage-samples", "512", "--search-samples", "1024"]
    _jax_script("hqc192_diagnostics", monkeypatch, [*argv, "--out", str(tmp_path / "jax.json")])
    art = hqc192_diagnostics.main([*argv, "--out", str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert art["A_structure"]["four_expansion_hits"] == 0 and art["A_structure"]["max_extra_observed"] <= 3


def test_hqc192_diagnostics_phases_b_c_over_a_modelled_clock(tmp_path):
    from sca_ldpc_tpu_torch.models.hqc import Hqc128
    from sca_ldpc_tpu_torch.tools.attack_cells import ModelledClock

    with ModelledClock(Hqc128, 0) as clock:
        art = hqc192_diagnostics.main(["--phases", "BC", "--param-set", "128", "--profile-measurements", "64",
                                       "--chunks", "16", "32", "--measure-levels", "16", "32", "--trials", "3",
                                       "--out", str(tmp_path / "bc.json")])
    assert json.loads((tmp_path / "bc.json").read_text()) == art and "A_structure" not in art
    assert art["per_expansion_cost_cycles"] == pytest.approx(clock.cost, rel=0.5)
    assert [row["chunk"] for row in art["B_class_ladder"]] == [16, 32]
    for row in art["B_class_ladder"]:
        assert set(row["levels_vs_extra0"]) == {"0", "1", "2", "3"} and len(row["per_expansion_increments"]) == 3
        assert all(inc == pytest.approx(clock.cost, rel=0.5) for inc in row["per_expansion_increments"])
    assert [row["measure"] for row in art["C_decision_accuracy"]] == [16, 32]
    for row in art["C_decision_accuracy"]:
        assert 0 <= row["acc_fail"] <= 1 and 0 <= row["acc_success"] <= 1
        assert row["median_diff_fail"] < -row["margin_cycles"] < row["median_diff_success"]


def test_fer_curve_reference_decode_equals_bench():
    from bench import build_code as jax_build_code
    from bench import cpu_reference_decode as jax_reference

    jax_lay = jax_build_code(n=127, weight=3)
    lay = profile_trace.build_code(n=127, weight=3)
    assert tuple(lay.shifts) == tuple(jax_lay.shifts)
    rng = np.random.RandomState(0)
    prior = np.log((1 - 0.03) / 0.03) * np.ones(254)
    prior[::7] *= 0.5
    for _ in range(6):
        e = (rng.rand(254) < 0.03).astype(int)
        syn = (sum(np.roll(e[:127], k) for k in lay.shifts) + e[127:]) % 2
        got, it = fer_curve.cpu_reference_decode(lay, prior, syn, 20)
        ref, it_ref = jax_reference(jax_lay, prior, syn, 20)
        assert it == it_ref and np.array_equal(got, ref)


@pytest.mark.parametrize("backend", ["fused", "decode"])
def test_fer_curve_runs_on_the_cpu(tmp_path, backend):
    out = tmp_path / "fer.csv"
    rows = fer_curve.main(["--out", str(out), "--runs", "8", "--cpu-runs", "1", "--rates", "0.01", "0.02",
                           "--backend", backend, "--device", "cpu"])
    df = pd.read_csv(out)
    assert list(df.columns) == ["error_rate", "gpu_fer", "gpu_frames", "cpu_fer", "cpu_frames"]
    assert list(df["error_rate"]) == [0.01, 0.02] and list(df["gpu_frames"]) == [8, 8] and len(rows) == 2
    assert df["gpu_fer"].between(0, 1).all() and df["gpu_fer"].iloc[0] == 0.0


@pytest.mark.parametrize("script, argv", [
    ("fer_curve", ["--runs", "8", "--cpu-runs", "1", "--rates", "0.01"]),
    ("multihost_fer", ["--runs", "8", "--n", "31", "--code-weight", "3"]),
    ("kyber_curve", ["--runs", "1", "--accuracies", "0.995"]),
    ("kyber_noise_curve", ["--runs", "2", "--accuracies", "0.995"]),
    ("kyber_crossvalidate", ["--runs", "1"]),
])
def test_scripts_default_to_the_card(tmp_path, monkeypatch, script, argv):
    """Without --device the scripts decode on the card; without one they
    raise before any decode, never falling back to the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"sca_ldpc_tpu_torch.scripts.{script}")
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        mod.main(argv)
