"""PyTorch port conformance: the CLI (``sca_ldpc_tpu_torch.cli.main``)
against the JAX package's (``tests/test_cli.py``'s cases but the XLA cache's,
with ``--device cpu``), on the CPU.

- Most cases run in process through ``Commands().run(...)``; the unknown
  command, ``official_example``, a computing command without a card and a run
  where jax/pandas/matplotlib/seaborn cannot be imported are subprocesses.
- The parser has exactly the JAX parser's options plus ``--device``.
- The bounded ``hqc_simulate`` writes CSV rows equal to the JAX package's
  ``decoder_stats_data_frame`` on the same seed, key and budget.
- With the library call stubbed in both CLIs, each FER, Kyber and
  ``hqc_eval_oracle`` command passes the JAX command's arguments (the matrix,
  the errors provider, the generator's state, the accuracy) plus
  ``device``, and ``kyber_simulate`` writes the JAX command's CSV bytes.
"""

import logging
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from sca_ldpc_tpu_torch.cli.main import Commands

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KEY = str(ROOT / "fixtures" / "test-hqc128.key")


@pytest.fixture
def cli(caplog):
    """Run the port's CLI in process; returns the log text."""
    root = logging.getLogger()
    level = root.level

    def run(*argv):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            cmds = Commands()
            cmds.run(cmds.parse_arguments(list(argv)))
        return caplog.text

    yield run
    root.setLevel(level)


def run_module(*argv, code=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-c", code] if code else [sys.executable, "-m", "sca_ldpc_tpu_torch.cli.main", *argv]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


def _options(parser):
    """Every option of an argparse parser: names, dest, default, choices,
    nargs, type, required, help, and its mutually exclusive group."""
    groups = {id(a): i for i, g in enumerate(parser._mutually_exclusive_groups) for a in g._group_actions}
    return {
        tuple(a.option_strings) or (a.dest,): (a.dest, a.default, a.choices, a.nargs, a.type, a.required, a.help,
                                               type(a).__name__, groups.get(id(a)))
        for a in parser._actions
    }


def test_parser_equals_jax_plus_device():
    from sca_ldpc_tpu.cli.main import Commands as JaxCommands

    jax_opts, port_opts = _options(JaxCommands()._parser), _options(Commands()._parser)
    device = port_opts.pop(("--device",))
    assert port_opts == jax_opts
    assert device[:3] == ("device", "cuda", None)
    commands = sorted(n[len("command_"):] for n in dir(Commands) if n.startswith("command_"))
    assert commands == sorted(n[len("command_"):] for n in dir(JaxCommands) if n.startswith("command_"))
    assert len(commands) == 13


def test_unknown_command_fails():
    r = run_module("not_a_command", "--device", "cpu")
    assert r.returncode == 1
    assert "Bad command given: not_a_command" in r.stderr


def test_official_example():
    r = run_module("official_example", "--seed", "0", "--runs", "10", "--error-rate", "0.05", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Success ratio 10/10" in r.stderr + r.stdout


def test_computing_command_without_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    r = run_module("official_example", "--seed", "0", "--runs", "10", "--error-rate", "0.05")
    assert r.returncode != 0
    assert 'pass device="cpu"' in r.stderr


@pytest.mark.parametrize("argv", [
    ("official_example", "--runs", "2", "--error-rate", "0.05"),
    ("regular_ldpc_code", "--runs", "2", "--error-rate", "0.01"),
    ("regular_ldpc_code_identity", "--runs", "2", "--error-rate", "0.01"),
    ("qc_ldpc_code", "--runs", "2", "--error-rate", "0.01"),
    ("test_rust_package",),
    ("kyber_simulate", "--runs", "1"),
    ("kyber_simulate", "--runs", "1", "--adaptive"),
    ("hqc_simulate", "--key-file", KEY, "--max-oracle-calls", "10"),
])
def test_default_device_raises_without_card(cli, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        cli(*argv, "--seed", "0")


def test_compute_bound(cli):
    out = cli("compute_bound", "--error-rate", "0.11")
    assert "C, where R = " in out


def test_regular_ldpc_code(cli):
    out = cli("regular_ldpc_code", "--seed", "0", "--runs", "5", "--error-rate", "0.01", "--device", "cpu")
    assert "Success ratio" in out


def test_view_hqc_oracle_accuracy(cli, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cli("view_hqc_oracle_accuracy")
    assert (tmp_path / "OracleAccuracy.png").exists()


def test_hqc_simulate_bounded(cli, tmp_path):
    """Full hqc_simulate argv plumbing (oracle/decode backends, key file,
    CSV output) on a tiny oracle-call budget."""
    csv = str(tmp_path / "stats.csv")
    key = str(tmp_path / "k.key")
    out = cli("hqc_simulate", "--seed", "0", "--key-file", key, "--decode-every", "50", "--code-weight", "20",
              "--max-oracle-calls", "300", "--decode-backend", "padded", "--csv-output", csv, "--device", "cpu")
    assert "Oracle-call budget exhausted" in out or "Successfully decoded" in out
    assert os.path.exists(csv)
    with open(csv) as f:
        header = f.readline().strip().split(",")
    for col in ("label", "alg", "weight", "checks", "oracle_calls", "success"):
        assert col in header


def test_hqc_simulate_csv_equals_jax(cli, tmp_path):
    """The bounded attack's CSV (written twice: header once, rows appended)
    equals the JAX run's ``decoder_stats_data_frame(...).to_csv`` bytes."""
    from sca_ldpc_tpu.models.hqc import simulate_hqc_idealized_oracle as jax_attack
    from sca_ldpc_tpu.utils import make_random_state as jax_random_state

    csv = tmp_path / "stats.csv"
    argv = ("hqc_simulate", "--seed", "0", "--key-file", KEY, "--decode-every", "50", "--max-oracle-calls", "300",
            "--label", "run a", "--csv-output", str(csv), "--device", "cpu")
    out = cli(*argv)
    assert "Oracle-call budget exhausted" in out
    cli(*argv)
    _ok, tracking = jax_attack(jax_random_state(0), 50, 20, KEY, 0.0, "128", max_oracle_calls=300)
    df = tracking.decoder_stats_data_frame(label="run a")
    assert len(df) >= 1
    expected = df.to_csv(index=False) + df.to_csv(index=False, header=False)
    assert csv.read_text() == expected


def test_kyber_simulate_one_run(cli, tmp_path):
    csv = tmp_path / "kyber.csv"
    out = cli("kyber_simulate", "--seed", "1", "--runs", "1", "--error-rate", "0.005", "--label", "k",
              "--csv-output", str(csv), "--device", "cpu")
    assert "Kyber-768: 1/1 full recoveries" in out
    df = pd.read_csv(csv)
    assert list(df.columns) == ["recovered", "correct_coefficients", "total_coefficients", "label", "accuracy"]
    assert df.loc[0, "label"] == "k" and df.loc[0, "accuracy"] == 0.995


def test_kyber_simulate_adaptive(cli, tmp_path):
    csv = tmp_path / "kyber.csv"
    out = cli("kyber_simulate", "--seed", "1", "--runs", "1", "--adaptive", "--csv-output", str(csv),
              "--device", "cpu")
    assert "full recoveries" in out
    # the JAX command has no accuracy in its adaptive branch (a NameError with --csv-output); the port writes 0.995
    assert pd.read_csv(csv).loc[0, "accuracy"] == 0.995


def _plain(value):
    """A stubbed call's argument as comparable data, taken when the call is
    made: a generator's state, an errors provider's fields, an array's
    entries."""
    if isinstance(value, np.random.RandomState):
        return ("rng", _plain(value.get_state()))
    if hasattr(value, "error_distribution"):  # an ErrorsProvider of either package
        return ("errors", value.error_rate, _plain(value.error_distribution), _plain(value.rng))
    if hasattr(value, "toarray"):
        value = value.toarray()
    if isinstance(value, np.ndarray):
        return ("array", value.shape, value.tolist())
    if isinstance(value, (tuple, list)):
        return tuple(_plain(v) for v in value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def _stub_both(monkeypatch, modules, name, result):
    """Replace ``name`` in the JAX and the port module by recorders that
    return ``result``; returns {"jax": [...], "port": [...]} of (args, kwargs)."""
    calls = {}
    for side, module in zip(("jax", "port"), modules):
        def stub(*args, _calls=calls.setdefault(side, []), **kwargs):
            _calls.append((_plain(args), _plain(kwargs)))
            return [dict(r) for r in result] if isinstance(result, list) else result

        monkeypatch.setattr(module, name, stub)
    return calls


def _run_jax(*argv):
    from sca_ldpc_tpu.cli.main import Commands as JaxCommands

    cmds = JaxCommands()
    cmds.run(cmds.parse_arguments(list(argv)))


def _same_call(calls):
    """The port's one call equals the JAX command's, with device "cpu" added."""
    assert len(calls["jax"]) == len(calls["port"]) == 1
    (jax_args, jax_kw), (port_args, port_kw) = calls["jax"][0], calls["port"][0]
    assert port_kw.pop("device") == "cpu"
    assert port_args == jax_args
    assert port_kw == jax_kw


@pytest.mark.parametrize("command, name, result, extra", [
    ("official_example", "simulate_frame_error_rate", 7, ("--error-rate", "0.05")),
    ("regular_ldpc_code", "simulate_frame_error_rate", 7, ("--error-rate", "0.02")),
    ("regular_ldpc_code_identity", "simulate_frame_error_rate", 7, ("--error-rate", "0.02")),
    ("qc_ldpc_code", "simulate_frame_error_rate", 7, ("--error-rate", "0.01")),
    ("test_rust_package", "simulate_frame_error_rate_qary", (7, 0, 0), ("--threads", "4")),
    ("test_rust_package", "simulate_frame_error_rate_qary", (7, 0, 0), ("--error-rate", "0.01")),
])
def test_fer_command_calls_as_jax(cli, monkeypatch, command, name, result, extra):
    """Each FER command builds the JAX command's matrix and errors provider
    from the same seed and passes them, the run count and the generator's
    state to the same library call."""
    import sca_ldpc_tpu.cli.main as jax_main
    import sca_ldpc_tpu_torch.cli.main as port_main

    calls = _stub_both(monkeypatch, (jax_main, port_main), name, result)
    argv = (command, "--seed", "3", "--runs", "10", *extra)
    out = cli(*argv, "--device", "cpu")
    _run_jax(*argv)
    _same_call(calls)
    assert "Success ratio 7/10=0.7" in out


@pytest.mark.parametrize("name, extra", [
    ("simulate_kyber_attack", ()),
    ("simulate_kyber_attack", ("--error-rate", "0.02")),
    ("simulate_kyber_attack_adaptive", ("--adaptive",)),
    ("simulate_kyber_attack_adaptive", ("--adaptive", "--error-rate", "0.01")),
])
def test_kyber_simulate_calls_as_jax(cli, monkeypatch, tmp_path, name, extra):
    """``kyber_simulate`` passes the JAX command's accuracy and attack
    parameters; outside ``--adaptive`` (whose JAX branch cannot write a CSV)
    its CSV bytes equal the JAX command's on the same results."""
    import sca_ldpc_tpu.models.kyber as jax_kyber
    import sca_ldpc_tpu_torch.models.kyber as port_kyber

    results = [{"recovered": True, "correct_coefficients": 768, "total_coefficients": 768},
               {"recovered": False, "correct_coefficients": 701, "total_coefficients": 768}]
    calls = _stub_both(monkeypatch, (jax_kyber, port_kyber), name, results)
    argv = ("kyber_simulate", "--seed", "5", "--runs", "2", "--label", "k", *extra)
    csv = {side: tmp_path / f"{side}.csv" for side in ("jax", "port")}
    csv_argv = {side: () if "--adaptive" in extra else ("--csv-output", str(path)) for side, path in csv.items()}
    out = cli(*argv, *csv_argv["port"], "--device", "cpu")
    _run_jax(*argv, *csv_argv["jax"])
    _same_call(calls)
    assert "Kyber-768: 1/2 full recoveries, avg correct coefficients 734.5/768" in out
    if "--adaptive" not in extra:
        assert csv["port"].read_bytes() == csv["jax"].read_bytes()


def test_hqc_eval_oracle_calls_as_jax(cli, monkeypatch, tmp_path):
    """``hqc_eval_oracle`` passes the JAX command's arguments (it takes no
    device: it measures the host's counter)."""
    import sca_ldpc_tpu.models.hqc.eval_oracle as jax_eval
    import sca_ldpc_tpu_torch.models.hqc.eval_oracle as port_eval

    calls = _stub_both(monkeypatch, (jax_eval, port_eval), "hqc_eval_oracle", [])
    argv = ("hqc_eval_oracle", "--seed", "4", "--key-file", KEY, "--trials", "3", "--max-log2-measurements", "5",
            "--profile-log2", "7", "--reduced-trials", "2", "--reduced-from-log2", "3", "--decision-rule",
            "expansion", "--only-levels", "2", "4", "--state-file", str(tmp_path / "s.json"))
    cli(*argv, "--device", "cpu")
    _run_jax(*argv)
    assert calls["port"] == calls["jax"] and len(calls["jax"]) == 1


def test_test_rust_package_command(cli):
    out = cli("test_rust_package", "--seed", "0", "--device", "cpu")
    assert "Success ratio" in out


def test_qc_ldpc_code_command(cli):
    out = cli("qc_ldpc_code", "--seed", "0", "--runs", "4", "--error-rate", "0.01", "--device", "cpu")
    assert "Success ratio" in out


def test_hqc_eval_oracle_command(cli, tmp_path):
    """hqc_eval_oracle argv plumbing at tiny scale (2 levels x 2 trials,
    2^6-measurement profile), including --decision-rule."""
    csv = tmp_path / "acc.csv"
    state = tmp_path / "state.json"
    cli("hqc_eval_oracle", "--seed", "2", "--key-file", str(tmp_path / "k.key"), "--trials", "2",
        "--max-log2-measurements", "2", "--profile-log2", "6", "--state-file", str(state), "--csv-output", str(csv),
        "--decision-rule", "expansion")
    assert csv.exists() and state.exists()
    assert csv.read_text().startswith("measurements,accuracy")


def test_cli_runs_without_jax_pandas_matplotlib(tmp_path):
    """In a process where jax, pandas, matplotlib and seaborn cannot be
    imported, compute_bound, official_example and a bounded hqc_simulate with
    --csv-output run, and no module of the JAX package is loaded."""
    csv = tmp_path / "stats.csv"
    code = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "pandas", "matplotlib", "seaborn"):
            sys.modules[name] = None
        from sca_ldpc_tpu_torch.cli.main import main
        for argv in (["compute_bound", "--error-rate", "0.11"],
                     ["official_example", "--seed", "0", "--runs", "10", "--error-rate", "0.05", "--device", "cpu"],
                     ["hqc_simulate", "--seed", "0", "--key-file", {KEY!r}, "--decode-every", "50",
                      "--max-oracle-calls", "300", "--csv-output", {str(csv)!r}, "--device", "cpu"]):
            sys.argv = ["main"] + argv
            main()
        leaked = [m for m in sys.modules if m == "sca_ldpc_tpu" or m.startswith("sca_ldpc_tpu.")
                  or (m.split(".")[0] in ("jax", "pandas", "matplotlib", "seaborn") and sys.modules[m] is not None)]
        assert not leaked, leaked
        print("ok")
        """
    )
    r = run_module(code=code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "ok"
    assert "C, where R = " in r.stderr and "Success ratio 10/10" in r.stderr
    assert csv.read_text().startswith("label,alg,weight,epsilon0,epsilon1,checks")
