"""PyTorch port: the timing-oracle evaluation ``hqc_eval_oracle``
(``models/hqc/eval_oracle.py``), on the CPU.

These run the real native pipeline at tiny measurement counts, as
``tests/test_eval_oracle.py`` runs the JAX package's: they hold the sweep's
checkpoint/resume and trial-schedule mechanics, not accuracy values (cycle
timing is not reproducible run to run, so the two packages' accuracies are
not compared).  The port does not copy one defect of the JAX package: a
discarded trial (no usable samples) adds nothing to the load covariate.
"""

import json
import threading

import pytest
import torch

from sca_ldpc_tpu.models.hqc import eval_oracle as jeval
from sca_ldpc_tpu_torch.models.hqc import eval_oracle
from sca_ldpc_tpu_torch.models.hqc.eval_oracle import hqc_eval_oracle
from sca_ldpc_tpu_torch.utils import make_random_state

torch.set_num_threads(1)

TINY = dict(max_log2_measurements=2, profile_measurements=2**6)


def _state(path):
    with open(path) as f:
        return json.load(f)


def test_eval_oracle_checkpoint_and_resume(tmp_path):
    state_file, key_file = str(tmp_path / "state.json"), str(tmp_path / "key.key")
    results = hqc_eval_oracle(make_random_state(3), keyfile=key_file, num_trials=3, state_file=state_file, **TINY)
    assert sorted(results) == [1, 2] and all(0.0 <= a <= 1.0 for a in results.values())
    state = _state(state_file)
    assert state["levels"]["1"]["done"] == 3 and state["levels"]["2"]["done"] == 3
    threshold = state["threshold"]

    # a higher trial target resumes: no profiling (same threshold), tallies continue
    results2 = hqc_eval_oracle(make_random_state(4), keyfile=key_file, num_trials=5, state_file=state_file, **TINY)
    state2 = _state(state_file)
    assert state2["threshold"] == threshold and sorted(results2) == [1, 2]
    assert state2["levels"]["1"]["done"] == 5 and state2["levels"]["2"]["done"] == 5

    # levels >= 2**reduced_from_log2 take the reduced target
    results3 = hqc_eval_oracle(make_random_state(5), keyfile=key_file, num_trials=5, max_log2_measurements=3,
                               profile_measurements=2**6, reduced_trials=2, reduced_from_log2=2,
                               state_file=state_file)
    state3 = _state(state_file)
    assert state3["levels"]["1"]["done"] == 5 and state3["levels"]["4"]["done"] == 2
    assert sorted(results3) == [1, 2, 4]

    for kw, match in (({"trial_mode": "threshold"}, "trial_mode"), ({"chunk_cap": 64}, "chunk_cap")):
        with pytest.raises(ValueError, match=match):
            hqc_eval_oracle(make_random_state(6), keyfile=key_file, num_trials=1, max_log2_measurements=1,
                            profile_measurements=2**6, state_file=state_file, **kw)
    state3["key_fingerprint"] = "0" * 64
    with open(state_file, "w") as f:
        json.dump(state3, f)
    with pytest.raises(ValueError, match="keypair"):
        hqc_eval_oracle(make_random_state(6), keyfile=key_file, num_trials=1, max_log2_measurements=1,
                        profile_measurements=2**6, state_file=state_file)
    del state3["trial_mode"]
    with open(state_file, "w") as f:
        json.dump(state3, f)
    with pytest.raises(ValueError, match="predates"):
        hqc_eval_oracle(make_random_state(6), keyfile=key_file, num_trials=1, max_log2_measurements=1,
                        profile_measurements=2**6, state_file=state_file)
    with pytest.raises(ValueError, match="match no sweep level"):
        hqc_eval_oracle(make_random_state(6), keyfile=key_file, num_trials=1, only_levels=[3], **TINY)


def test_eval_oracle_incremental_csv(tmp_path):
    csv_file = str(tmp_path / "curve.csv")
    results = hqc_eval_oracle(make_random_state(9), keyfile=str(tmp_path / "key.key"), num_trials=3,
                              state_file=str(tmp_path / "state.json"), checkpoint_every=1, csv_output=csv_file, **TINY)
    with open(csv_file) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "measurements,accuracy,trials,decaps_per_decision,quiet_accuracy,quiet_trials,mean_loadavg"
    rows = [ln.split(",") for ln in lines[1:]]
    assert [int(r[0]) for r in rows] == [1, 2]
    for r in rows:
        assert float(r[1]) == pytest.approx(results[int(r[0])])
        assert int(r[2]) == 3 and int(r[3]) == 2 * int(r[0])  # differential: 2 x measure decaps a decision
        assert 0 <= (int(r[5]) if r[5] else 0) <= 3 and float(r[6]) >= 0.0


def test_eval_oracle_reference_modes(tmp_path):
    results = hqc_eval_oracle(make_random_state(8), keyfile=str(tmp_path / "key.key"), num_trials=2,
                              profile_mode="sequential", trial_mode="threshold", **TINY)
    assert sorted(results) == [1, 2] and all(0.0 <= a <= 1.0 for a in results.values())


@pytest.mark.parametrize("mod", [eval_oracle, jeval], ids=["port", "jax"])
def test_discarded_trials_add_no_load_covariate(tmp_path, monkeypatch, mod):
    """Trials whose measurements left no samples are discarded: the port's
    covariate (load_sum, load_counted) counts only trials with an outcome,
    as the quiet columns do; the JAX package's counts the discarded ones too."""
    state_file, key_file = str(tmp_path / "state.json"), str(tmp_path / "key.key")
    mod.hqc_eval_oracle(make_random_state(3), keyfile=key_file, num_trials=2, state_file=state_file, **TINY)
    before = _state(state_file)["levels"]
    monkeypatch.setattr(mod, "_measure_interleaved", lambda *a, **k: [None, None])
    monkeypatch.setattr(mod, "_loadavg", lambda: 0.5)
    mod.hqc_eval_oracle(make_random_state(4), keyfile=key_file, num_trials=5, state_file=state_file, **TINY)
    after = _state(state_file)["levels"]
    for level in ("1", "2"):
        assert after[level]["done"] == 5 and after[level]["counted"] == before[level]["counted"]
        added = after[level]["load_counted"] - before[level]["load_counted"]
        assert added == (0 if mod is eval_oracle else 3)
        if mod is eval_oracle:
            assert after[level]["load_counted"] == after[level]["counted"]
            assert after[level]["load_sum"] == before[level]["load_sum"]


def test_measurement_lock_is_process_wide_and_reentrant():
    assert isinstance(eval_oracle.MEASUREMENT_LOCK, type(threading.RLock()))
    with eval_oracle.MEASUREMENT_LOCK:
        with eval_oracle.MEASUREMENT_LOCK:  # the interleaved block re-enters it through oracle()
            pass
