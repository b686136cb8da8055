"""PyTorch port conformance: the plots' data pipeline
(``sca_ldpc_tpu_torch.viz``), ``tests/test_viz.py``'s cases on the port, and
``wide_to_long_format`` / ``load_data`` equal to the JAX package's frames on
the same CSV."""

import pandas as pd
import pytest
from pandas.testing import assert_frame_equal

from sca_ldpc_tpu import viz as jax_viz
from sca_ldpc_tpu_torch.viz import load_data, wide_to_long_format
from sca_ldpc_tpu_torch.viz.plots import REFERENCE_ORACLE_ACCURACY, round_stride_of_type


def _sample_wide(tmp_path):
    rows = []
    for i, (checks, calls, good, bad) in enumerate(
        [(100, 1000, 10, 2), (200, 2100, 30, 1), (300, 3300, 66, 0)]
    ):
        rows.append(
            {
                "label": "t", "alg": "hqc-128", "weight": 20,
                "epsilon0": 0.9942, "epsilon1": 1.0,
                "checks": checks, "oracle_calls": calls, "unsatisfied": 40 + i,
                "good_flips": good, "bad_flips": bad,
                "found_bad_satisfied_checks": 1, "found_bad_unsatisfied_checks": 2,
                "success": i == 2,
            }
        )
    df = pd.DataFrame(rows)
    p = tmp_path / "stats.csv"
    df.to_csv(p, index=False)
    return p, df


def _with_derived(df):
    df = df.copy()
    df["remaining-flips"] = df["good_flips"].max() + df["bad_flips"] - df["good_flips"]
    df["found_bad_checks"] = df["found_bad_unsatisfied_checks"] + df["found_bad_satisfied_checks"]
    return df


def test_wide_to_long_shape(tmp_path):
    _p, df = _sample_wide(tmp_path)
    long = wide_to_long_format(_with_derived(df))
    # 3 stride types x 6 count types x 3 rows
    assert len(long) == 3 * 6 * 3
    assert set(long["stride_type"].cat.categories) == {"checks", "oracle_calls", "unsatisfied"}
    # derived column semantics (visualize.py:106-111)
    rem = long.query("stride_type == 'checks' and count_type == 'remaining-flips'")
    assert sorted(rem["count"]) == [0, 37, 58]  # 66+2-10, 66+1-30, 66+0-66


def test_load_data_rounds_strides(tmp_path):
    p, _ = _sample_wide(tmp_path)
    long = load_data(str(p))
    calls = long.query("stride_type == 'oracle_calls'")["stride"].unique()
    # oracle_calls rounded to multiples of 500 (visualize.py:116)
    assert all(c % 500 == 0 for c in calls)
    unsat = long.query("stride_type == 'unsatisfied'")["stride"].unique()
    assert all(u % 20 == 0 for u in unsat)


def test_round_stride_of_type():
    df = pd.DataFrame({"stride_type": ["oracle_calls", "checks"], "stride": [1749, 1749]})
    df["stride_type"] = df["stride_type"].astype("category")
    out = round_stride_of_type(df.copy(), "oracle_calls", 500)
    assert out.loc[0, "stride"] == 1500  # (1749+250)//500*500
    assert out.loc[1, "stride"] == 1749  # untouched


def test_reference_accuracy_curve_shape():
    assert len(REFERENCE_ORACLE_ACCURACY) == 17
    assert REFERENCE_ORACLE_ACCURACY[0] == 0.0
    assert max(REFERENCE_ORACLE_ACCURACY) <= 1.0
    assert REFERENCE_ORACLE_ACCURACY == jax_viz.plots.REFERENCE_ORACLE_ACCURACY


@pytest.mark.parametrize("fn", ["wide_to_long_format", "load_data"])
def test_frames_equal_jax(tmp_path, fn):
    p, df = _sample_wide(tmp_path)
    if fn == "load_data":
        port, ref = load_data(str(p)), jax_viz.load_data(str(p))
    else:
        port, ref = wide_to_long_format(_with_derived(df)), jax_viz.wide_to_long_format(_with_derived(df))
    assert_frame_equal(port, ref)


def test_view_hqc_simulation_csv_writes_plots(tmp_path, monkeypatch):
    from sca_ldpc_tpu_torch.viz import view_hqc_simulation_csv

    p, _ = _sample_wide(tmp_path)
    monkeypatch.chdir(tmp_path)
    view_hqc_simulation_csv(str(p), "hqc-128")
    for name in ("BoxPlotSuccessChecksVsWeight", "BoxPlotSuccessOracleCalls", "BoxPlotSuccessParityChecks"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0
