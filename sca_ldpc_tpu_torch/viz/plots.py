"""CSV analysis and plotting of attack statistics.

Reference: simulate/visualize.py (the JAX package's ``viz/plots.py``; no
framework code: pandas, matplotlib and seaborn on the host).  Same CSV
schema, same wide->long reshaping, same plot families (box plots of
checks/oracle-calls to success, remaining-bit-flips line plot,
oracle-accuracy curve).  Output defaults to
PNG via the Agg backend; PGF/LaTeX output (the reference's default,
visualize.py:13-26) is opt-in via ``use_pgf=True`` since it needs a LaTeX
toolchain.
"""

import logging

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import pandas as pd  # noqa: E402

logger = logging.getLogger(__name__)

GRID_WEIGHTS = False

META_COL = ["label", "alg", "weight", "epsilon0", "epsilon1"]
STRIDES = ["checks", "oracle_calls", "unsatisfied"]
COUNTS = [
    "good_flips",
    "bad_flips",
    "found_bad_satisfied_checks",
    "found_bad_unsatisfied_checks",
    "remaining-flips",
    "found_bad_checks",
]


def use_pgf():
    matplotlib.use("pgf")
    matplotlib.rcParams.update(
        {
            "pgf.texsystem": "lualatex",
            "font.family": "serif",
            "text.usetex": True,
            "pgf.rcfonts": False,
        }
    )


def plt_write(outputname="output.png"):
    w = 4.8
    plt.gcf().set_size_inches(w=w, h=w)
    plt.tight_layout()
    plt.savefig(outputname, bbox_inches="tight", dpi=150)
    logger.info("Output printed to " + outputname)
    plt.close("all")


def wide_to_long_format(df: pd.DataFrame) -> pd.DataFrame:
    """(stride_type, stride, count_type, count) long format
    (visualize.py:59-99)."""
    frames = []
    for stride in STRIDES:
        for count in COUNTS:
            part = df[META_COL + [stride, count, "success"]].copy()
            part = part.rename(columns={stride: "stride", count: "count"})
            part["stride_type"] = stride
            part["count_type"] = count
            frames.append(part)
    out = pd.concat(frames, ignore_index=True)
    for c in ["label", "alg", "stride_type", "count_type", "success", "epsilon0", "epsilon1"]:
        out[c] = out[c].astype("category")
    for c in ["weight", "stride", "count"]:
        out[c] = out[c].astype(int)
    return out


def round_stride_of_type(df, stride_type, multiple_of):
    cond = df["stride_type"] == stride_type
    half = multiple_of // 2
    df.loc[cond, "stride"] = (
        ((df.loc[cond, "stride"] + half) / multiple_of).astype(int) * multiple_of
    )
    return df


def load_data(csv_file) -> pd.DataFrame:
    """CSV -> long format with derived columns (visualize.py:102-119)."""
    logger.info(f"Reading file: {csv_file}")
    df = pd.read_csv(csv_file)
    max_flips = df["good_flips"].max()
    df["remaining-flips"] = max_flips + df["bad_flips"] - df["good_flips"]
    df["found_bad_checks"] = (
        df["found_bad_unsatisfied_checks"] + df["found_bad_satisfied_checks"]
    )
    df = wide_to_long_format(df)
    df = round_stride_of_type(df, "oracle_calls", 500)
    df = round_stride_of_type(df, "unsatisfied", 20)
    return df


EPSILON_LABELS = {
    # oracle-accuracy -> display label (the reference maps to LaTeX macros,
    # visualize.py:142-149; plain-text here, LaTeX only under use_pgf)
    "0.89478": "O_HQC^0.9",
    "0.9444899999999999": "O_HQC^0.95",
    "0.9892289999999999": "O_HQC^0.995",
    "0.9942": "O_HQC^ideal",
    "1.0": "O_HQC^1.0",
    "miss-use": "O_HQC^1.0",
}


def hqc_csv_rename_human_readable(df):
    """Category renames for plot axes (visualize.py:122-169)."""
    df = df.copy()
    df["stride_type"] = df["stride_type"].cat.rename_categories(
        {
            "checks": "parity checks",
            "oracle_calls": "oracle calls",
            "unsatisfied": "unsatisfied parity checks",
        }
    )
    df["count_type"] = df["count_type"].cat.rename_categories(
        {
            "good_flips": "correct bit-flips",
            "bad_flips": "incorrect bit-flips",
            "remaining-flips": "remaining bit-flips",
            "found_bad_checks": "detected bad parity checks",
        }
    )
    mapped = df["epsilon0"].astype(str).map(lambda v: EPSILON_LABELS.get(v, v))
    df["epsilon0"] = mapped.astype("category")
    return df


def _success_filter(df, stride_type):
    w = "weight % 10 == 0" if GRID_WEIGHTS else "weight == weight"
    return df.query(
        w
        + f" and stride_type == '{stride_type}' and count_type == 'remaining-flips'"
        + " and success == True"
    )


class Plotter:
    def __init__(self, df: pd.DataFrame, outputname):
        self.logger = logging.getLogger(self.__class__.__name__)
        df = self.filter_data(df)
        self.plot(df)
        if outputname:
            plt_write(outputname)

    def filter_data(self, df):
        return df

    def plot(self, df):
        pass


class BoxPlotSuccessChecksVsWeight(Plotter):
    """Checks-to-success by code weight (visualize.py:202-229)."""

    def filter_data(self, df):
        return _success_filter(df, "checks")

    def plot(self, df):
        import seaborn as sns

        sns.catplot(
            data=df, x="stride", y="weight", row="alg", orient="h", kind="box",
            palette="cubehelix_r", linewidth=0.1, fliersize=1,
        ).set_axis_labels("parity checks", "column weight")


class LinePlotChecksRemainingBitFlips(Plotter):
    """Remaining bit-flips vs checks (visualize.py:231-250)."""

    def filter_data(self, df):
        return df.query(
            "stride_type == 'checks' and count_type == 'remaining-flips'"
        )

    def plot(self, df):
        import seaborn as sns

        sns.relplot(
            data=df, x="stride", y="count", hue="epsilon0", kind="line",
            palette="colorblind",
        ).set_axis_labels("Parity checks", "Remaining bit-flips")


class BoxPlotSuccessOracleCalls(Plotter):
    """Oracle calls to success (visualize.py:253-278)."""

    def filter_data(self, df):
        return _success_filter(df, "oracle_calls")

    def plot(self, df):
        import seaborn as sns

        sns.catplot(
            data=df, x="stride", y="epsilon0", row="alg", orient="h", kind="box",
            palette="colorblind", linewidth=0.1, fliersize=1,
        ).set_axis_labels("Oracle calls", "")


class BoxPlotSuccessParityChecks(Plotter):
    """Parity checks to success (visualize.py:281-306)."""

    def filter_data(self, df):
        return _success_filter(df, "checks")

    def plot(self, df):
        import seaborn as sns

        sns.catplot(
            data=df, x="stride", y="epsilon0", row="alg", orient="h", kind="box",
            palette="colorblind", linewidth=0.1, fliersize=1,
        ).set_axis_labels("Parity checks", "")


class DescribeData(Plotter):
    """Summary statistics (visualize.py:308-317)."""

    def filter_data(self, df):
        return _success_filter(df, "checks")

    def plot(self, df):
        if len(df):
            desc = df.groupby(
                ["alg", "epsilon0", "weight", "stride_type"], observed=True
            )["stride"].describe()
            self.logger.info(f"Describe data: \n{desc}")


def view_hqc_simulation_csv(csv_file, alg=None):
    df = load_data(csv_file)
    DescribeData(df, None)
    BoxPlotSuccessChecksVsWeight(df, "BoxPlotSuccessChecksVsWeight.png")
    BoxPlotSuccessOracleCalls(df, "BoxPlotSuccessOracleCalls.png")
    BoxPlotSuccessParityChecks(df, "BoxPlotSuccessParityChecks.png")


# Timing-oracle accuracy measured on the reference's laptop (visualize.py:
# 391-413, commit 00c3c65) — kept as the published comparison curve.
REFERENCE_ORACLE_ACCURACY = [
    0.0, 0.75, 0.936, 0.951, 0.973, 0.979, 0.972, 0.977, 0.98,
    0.987, 0.992, 0.996, 0.992, 0.995, 0.99, 0.993, 0.989,
]


def view_hqc_oracle_accuracy(measured=None, outputname="OracleAccuracy.png",
                             measured_quiet=None):
    """Accuracy-vs-measurements curve; overlays our measured data on the
    reference's published curve when given (visualize.py:343-424).

    ``measured_quiet``: optional quiet-window decomposition (round-5
    condition covariate) plotted as a third series — the reference's curve
    is single-condition idle-laptop, so the quiet column is the
    apples-to-apples comparison."""
    import seaborn as sns

    acc = REFERENCE_ORACLE_ACCURACY
    rows = [
        {"Measurements": 2**i, "Accuracy": a, "Legend": "reference"}
        for i, a in enumerate(acc)
    ]
    if measured:
        rows += [
            {"Measurements": m, "Accuracy": a, "Legend": "this framework"}
            for m, a in sorted(measured.items())
        ]
    if measured_quiet:
        rows += [
            {"Measurements": m, "Accuracy": a,
             "Legend": "this framework (quiet windows)"}
            for m, a in sorted(measured_quiet.items())
        ]
    df = pd.DataFrame(rows)
    df = df[df["Measurements"] >= 0]
    g = sns.lineplot(data=df, x="Measurements", y="Accuracy", hue="Legend",
                     palette="colorblind")
    g.axes.set_xscale("log", base=2)
    g.set(ylim=(0.0, 1.0))
    plt_write(outputname)
