"""CSV analysis and plotting of attack statistics (``view_*`` commands of the
CLI); needs pandas, matplotlib and seaborn."""

from .plots import (
    load_data,
    view_hqc_oracle_accuracy,
    view_hqc_simulation_csv,
    wide_to_long_format,
)

__all__ = [
    "load_data",
    "view_hqc_oracle_accuracy",
    "view_hqc_simulation_csv",
    "wide_to_long_format",
]
