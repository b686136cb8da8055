"""Attack parameterization and statistics tracking.

Reference: simulate/hqc.py:161-264 (HqcSimulationParams, HqcSimulationTracking).
The CSV schema is kept identical so the reference's visualization pipeline
(and ours, viz/) reads either output:
label, alg, weight, epsilon0, epsilon1, checks, oracle_calls, unsatisfied,
good_flips, bad_flips, found_bad_satisfied_checks,
found_bad_unsatisfied_checks, success.

pandas is imported only by :meth:`HqcSimulationTracking.decoder_stats_data_frame`,
so the attack runs where pandas is not installed.
"""

from enum import Enum
from typing import Tuple


class FlipStatus(Enum):
    UNFLIPPED = 0
    FLIPPED = 1


class IfFlipResult(Enum):
    UNKNOWN = 0
    NOCHANGE = 1
    SUCCESS = 2
    FAILURE = 3


class NoMoreUntestedRmBlocks(Exception):
    pass


class HqcSimulationParams:
    def __init__(
        self,
        HQC,
        OUTER_DECODING_LIMIT: int,
        EPSILON: Tuple[float, float],
        DECODE_EVERY: int,
        WEIGHT: int,
        N_OVERRIDE: int = None,
    ):
        self.HQC = HQC
        self.N = N_OVERRIDE if N_OVERRIDE else HQC.params("N")
        self.N1 = None if N_OVERRIDE else HQC.params("N1")
        self.N2 = None if N_OVERRIDE else HQC.params("N2")
        self.OUTER_DECODING_LIMIT = OUTER_DECODING_LIMIT
        self.EPSILON = EPSILON
        self.DECODE_EVERY = DECODE_EVERY
        self.WEIGHT = WEIGHT

    def __repr__(self):
        return (
            f"N: {self.N}, N1: {self.N1}, N2: {self.N2}"
            f", OUTER_DECODING_LIMIT: {self.OUTER_DECODING_LIMIT}"
            f", EPSILON: {self.EPSILON}, WEIGHT: {self.WEIGHT}"
        )


class HqcSimulationTracking:
    def __init__(self, params: HqcSimulationParams):
        self.num_oracle_calls = 0
        self.params = params
        self.decoder_stats = []
        self.decode_seconds = 0.0  # wall time inside the decodes (host clock, results on the host)
        self.timing_channel = None  # the measured oracle's TimingChannel (oracle_backend="timing")
        self.timing_calibration = None  # its start-of-attack calibration

    def reset_block_status(self):
        self.current_block_nr = None
        self.block_status = [
            {"status": FlipStatus.UNFLIPPED, "result": IfFlipResult.UNKNOWN}
            for _ in range(self.params.N1)
        ]

    def set_current_block_nr(self, current_block_nr):
        self.current_block_nr = current_block_nr
        if "bits" not in self.block_status[current_block_nr]:
            self.block_status[current_block_nr]["bits"] = [
                {"status": FlipStatus.UNFLIPPED, "result": IfFlipResult.UNKNOWN}
                for _ in range(self.params.N2)
            ]

    def current_block(self):
        return self.block_status[self.current_block_nr]

    def current_bits_status(self):
        return self.current_block()["bits"]

    def add_decoder_stats(
        self,
        checks,
        unsatisfied,
        good_flips,
        bad_flips,
        found_bad_satisfied_checks,
        found_bad_unsatisfied_checks,
        success,
    ):
        self.decoder_stats.append(
            {
                "checks": checks,
                "oracle_calls": self.num_oracle_calls,
                "unsatisfied": unsatisfied,
                "good_flips": good_flips,
                "bad_flips": bad_flips,
                "found_bad_satisfied_checks": found_bad_satisfied_checks,
                "found_bad_unsatisfied_checks": found_bad_unsatisfied_checks,
                "success": success,
            }
        )

    def decoder_stats_data_frame(self, label=""):
        import pandas as pd

        static_columns = ["label", "alg", "weight", "epsilon0", "epsilon1"]
        static_values = [
            label,
            self.params.HQC.name(),
            self.params.WEIGHT,
            self.params.EPSILON[0],
            self.params.EPSILON[1],
        ]
        df = pd.DataFrame.from_dict(self.decoder_stats)
        dynamic_columns = list(df.columns)
        df[static_columns] = static_values
        return df[static_columns + dynamic_columns]
