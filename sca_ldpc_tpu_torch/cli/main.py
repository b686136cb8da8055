#!/bin/env python
"""Command-line entry point with the reference's full command surface
(reference: simulate-with-python/main.py; the JAX package's ``cli/main.py``:
the same 13 commands, the same flags, plus ``--device``).

Usage: python -m sca_ldpc_tpu_torch.cli.main <command> [flags]

The computing commands run on the card (``--device cuda``, the default) and
raise without one; ``--device cpu`` runs them on the CPU.  ``compute_bound``
and the ``view_*`` commands touch no device; ``hqc_eval_oracle`` measures the
host's cycle counter.  pandas, matplotlib and seaborn are imported only by
the ``view_*`` commands, so every other command runs without them.
"""

import argparse
import logging
import sys
from os.path import exists

import numpy as np

from ..channels import ErrorsProvider
from ..codes.util import rep_code
from ..codes import (
    make_qc_parity_check_matrix,
    make_regular_ldpc_parity_check_matrix,
    make_regular_ldpc_parity_check_matrix_identity,
)
from ..sim import simulate_frame_error_rate, simulate_frame_error_rate_qary
from ..utils import make_random_state
from ..utils.commands import CommandsBase
from ..utils.table import append_csv, table, text_table, with_columns

logger = logging.getLogger("main")


class Commands(CommandsBase):
    """All commands of the simulator (reference: main.py:52-319)."""

    PREFIX = "command_"

    def setup_arguments(self, parser: argparse.ArgumentParser):
        parser.add_argument("--seed", type=int, required=False,
                            help="Use a fixed seed to make simulations reproducible.")
        parser.add_argument("--runs", type=int, default=100,
                            help="The number of runs for non-deterministic simulations.")
        parser.add_argument("--decode-every", type=int, default=500,
                            help="Try to decode every 'decode-every' added data points.")
        parser.add_argument("--key-file", type=str,
                            help="Serialized key location; created with a random key if missing "
                                 "(independent of --seed).")
        parser.add_argument("--csv-output", type=str,
                            help="Write decoding stats to the specified csv file")
        parser.add_argument("--code-weight", type=int, default=20,
                            help="Column weight for constructed LDPC codes in HQC simulations")
        parser.add_argument("--label", type=str,
                            help="Label added to csv output to distinguish runs")
        parser.add_argument("--param-set", type=str, default="128",
                            help="HQC parameter set: 128, 192 or 256.")
        parser.add_argument("--threads", type=int, default=4,
                            help="Decode batch parallelism (the reference's thread count maps "
                                 "to the device batch axis)")
        parser.add_argument("--oracle-backend", type=str, default="fast",
                            choices=["fast", "native", "timing"],
                            help="HQC oracle: 'fast' = incremental Walsh-spectrum updates "
                                 "(one decapsulation per plaintext, cross-checked), "
                                 "'native' = decapsulate per query like the reference, "
                                 "'timing' = answer every query from MEASURED decapsulation "
                                 "timing (the real rejection-sampling side channel; "
                                 "epsilon calibrated in-run)")
        parser.add_argument("--timing-measure", type=int, default=64,
                            help="timing oracle: cycle-timed decapsulations per class per "
                                 "measurement decision (differential costs 2x this)")
        parser.add_argument("--timing-calibration-trials", type=int, default=100,
                            help="timing oracle: trials per class when calibrating "
                                 "per-measurement accuracy (the attack's EPSILON)")
        parser.add_argument("--decode-backend", type=str, default="general",
                            choices=["general", "padded", "circulant"],
                            help="Attack decode: 'general' = checks-only [H|I] per size "
                                 "bucket; 'padded' = same decode at a fixed check "
                                 "capacity, ONE compile shape for the whole attack; "
                                 "'circulant' = full circulant with measured-row "
                                 "mask, one compile shape per plaintext count "
                                 "(fastest on TPU)")
        parser.add_argument("--trials", type=int, default=1000,
                            help="hqc_eval_oracle: trials per measurement count")
        parser.add_argument("--reduced-trials", type=int, default=None,
                            help="hqc_eval_oracle: fewer trials for measurement counts "
                                 ">= 2**reduced-from-log2 (accuracy saturates there)")
        parser.add_argument("--reduced-from-log2", type=int, default=13,
                            help="hqc_eval_oracle: level where --reduced-trials kicks in")
        parser.add_argument("--only-levels", type=int, nargs="+", default=None,
                            help="hqc_eval_oracle: re-measure only these "
                                 "measurement counts (others untouched)")
        parser.add_argument("--max-log2-measurements", type=int, default=18,
                            help="hqc_eval_oracle: sweep measurement counts 2^0..2^(max-1)")
        parser.add_argument("--profile-log2", type=int, default=16,
                            help="hqc_eval_oracle: measurements per profiling phase (log2)")
        parser.add_argument("--state-file", type=str,
                            help="hqc_eval_oracle: JSON checkpoint for resumable sweeps")
        parser.add_argument("--profile-mode", type=str, default="interleaved",
                            choices=["interleaved", "sequential"],
                            help="hqc_eval_oracle: drift-robust interleaved profiling "
                                 "or the reference's sequential phases")
        parser.add_argument("--chunk-cap", type=int, default=None,
                            help="hqc_eval_oracle: cap the differential-trial "
                                 "interleave chunk (decaps per class before "
                                 "switching); default measure//8 uncapped — "
                                 "long chunks stop cancelling fast drift")
        parser.add_argument("--trial-mode", type=str, default="differential",
                            choices=["differential", "threshold"],
                            help="hqc_eval_oracle: drift-cancelling differential trials "
                                 "or the reference's absolute threshold")
        parser.add_argument("--adaptive", action="store_true",
                            help="kyber_simulate: adaptive (tree-coded) "
                                 "eta=3 measurement mode")
        parser.add_argument("--max-oracle-calls", type=int, default=None,
                            help="hqc_simulate: stop after this many oracle "
                                 "calls (None = run to recovery)")
        parser.add_argument("--decision-rule", type=str, default="expansion",
                            choices=["expansion", "midpoint"],
                            help="hqc_eval_oracle: differential decision boundary — "
                                 "'expansion' = 0.4x a profiled seed-expansion cost "
                                 "below the reference level (fail misread only when "
                                 "the garbage re-encryption draws >=3 extra "
                                 "expansions); 'midpoint' = half the class gap "
                                 "(round-1 rule, non-monotone tail)")
        parser.add_argument("--device", type=str, default="cuda",
                            help="Device of the decodes and FER simulations: 'cuda' (the default; "
                                 "raises without a card) or 'cpu'")
        error_group = parser.add_mutually_exclusive_group(required=False)
        error_group.add_argument("--error-rate", type=float, default=0.00,
                                 help="Error rate of the simulated binary symmetric channel; "
                                      "'NaN' guarantees no errors even for HQC simulation.")
        error_group.add_argument("--error-file", type=str,
                                 help="File specifying per-position error distributions.")

    # -- HQC attack ---------------------------------------------------------

    def command_hqc_simulate(self, args):
        from ..models.hqc import simulate_hqc_idealized_oracle

        rng = make_random_state(args.seed)
        _, tracking = simulate_hqc_idealized_oracle(
            rng, args.decode_every, args.code_weight, args.key_file,
            args.error_rate, args.param_set,
            max_oracle_calls=args.max_oracle_calls,
            oracle_backend=args.oracle_backend,
            decode_backend=args.decode_backend,
            timing_measure=args.timing_measure,
            timing_profile_measurements=2**args.profile_log2,
            timing_calibration_trials=args.timing_calibration_trials,
            timing_chunk_cap=args.chunk_cap,
            device=args.device,
        )
        stats = tracking.decoder_stats_table(label=args.label)
        logger.info(f"Stats: \n{text_table(stats)}")
        channel = getattr(tracking, "timing_channel", None)
        if channel is not None:
            acc_f, acc_s = channel.empirical_accuracy()
            logger.info(
                f"Timing channel: {channel.num_measurements} measurements, "
                f"{channel.num_decaps} timed decapsulations; empirical "
                f"accuracy vs ground truth: fail={acc_f} success={acc_s}"
            )
        if args.csv_output:
            append_csv(args.csv_output, stats)

    def command_hqc_eval_oracle(self, args):
        from ..models.hqc.eval_oracle import hqc_eval_oracle

        rng = make_random_state(args.seed)
        results = hqc_eval_oracle(
            rng, keyfile=args.key_file,
            num_trials=args.trials,
            max_log2_measurements=args.max_log2_measurements,
            profile_measurements=2**args.profile_log2,
            reduced_trials=args.reduced_trials,
            reduced_from_log2=args.reduced_from_log2,
            state_file=args.state_file,
            profile_mode=args.profile_mode,
            trial_mode=args.trial_mode,
            csv_output=args.csv_output,
            chunk_cap=args.chunk_cap,
            decision_rule=args.decision_rule,
            only_levels=args.only_levels,
        )
        if args.csv_output:
            # the curve is (re)written at every checkpoint; this logs the
            # final state for the user
            logger.info(
                f"Accuracy curve ({len(results)} levels) written to "
                f"{args.csv_output}"
            )

    def command_view_hqc_oracle_accuracy(self, args):
        from ..viz import view_hqc_oracle_accuracy

        measured = None
        if args.csv_output and exists(args.csv_output):
            import pandas as pd

            df = pd.read_csv(args.csv_output)
            measured = dict(zip(df["measurements"], df["accuracy"]))
        view_hqc_oracle_accuracy(measured=measured)

    def command_view_hqc_simulation_csv(self, args):
        from ..viz import view_hqc_simulation_csv

        view_hqc_simulation_csv(args.csv_output, "hqc-" + args.param_set)

    # -- FER simulations ----------------------------------------------------

    def command_test_rust_package(self, args):
        """Kept under its reference name (main.py:165-183): q-ary decode of
        the regular (3,6)+I code through the native-equivalent decoder, a
        batch of ``--threads`` frames at a time."""
        rng = make_random_state(args.seed)
        H = make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, rng)
        logger.info(f"Constructed a rate {300/450} code")
        successes, max_ok, min_fail = simulate_frame_error_rate_qary(
            H, 1, args.error_rate or 0.005, args.runs, rng,
            batch_size=args.threads, device=args.device,
        )
        logger.info(f"Success ratio {successes}/{args.runs}={successes/args.runs}")

    def command_regular_ldpc_code(self, args):
        rng = make_random_state(args.seed)
        errors_provider = ErrorsProvider(args.error_rate, args.error_file, rng)
        H = make_regular_ldpc_parity_check_matrix(300, 150, 3, 6, rng)
        logger.info(f"Constructed a rate {300/450} code")
        successes = simulate_frame_error_rate(H, errors_provider, args.runs, rng, device=args.device)
        logger.info(f"Success ratio {successes}/{args.runs}={successes/args.runs}")

    def command_regular_ldpc_code_identity(self, args):
        rng = make_random_state(args.seed)
        errors_provider = ErrorsProvider(args.error_rate, args.error_file, rng)
        H = make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, rng)
        logger.info(f"Constructed a rate {300/450} code")
        successes = simulate_frame_error_rate(H, errors_provider, args.runs, rng, device=args.device)
        logger.info(f"Success ratio {successes}/{args.runs}={successes/args.runs}")

    def command_qc_ldpc_code(self, args):
        rng = make_random_state(args.seed)
        errors_provider = ErrorsProvider(args.error_rate, args.error_file, rng)
        H = make_qc_parity_check_matrix(block_len=500, column_weight=3, num_blocks=2, rng=rng)
        successes = simulate_frame_error_rate(H, errors_provider, args.runs, rng, device=args.device)
        logger.info(f"Success ratio {successes}/{args.runs}={successes/args.runs}")

    def command_compute_bound(self, args):
        k, r = 300, 150
        rate = k / (k + r)
        p = args.error_rate
        entropy = -p * np.log2(p) - (1 - p) * np.log2(1 - p)
        capacity = 1 - entropy
        logger.info(f"R {'<' if rate < capacity else '>'} C, where R = {rate}, C = {capacity}")

    def command_official_example(self, args):
        rng = make_random_state(args.seed)
        errors_provider = ErrorsProvider(args.error_rate, args.error_file, rng)
        H = rep_code(13)
        successes = simulate_frame_error_rate(H, errors_provider, args.runs, rng, device=args.device)
        logger.info(f"Success ratio {successes}/{args.runs}={successes/args.runs}")

    def command_kyber_simulate(self, args):
        """End-to-end Kyber-768 attack simulation (the integration the
        reference leaves stubbed, kyber.py:379-435).  --error-rate maps to
        1 - oracle accuracy (default accuracy 0.95; 0.995 with --adaptive).
        --adaptive switches to the eta=3 tree-coded measurement mode (the
        adaptive pattern DB the reference records but never exercises)."""
        from ..models.kyber import (
            simulate_kyber_attack,
            simulate_kyber_attack_adaptive,
        )

        rng = make_random_state(args.seed)
        if getattr(args, "adaptive", False):
            accuracy = 1.0 - args.error_rate if args.error_rate else 0.995
            results = simulate_kyber_attack_adaptive(
                rng, accuracy=accuracy,
                sum_weight=6, check_blocks=2, iterations=10, runs=args.runs,
                device=args.device,
            )
        else:
            accuracy = 1.0 - args.error_rate if args.error_rate else 0.95
            results = simulate_kyber_attack(
                rng, accuracy=accuracy, num_patterns=3, num_patterns_sum=3,
                sum_weight=6, check_blocks=2, iterations=10, runs=args.runs,
                device=args.device,
            )
        recovered = sum(r["recovered"] for r in results)
        avg = np.mean([r["correct_coefficients"] for r in results])
        logger.info(
            f"Kyber-768: {recovered}/{len(results)} full recoveries, "
            f"avg correct coefficients {avg:.1f}/{results[0]['total_coefficients']}"
        )
        if args.csv_output:
            append_csv(args.csv_output, with_columns(table(results), label=args.label, accuracy=accuracy))

    # -- test runners -------------------------------------------------------

    def command_test(self, args):
        self.command_test_xml(args, xml=False)

    def command_test_xml(self, args, xml=True):
        """Run the conformance suite (pytest replaces the reference's
        doctest discovery, main.py:282-319)."""
        import subprocess

        cmd = [sys.executable, "-m", "pytest", "tests/", "-q"]
        if xml:
            cmd += ["--junitxml=report.xml"]
        rc = subprocess.run(cmd).returncode
        sys.exit(rc)


def main():
    cmds = Commands()
    args = cmds.parse_arguments()
    cmds.run(args)


if __name__ == "__main__":
    main()
