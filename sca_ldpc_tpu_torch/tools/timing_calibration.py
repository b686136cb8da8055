"""How reliably the host calibrates the HQC timing oracle, setting by setting.

For each setting ``measure:log2_profile:trials`` (decapsulations a class a
decision, log2 of the profiling measurements, calibration trials a class)
this runs ``oracle_timing.calibrate_timing_channel`` ``--repeats`` times with
one calibration attempt each (the attack allows 4), on the fixture key, and
prints one JSON line an attempt: the profiled gap, expansion cost and
decision margin (cycles), the calibrated accuracy of each class, whether the
attempt passed the 0.85 floor, its seconds and the host's load average.
First it times one decapsulation (``decode_oracle``).  ``--diagnose`` keeps
each class's differentials instead (their quantiles against the margin);
``--pin`` runs on one core.  Host code only: cycle counts around the native
``decaps``, no device.

    python3 -m sca_ldpc_tpu_torch.tools.timing_calibration --settings 64:14:100 128:14:100 --repeats 2 \\
        --out build/timing_calibration.json
"""

import argparse
import json
import os
import time
from pathlib import Path

from ..models.hqc import Hqc128, read_or_generate_keypair
from ..models.hqc.eval_oracle import _loadavg
from ..models.hqc.oracle_timing import calibrate_timing_channel
from ..utils import make_random_state

KEYFILE = Path(__file__).resolve().parents[2] / "fixtures" / "test-hqc128.key"


def decaps_us(HQC, pub, priv, count=4000):
    """Mean wall µs of one cycle-timed decapsulation, and the median cycles."""
    ct, _ = HQC.encaps_with_plaintext_and_r1(pub, bytes(HQC.new_plaintext()), [])
    t0 = time.perf_counter()
    cycles = HQC.decode_oracle(ct, priv, count)
    return 1e6 * (time.perf_counter() - t0) / count, sorted(cycles)[len(cycles) // 2]


def _quantiles(xs):
    xs = sorted(xs)
    return [xs[min(len(xs) - 1, int(q * len(xs)))] for q in (0.05, 0.25, 0.5, 0.75, 0.95)]


def diagnose(HQC, pub, priv, seed, measure, log2_profile, trials):
    """The calibration's steps with the differentials kept: profile the gap
    and the expansion cost as ``calibrate_timing_channel`` does, then measure
    ``trials`` known-fail probes, ``trials`` known-success probes and
    ``trials // 2`` repeats of the base ciphertext itself; returns their
    quantiles (5, 25, 50, 75, 95%), the margin, and each class's accuracy at
    it (success: the differential above -margin)."""
    from ..models.hqc import search_distinguishable_plaintext
    from ..models.hqc.eval_oracle import modify_beyond_correction_limit, profile_expansion_cost, \
        profiling_oracle_interleaved
    from ..models.hqc.oracle_timing import TimingChannel, _success_probe_ct

    t0 = time.perf_counter()
    rng = make_random_state(seed)
    _n, _y, gap = profiling_oracle_interleaved(HQC, rng, pub, priv, measurements=2**log2_profile)
    cost, _lo, _hi = profile_expansion_cost(HQC, rng, pub, priv, measurements=min(2**log2_profile, 2**14))
    pt = search_distinguishable_plaintext(HQC, rng, target_additional_seedexpansions=3)
    ct, _ = HQC.encaps_with_plaintext_and_r1(pub, pt, [])
    margin = 0.4 * cost if cost else None
    ch = TimingChannel(HQC, priv, ct, gap or 1.0, margin=margin, measure=measure)
    fail = [ch._measure_diff(modify_beyond_correction_limit(HQC, rng, ct)) for _ in range(trials)]
    succ = [ch._measure_diff(_success_probe_ct(HQC, rng, ct)) for _ in range(trials)]
    base = [ch._measure_diff(ct) for _ in range(trials // 2)]
    row = {"measure": measure, "profile_measurements": 2**log2_profile, "trials": trials, "seed": seed,
           "gap": gap, "cost": cost, "margin": margin, "fail_q": _quantiles(fail), "success_q": _quantiles(succ),
           "base_q": _quantiles(base)}
    if margin is not None:
        row["acc_fail"] = sum(d <= -margin for d in fail) / trials
        row["acc_success"] = sum(d > -margin for d in succ) / trials
    row["seconds"] = time.perf_counter() - t0
    return row


def attempt(HQC, pub, priv, seed, measure, log2_profile, trials):
    """One calibration attempt; a refusal is a result here, not an error."""
    t0 = time.perf_counter()
    row = {"measure": measure, "profile_measurements": 2**log2_profile, "trials": trials, "seed": seed,
           "loadavg_before": round(_loadavg(), 3)}
    try:
        params, acc_fail, acc_success, _ct = calibrate_timing_channel(
            HQC, make_random_state(seed), pub, priv, measure=measure, profile_measurements=2**log2_profile,
            calibration_trials=trials, max_calibration_attempts=1)
        row.update(passed=True, gap=params["gap"], cost=params["cost"], margin=params["margin"],
                   acc_fail=acc_fail, acc_success=acc_success, fail_ceiling=params["fail_ceiling"])
    except RuntimeError as e:  # the 0.85 floor refused the channel
        row.update(passed=False, refused=str(e))
    row["seconds"] = time.perf_counter() - t0
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--settings", nargs="+", default=["64:14:100", "128:14:100"],
                    help="measure:log2_profile:trials, one calibration setting each")
    ap.add_argument("--repeats", type=int, default=2, help="attempts a setting")
    ap.add_argument("--out", default=None, help="write the rows as a JSON list here")
    ap.add_argument("--diagnose", action="store_true",
                    help="keep the differentials of each class in place of calibrating (diagnose())")
    ap.add_argument("--pin", type=int, default=None, help="run on this CPU core alone")
    args = ap.parse_args(argv)
    if args.pin is not None:
        os.sched_setaffinity(0, {args.pin})
    HQC = Hqc128()
    pub, priv = read_or_generate_keypair(HQC, str(KEYFILE))
    us, cycles = decaps_us(HQC, pub, priv)
    head = {"decaps_us": us, "decaps_median_cycles": cycles, "cpus": os.cpu_count(), "loadavg": _loadavg(),
            "pinned": args.pin}
    print(json.dumps(head), flush=True)
    rows = [head]
    for setting in args.settings:
        measure, log2_profile, trials = (int(x) for x in setting.split(":"))
        for r in range(args.repeats):
            run = diagnose if args.diagnose else attempt
            rows.append(run(HQC, pub, priv, 100 + r, measure, log2_profile, trials))
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
