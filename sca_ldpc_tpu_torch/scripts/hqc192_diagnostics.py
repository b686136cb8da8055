#!/usr/bin/env python
"""HQC timing-channel root-cause diagnostics (the JAX package's
``scripts/hqc192_diagnostics.py`` on the port; host code only: the native
HQC core and the oracle modules, no kernel).

Three HQC-192 timing-attack attempts failed in-run calibration (acc_fail
0.10-0.33), with two structural causes measured (garbage >= 3-expansion
probability 0.042; decaps 2.2x longer so the same per-expansion signal is
proportionally smaller).  This script runs the per-vector expansion-pattern
diagnostics that explained the HQC-128 channel:

A. **Structure (no timing)**: the garbage extra-expansion distribution at
   large sample count, the intrinsic fail-class ceiling P(extra < 3), and a
   bounded search confirming no 4-expansion plaintext exists (the sampler's
   extras are Binomial(3, p) — each of the three sampled vectors overflows
   its buffer at most once, csrc/hqc_core.cpp vect_set_random_fixed_weight).
B. **Class levels (timing)**: interleaved profiling of ciphertexts with
   EXACTLY 0/1/2/3 extra seed expansions in ONE round-robin block — the
   per-expansion quantization check.  A linear ladder (level(k) ~ k * cost)
   means the channel itself is sound and calibration failures are SNR, not
   structure.  Measured at two chunk sizes to probe drift sensitivity
   (longer chunks = less interleaving overhead but less drift
   cancellation).
C. **Decision accuracy vs measurements (timing)**: real differential
   trials (eval_oracle methodology) at a sweep of measurements/decision,
   both classes, giving the empirical accuracy the attack's calibration
   would see.

Timing phases need a quiet host; run nothing else concurrently.  Any
parameter set through ``--param-set`` (default 192).

Reference: simulate/hqc_eval_oracle.py:15-56 (the reference's oracle eval,
HQC-128 only).

Usage:
    python -m sca_ldpc_tpu_torch.scripts.hqc192_diagnostics --out artifacts/hqc192_channel_diagnostics.json
    python -m sca_ldpc_tpu_torch.scripts.hqc192_diagnostics --phases A --out /tmp/a.json   # structure only
    python -m sca_ldpc_tpu_torch.scripts.hqc192_diagnostics --param-set 256
"""

import argparse
import json
import logging
import os
import time

logger = logging.getLogger("hqc192_diag")


def phase_a(HQC, rng, samples, search_samples):
    from sca_ldpc_tpu_torch.models.hqc.eval_oracle import (
        measure_garbage_expansion_distribution,
    )

    garbage = measure_garbage_expansion_distribution(HQC, rng, samples=samples)
    ceiling = sum(p for k, p in garbage.items() if k < 3)
    # Bounded search for a 4-expansion plaintext (expected: none — extras
    # are Binomial(3, p), so 4 would need one vector to overflow twice).
    ptlen = len(HQC.new_plaintext())
    max_extra = -1
    hits4 = 0
    for _ in range(search_samples):
        extra = (HQC.num_rejections(rng.bytes(ptlen)) // 1000) - 3
        if extra > max_extra:
            max_extra = extra
        if extra >= 4:
            hits4 += 1
    out = {
        "garbage_distribution": {str(k): v for k, v in garbage.items()},
        "fail_ceiling_P_extra_lt_3": ceiling,
        "search_samples": search_samples,
        "max_extra_observed": max_extra,
        "four_expansion_hits": hits4,
    }
    logger.info(f"Phase A: ceiling={ceiling:.4f} max_extra={max_extra}")
    return out


def phase_b(HQC, rng, pub, priv, measurements, chunks):
    """Exact-extra {0,1,2,3} class-level ladder, one interleaved block per
    chunk size.  Levels are medians over round-robin cycles of the
    within-cycle difference to the extra-0 class mean (drift cancels)."""
    from sca_ldpc_tpu_torch.models.hqc.eval_oracle import (
        _make_expansion_ct,
        _measure_interleaved,
    )

    num_profiles = 2
    results = []
    cts = []
    for extra in (0, 1, 2, 3):
        for _ in range(num_profiles):
            cts.append(_make_expansion_ct(HQC, rng, pub, extra))
    for chunk in chunks:
        t0 = time.time()
        totals, cycles = _measure_interleaved(
            HQC, priv, cts, measurements, chunk, cycle_stats=True
        )
        ladder = {}
        for ci, extra in enumerate((0, 1, 2, 3)):
            diffs = []
            for cyc in cycles:
                base = [t for t in cyc[0:num_profiles] if t is not None]
                mine = [t for t in cyc[ci * num_profiles:(ci + 1) * num_profiles]
                        if t is not None]
                if base and mine:
                    diffs.append(sum(mine) / len(mine) - sum(base) / len(base))
            diffs.sort()
            ladder[str(extra)] = diffs[len(diffs) // 2] if diffs else None
        # linearity: per-expansion increments
        incs = [
            ladder[str(k + 1)] - ladder[str(k)]
            for k in range(3)
            if ladder[str(k + 1)] is not None and ladder[str(k)] is not None
        ]
        results.append({
            "chunk": chunk,
            "measurements_per_ct": measurements,
            "levels_vs_extra0": ladder,
            "per_expansion_increments": incs,
            "totals_first_percentile": totals,
            "wall_seconds": round(time.time() - t0, 1),
        })
        logger.info(f"Phase B chunk={chunk}: ladder={ladder} incs={incs}")
    return results


def phase_c(HQC, rng, pub, priv, measure_levels, trials, margin_frac,
            expansion_cost):
    """Real differential decision trials at each measurements/decision level.

    Decision rule mirrors the attack (oracle_timing.TimingChannel): probe
    vs reference interleaved, fail iff diff < -margin with margin =
    margin_frac * expansion_cost.  Fail probes are beyond-correction-limit
    modifications (garbage re-encryption); success probes are
    within-correction-limit modifications (re-encrypt the attack pt)."""
    from sca_ldpc_tpu_torch.models.hqc.attack import (
        search_distinguishable_plaintext,
    )
    from sca_ldpc_tpu_torch.models.hqc.eval_oracle import (
        _measure_interleaved,
        modify_beyond_correction_limit,
    )
    from sca_ldpc_tpu_torch.models.hqc.oracle_timing import _success_probe_ct

    pt = search_distinguishable_plaintext(
        HQC, rng, target_additional_seedexpansions=3
    )
    base_ct, _ = HQC.encaps_with_plaintext_and_r1(pub, pt, [])
    margin = margin_frac * expansion_cost

    results = []
    for measure in measure_levels:
        t0 = time.time()
        chunk = max(16, measure // 8)
        counts = {"fail": [0, 0], "success": [0, 0]}  # [correct, total]
        diffs = {"fail": [], "success": []}
        for _ in range(trials):
            for cls in ("fail", "success"):
                probe = (
                    modify_beyond_correction_limit(HQC, rng, base_ct)
                    if cls == "fail"
                    else _success_probe_ct(HQC, rng, base_ct)
                )
                t_probe, t_ref = _measure_interleaved(
                    HQC, priv, [bytes(probe), bytes(base_ct)], measure, chunk
                )
                if t_probe is None or t_ref is None:
                    continue
                d = t_probe - t_ref
                diffs[cls].append(d)
                decided_success = d > -margin
                counts[cls][1] += 1
                if decided_success == (cls == "success"):
                    counts[cls][0] += 1
        row = {
            "measure": measure,
            "trials": trials,
            "margin_cycles": margin,
            "acc_fail": (counts["fail"][0] / counts["fail"][1]
                         if counts["fail"][1] else None),
            "acc_success": (counts["success"][0] / counts["success"][1]
                            if counts["success"][1] else None),
            "median_diff_fail": sorted(diffs["fail"])[len(diffs["fail"]) // 2]
            if diffs["fail"] else None,
            "median_diff_success": sorted(diffs["success"])[
                len(diffs["success"]) // 2] if diffs["success"] else None,
            "wall_seconds": round(time.time() - t0, 1),
        }
        results.append(row)
        logger.info(f"Phase C measure={measure}: acc=({row['acc_fail']}, "
                    f"{row['acc_success']}) medians=({row['median_diff_fail']}, "
                    f"{row['median_diff_success']})")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--param-set", default="192", choices=["128", "192", "256"])
    ap.add_argument("--out", default=None,
                    help="default: artifacts/hqc<set>_channel_diagnostics.json")
    ap.add_argument("--phases", default="ABC")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--garbage-samples", type=int, default=2**16)
    ap.add_argument("--search-samples", type=int, default=2**17)
    ap.add_argument("--profile-measurements", type=int, default=2**14)
    ap.add_argument("--chunks", type=int, nargs="+", default=[2**10, 2**12])
    ap.add_argument("--measure-levels", type=int, nargs="+",
                    default=[64, 256, 1024])
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--margin-frac", type=float, default=0.4)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from sca_ldpc_tpu_torch.models.hqc.model import Hqc128, Hqc192, Hqc256
    from sca_ldpc_tpu_torch.utils import make_random_state

    HQC = {"128": Hqc128, "192": Hqc192, "256": Hqc256}[args.param_set]()
    if args.out is None:
        args.out = f"artifacts/hqc{args.param_set}_channel_diagnostics.json"
    rng = make_random_state(args.seed)
    artifact = {
        "experiment": f"hqc{args.param_set}_channel_diagnostics",
        "param_set": args.param_set,
        "seed": args.seed,
        "phases": args.phases,
    }

    if "A" in args.phases:
        artifact["A_structure"] = phase_a(
            HQC, rng, args.garbage_samples, args.search_samples
        )
        _write(args.out, artifact)

    if "B" in args.phases or "C" in args.phases:
        from sca_ldpc_tpu_torch.models.hqc.eval_oracle import (
            profiling_oracle,
            profile_expansion_cost,
        )

        pub, priv = HQC.keypair()
        # warmup like the attack's calibration path
        profiling_oracle(HQC, rng, pub, priv, "warmup", False,
                         num_profiles=1, measurements=2**13)
        cost = None
        for _ in range(8):
            cost, t_lo, t_hi = profile_expansion_cost(
                HQC, rng, pub, priv, measurements=args.profile_measurements
            )
            if cost is not None and cost > 0:
                break
        artifact["per_expansion_cost_cycles"] = cost
        logger.info(f"Per-expansion cost at {args.param_set}: {cost} cycles")
        _write(args.out, artifact)

        if "B" in args.phases:
            artifact["B_class_ladder"] = phase_b(
                HQC, rng, pub, priv, args.profile_measurements, args.chunks
            )
            _write(args.out, artifact)
        if "C" in args.phases:
            if not cost or cost <= 0:
                logger.warning("no positive expansion cost; skipping phase C")
            else:
                artifact["C_decision_accuracy"] = phase_c(
                    HQC, rng, pub, priv, args.measure_levels, args.trials,
                    args.margin_frac, cost,
                )
                _write(args.out, artifact)

    _write(args.out, artifact)
    print(json.dumps(artifact, indent=1))
    return artifact


def _write(path, artifact):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(artifact, f, indent=1)
    os.replace(tmp, path)


if __name__ == "__main__":
    main()
