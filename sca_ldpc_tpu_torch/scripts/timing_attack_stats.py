#!/usr/bin/env python
"""Repeatability statistics for the timing-channel key recovery (the JAX
package's ``scripts/timing_attack_stats.py`` on the port).

Runs a configurable set of recoveries — different seeds, fresh keys,
HQC-192, and the card's circulant decode (K8) — writing one JSON artifact
per run plus a summary table, to settle:

- repeatability of the end-to-end recovery (success rate, wall, decaps);
- whether the success-class calibration is systematically optimistic.

Each run uses a FRESH keypair (no --key-file), so the statistics cover key
variation as well as seed variation.  Runs are sequential in one process,
every one decoding on ``--device`` (``cuda``, the default, raises without a
card; ``cpu`` runs them all on the CPU); the timing channel needs a quiet
machine, so do not run this concurrently with sweeps or kernel work.  A run that raises (the
calibration guard refusing a noisy window) leaves an artifact with
``error``; the summary holds only finished runs, never one with ``error``.
A run's checkpoint (which holds the private key) is deleted after its
recovery.

Usage:
    python -m sca_ldpc_tpu_torch.scripts.timing_attack_stats --out-dir timing_stats
"""

import argparse
import json
import logging
import os
import time

from ._timing_common import channel_fields, spy_trackings, start_partial_writer, stats_fields, write_json

logger = logging.getLogger("timing_stats")

# (name, param_set, code_weight, decode_every, seed, decode_backend)
DEFAULT_RUNS = [
    ("128-s2-general", "128", 20, 50, 2, "general"),
    ("128-s3-general", "128", 20, 50, 3, "general"),
    ("128-s4-circulant", "128", 20, 50, 4, "circulant"),
    ("128-s5-circulant", "128", 20, 50, 5, "circulant"),
    ("192-s6-circulant", "192", 30, 100, 6, "circulant"),
]


def summarize(out_dir, summary):
    """Add every finished artifact in ``out_dir`` that ``summary`` lacks (by
    run name): not one still partial, not one that ended in an error.  The
    summary covers every completed artifact, not just this invocation's
    subset."""
    known = {a.get("run") for a in summary}
    for path in sorted(os.listdir(out_dir)):
        if not (path.startswith("timing_") and path.endswith(".json")):
            continue
        with open(os.path.join(out_dir, path)) as f:
            art = json.load(f)
        if art.get("run") and art["run"] not in known and not art.get("partial") and not art.get("error"):
            summary.append(art)
            known.add(art["run"])
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="timing_stats")
    ap.add_argument("--runs", nargs="+", default=None,
                    help="subset of run names (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="device of every run's decodes: 'cuda' (raises without a card) or 'cpu'")
    ap.add_argument("--measure", type=int, default=64)
    ap.add_argument("--profile-log2", type=int, default=14)
    ap.add_argument("--calibration-trials", type=int, default=150)
    ap.add_argument("--recal-every", type=int, default=1200)
    ap.add_argument("--recal-trials", type=int, default=20)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    logging.getLogger("sca_ldpc_tpu_torch").setLevel(logging.WARNING)

    runs = [r for r in DEFAULT_RUNS if args.runs is None or r[0] in args.runs]

    # looked up at call time, so that a stub set on the package is the one run
    from sca_ldpc_tpu_torch.models.hqc import simulate_hqc_idealized_oracle
    from sca_ldpc_tpu_torch.utils import make_random_state

    summary = []
    device = args.device
    for (name, pset, weight, decode_every, seed, backend) in runs:
        out = os.path.join(args.out_dir, f"timing_{name}.json")
        ckpt_path = os.path.join(args.out_dir, f"checkpoint_{name}.pkl")
        resume = False
        prior_wall = 0.0
        if os.path.exists(out):
            with open(out) as f:
                prior = json.load(f)
            # Only resume artifacts measured under the SAME parameters —
            # a summary mixing measurement configurations is silently
            # wrong.
            mismatches = {
                k: (prior.get(k), cur) for k, cur in (
                    ("timing_measure", args.measure),
                    ("profile_measurements", 2**args.profile_log2),
                ) if prior.get(k) != cur
            }
            if prior.get("partial") or prior.get("error"):
                resume = os.path.exists(ckpt_path) and not mismatches
                if resume:
                    prior_wall = float(prior.get("wall_seconds", 0.0))
                    logger.warning(
                        f"{name}: existing artifact is partial or errored — "
                        f"resuming from {ckpt_path} "
                        f"({prior_wall:.0f}s already spent)")
                else:
                    logger.warning(f"{name}: existing artifact is partial or "
                                   "errored (previous run died) — re-running")
            elif mismatches:
                logger.warning(
                    f"{name}: existing artifact measured under different "
                    f"parameters {mismatches}; skipping it in the summary — "
                    "delete the file to re-run at the current parameters"
                )
                continue
            else:
                logger.info(f"{name}: artifact exists, skipping")
                summary.append(prior)
                continue
        logger.info(f"=== {name}: param_set={pset} seed={seed} "
                    f"decode={backend} device={device} ===")
        t0 = time.time()

        tracking_box = {}

        def base_artifact(_name=name, _pset=pset, _weight=weight, _de=decode_every, _seed=seed, _backend=backend):
            return {
                "experiment": "hqc_timing_attack",
                "run": _name,
                "param_set": _pset,
                "seed": _seed,
                "key": "fresh",
                "code_weight": _weight,
                "decode_every": _de,
                "timing_measure": args.measure,
                "profile_measurements": 2**args.profile_log2,
                "recal_every": args.recal_every,
                "decode_backend": _backend,
                "device": device,
            }

        def snapshot(_t0=t0, _base=base_artifact, _box=tracking_box, _pw=prior_wall):
            art = _base()
            art["wall_seconds"] = round(_pw + time.time() - _t0, 1)
            tr = _box.get("tracking")
            if tr is not None:
                art.update(channel_fields(tr))
            return art

        restore = spy_trackings(lambda tr, _box=tracking_box: _box.setdefault("tracking", tr))
        stop_partial = start_partial_writer(out, snapshot, interval=60)
        run_error = None
        try:
            ok, tracking = simulate_hqc_idealized_oracle(
                make_random_state(seed),
                decode_every,
                weight,
                None,  # fresh keypair per run
                0.0,
                pset,
                oracle_backend="timing",
                decode_backend=backend,
                timing_measure=args.measure,
                timing_profile_measurements=2**args.profile_log2,
                timing_calibration_trials=args.calibration_trials,
                timing_recal_every=args.recal_every,
                timing_recal_trials=args.recal_trials,
                checkpoint_path=ckpt_path,
                resume=resume,
                device=device,
            )
        except Exception as e:  # e.g. calibration failure on a noisy window
            run_error = str(e)
        finally:
            stop_partial()
            restore()
        wall = prior_wall + time.time() - t0
        if run_error is not None:
            logger.warning(f"{name}: run failed after {wall:.0f}s: {run_error}")
            art = snapshot()
            art["error"] = run_error
            art["success"] = False
            write_json(out, art)
            continue
        artifact = base_artifact()
        artifact.update(stats_fields(tracking, ok))
        artifact["wall_seconds"] = round(wall, 1)
        artifact["resumed"] = resume
        artifact.update(channel_fields(tracking))
        write_json(out, artifact)
        if ok and os.path.exists(ckpt_path):
            os.remove(ckpt_path)  # a completed run must not be resumed
        summary.append(artifact)
        logger.info(
            f"{name}: success={ok} wall={wall:.0f}s "
            f"eps={artifact['calibrated_epsilon']} "
            f"live=({artifact.get('live_accuracy_fail')},"
            f"{artifact.get('live_accuracy_success')})"
        )

    summarize(args.out_dir, summary)
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("\nrun            set  ok   wall(s)  decisions  decaps     "
          "eps_cal(f,s)      live(f,s)")
    for a in summary:
        eps = a.get("calibrated_epsilon") or (float("nan"), float("nan"))
        lf = a.get("live_accuracy_fail")
        ls = a.get("live_accuracy_success")
        print(f"{a.get('run', '?'):14s} {a['param_set']:4s} "
              f"{'Y' if a.get('success') else 'N'}  {a['wall_seconds']:8.1f} "
              f"{a.get('oracle_decisions', 0):9d}  "
              f"{a.get('timed_decapsulations', 0):9d} "
              f"({eps[0]:.3f},{eps[1]:.3f})  "
              f"({lf if lf is None else round(lf, 3)},"
              f"{ls if ls is None else round(ls, 3)})")
    return summary


if __name__ == "__main__":
    main()
