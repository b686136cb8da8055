#!/usr/bin/env python
"""End-to-end HQC key recovery through the MEASURED timing channel (the JAX
package's ``scripts/timing_attack.py`` on the port).

Runs ``simulate_hqc_idealized_oracle`` with ``oracle_backend="timing"``:
every oracle decision comes from differential cycle-timed decapsulations of
the native HQC implementation (the rejection-sampling side channel the
reference only characterizes, hqc_eval_oracle.py / hqc.rs:175-200 — it never
drives its attack from it); the decodes run on ``--device``.  Emits a JSON
artifact with the calibration, decision counts, physical decapsulation
counts, live accuracy vs ground truth, and wall time.  After a recovery the
``--checkpoint`` file (which holds the private key) is deleted.

The calibration guard refuses a host whose counter cannot tell the classes
apart (``PERF.md`` §6); the run then raises.

Example:
    python -m sca_ldpc_tpu_torch.scripts.timing_attack --out timing_attack.json \\
        --key-file fixtures/test-hqc128.key --seed 1 --measure 64
"""

import argparse
import json
import logging
import os
import time

from ._timing_common import channel_fields, spy_trackings, start_partial_writer, stats_fields, write_json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="JSON artifact path")
    ap.add_argument("--csv", default=None, help="optional stats CSV (appended)")
    ap.add_argument("--key-file", default="fixtures/test-hqc128.key")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--param-set", default="128")
    ap.add_argument("--code-weight", type=int, default=20)
    ap.add_argument("--decode-every", type=int, default=50)
    ap.add_argument("--measure", type=int, default=64,
                    help="cycle-timed decapsulations per class per decision")
    ap.add_argument("--profile-log2", type=int, default=14)
    ap.add_argument("--calibration-trials", type=int, default=150)
    ap.add_argument("--max-oracle-calls", type=int, default=None)
    ap.add_argument("--pt-target", type=int, default=3,
                    help="extra seed expansions required of the attack "
                         "plaintext (3 is the maximum this sampler can "
                         "produce: extras are Binomial(3, ~0.18))")
    ap.add_argument("--decode-backend", default="circulant",
                    choices=["general", "padded", "circulant"])
    ap.add_argument("--device", default="cuda",
                    help="device of the decodes: 'cuda' (raises without a card) or 'cpu'")
    ap.add_argument("--recal-every", type=int, default=1200,
                    help="oracle decisions between mid-attack drift "
                         "recalibrations (0 disables)")
    ap.add_argument("--recal-trials", type=int, default=20,
                    help="known-class probes per class per recalibration")
    ap.add_argument("--checkpoint", default=None,
                    help="pickle the full attack state here at every clean "
                         "point so a killed run can be continued (deleted "
                         "after a recovery)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from an existing --checkpoint file "
                         "(skips profiling; recalibrates the channel once)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    # looked up at call time, so that a stub set on the package is the one run
    from sca_ldpc_tpu_torch.models.hqc import simulate_hqc_idealized_oracle
    from sca_ldpc_tpu_torch.utils import make_random_state
    from sca_ldpc_tpu_torch.utils.table import append_csv

    t0 = time.time()
    tracking_box = {}

    def base_artifact():
        return {
            "experiment": "hqc_timing_attack",
            "param_set": args.param_set,
            "key_file": args.key_file,
            "seed": args.seed,
            "code_weight": args.code_weight,
            "decode_every": args.decode_every,
            "timing_measure": args.measure,
            "pt_target": args.pt_target,
            "profile_measurements": 2**args.profile_log2,
            "recal_every": args.recal_every,
            "decode_backend": args.decode_backend,
            "device": args.device,
        }

    def snapshot():
        art = base_artifact()
        art["wall_seconds"] = round(time.time() - t0, 1)
        tr = tracking_box.get("tracking")
        if tr is not None:
            art.update(channel_fields(tr))
        return art

    restore = spy_trackings(lambda tr: tracking_box.setdefault("tracking", tr))
    stop_partial = start_partial_writer(args.out, snapshot, interval=60)
    try:
        ok, tracking = simulate_hqc_idealized_oracle(
            make_random_state(args.seed),
            args.decode_every,
            args.code_weight,
            args.key_file,
            0.0,
            args.param_set,
            max_oracle_calls=args.max_oracle_calls,
            oracle_backend="timing",
            decode_backend=args.decode_backend,
            timing_measure=args.measure,
            timing_profile_measurements=2**args.profile_log2,
            timing_calibration_trials=args.calibration_trials,
            timing_pt_target=args.pt_target,
            timing_recal_every=args.recal_every,
            timing_recal_trials=args.recal_trials,
            checkpoint_path=args.checkpoint,
            resume=args.resume,
            device=args.device,
        )
    finally:
        stop_partial()
        restore()
    wall = time.time() - t0

    artifact = base_artifact()
    artifact.update(stats_fields(tracking, ok))
    artifact["wall_seconds"] = round(wall, 1)
    artifact.update(channel_fields(tracking))
    write_json(args.out, artifact)
    if ok and args.checkpoint and os.path.exists(args.checkpoint):
        os.remove(args.checkpoint)  # it holds the private key; a recovered run must not be resumed
    print(json.dumps(artifact))

    if args.csv:
        append_csv(args.csv, tracking.decoder_stats_table(label="timing"))
    return artifact


if __name__ == "__main__":
    main()
