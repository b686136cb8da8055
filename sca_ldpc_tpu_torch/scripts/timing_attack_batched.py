#!/usr/bin/env python
"""Batched multi-instance TIMING attacks (the JAX package's
``scripts/timing_attack_batched.py`` on the port).

Runs N independent HQC key recoveries, each driven by the measured
decapsulation-timing channel on its own fresh key, concurrently: the
cycle-timed measurement blocks serialize on eval_oracle.MEASUREMENT_LOCK
(the physical channel is host-global), per-key profiling/calibration runs
per instance, and the periodic LDPC decodes merge into batched device calls
(``BatchedCirculantDecodeExecutor``: one K8 launch a round on the card).

Usage:
    python -m sca_ldpc_tpu_torch.scripts.timing_attack_batched --seeds 7 8 \\
        --out timing_batched_2x128.json
"""

import argparse
import json
import logging
import time

from ._timing_common import channel_fields, spy_trackings, start_partial_writer, write_json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8])
    ap.add_argument("--param-set", default="128")
    ap.add_argument("--code-weight", type=int, default=20)
    ap.add_argument("--decode-every", type=int, default=50)
    ap.add_argument("--measure", type=int, default=64)
    ap.add_argument("--profile-log2", type=int, default=14)
    ap.add_argument("--calibration-trials", type=int, default=150)
    ap.add_argument("--decode-backend", default="circulant")
    ap.add_argument("--device", default="cuda",
                    help="device of the decode rounds: 'cuda' (raises without a card) or 'cpu'")
    ap.add_argument("--recal-every", type=int, default=1200)
    ap.add_argument("--recal-trials", type=int, default=20)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="per-instance mid-attack checkpoints; relaunching "
                         "with the same dir resumes killed instances")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    logging.getLogger("sca_ldpc_tpu_torch").setLevel(logging.WARNING)

    from sca_ldpc_tpu_torch.models.hqc import batched

    t0 = time.time()
    trackings = []

    def run_fields(tracking):
        fields = {"calibrated_epsilon": None}
        calib = getattr(tracking, "timing_calibration", None)
        if calib:
            fields["calibrated_epsilon"] = list(calib["initial_epsilon"])
        fields.update(channel_fields(tracking))
        return fields

    def header():
        return {
            "experiment": "hqc_timing_attack_batched",
            "param_set": args.param_set,
            "instances": len(args.seeds),
            "timing_measure": args.measure,
            "profile_measurements": 2**args.profile_log2,
            "recal_every": args.recal_every,
            "decode_backend": args.decode_backend,
            "device": args.device,
        }

    def snapshot():
        return dict(
            header(),
            wall_seconds=round(time.time() - t0, 1),
            # thread creation order, not seed order — labeled by index only
            runs=[dict(instance=i, **run_fields(tr)) for i, tr in enumerate(list(trackings))],
        )

    restore = spy_trackings(trackings.append)
    stop_partial = start_partial_writer(args.out, snapshot, interval=60)
    try:
        results, batched_calls = batched.simulate_hqc_attacks_batched(
            args.seeds, args.decode_every, args.code_weight,
            param_set=args.param_set,
            oracle_backend="timing",
            decode_backend=args.decode_backend,
            timing_measure=args.measure,
            timing_profile_measurements=2**args.profile_log2,
            timing_calibration_trials=args.calibration_trials,
            timing_recal_every=args.recal_every,
            timing_recal_trials=args.recal_trials,
            checkpoint_dir=args.checkpoint_dir,
            device=args.device,
        )
    finally:
        stop_partial()
        restore()
    wall = time.time() - t0

    runs = []
    for seed, res in zip(args.seeds, results):
        if res is None:
            runs.append({"seed": seed, "success": False, "error": "instance died"})
            continue
        ok, tracking = res
        runs.append(dict(seed=seed, success=bool(ok), **run_fields(tracking)))
    artifact = dict(
        header(),
        batched_decode_calls=batched_calls,
        wall_seconds=round(wall, 1),
        keys_recovered=sum(1 for r in runs if r.get("success")),
        runs=runs,
    )
    write_json(args.out, artifact)
    print(json.dumps(artifact, indent=1))
    return artifact


if __name__ == "__main__":
    main()
