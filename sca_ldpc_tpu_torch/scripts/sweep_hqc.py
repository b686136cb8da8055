#!/usr/bin/env python
"""HQC attack-simulation sweep (the JAX package's
``scripts/sweep_hqc.py`` on the port).

Replaces the reference's shell-level sweep (run-parallel-hqc-simulation.sh:
one process per (label, weight) config, `wait -n` throttling, per-config log
files used as resume markers).  Differences by design:

- Configs run sequentially in ONE process: the card is one device, and the
  attack's host work and decodes already keep it; host-level parallelism
  would only contend.  Multi-host scale-out = run one sweep per host with
  disjoint --labels and merge CSVs.
- Resume markers are per-config .done files; stats append to one CSV
  (same schema as the reference, readable by viz/), written without pandas
  (``utils/table.py``).  A config whose marker is missing has its rows
  dropped before it runs again (a crash between the CSV append and the
  marker write).
- Each config's seed is the crc32 of its content, so a (label, weight) gets
  the same seed in any sweep composition.

Example (the reference's default sweep, scaled down):
    python -m sca_ldpc_tpu_torch.scripts.sweep_hqc --csv sweep.csv --param-set 256 \\
        --weights 20 30 40 50 60 --labels $(seq 1 100) --decode-every 100
"""

import argparse
import logging
import os
import time
import zlib

logger = logging.getLogger("sweep")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", required=True, help="output CSV (appended)")
    ap.add_argument("--param-set", default="256")
    ap.add_argument("--weights", type=int, nargs="+", default=[20, 30, 40, 50, 60])
    ap.add_argument("--labels", nargs="+", default=[str(i) for i in range(1, 101)])
    ap.add_argument("--decode-every", type=int, default=100)
    ap.add_argument("--key-file", default=None)
    ap.add_argument("--error-rate", type=float, default=0.0)
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--max-oracle-calls", type=int, default=None)
    ap.add_argument("--oracle-backend", default="fast", choices=["fast", "native"])
    ap.add_argument("--decode-backend", default="general",
                    choices=["general", "padded", "circulant"],
                    help="'padded' = checks-only decode at a fixed "
                         "capacity; 'circulant' = the masked full-circulant "
                         "decode, one K8 launch a decode (or a batched "
                         "round) on the card")
    ap.add_argument("--state-dir", default=None,
                    help="resume-marker directory (default: <csv>.state)")
    ap.add_argument("--device", default="cuda",
                    help="device of the decodes: 'cuda' (the default; raises "
                         "without a card) or 'cpu'")
    ap.add_argument("--batch-size", type=int, default=1,
                    help=">1 runs that many same-weight labels as "
                         "concurrent attack instances with their decodes "
                         "merged into single batched device calls "
                         "(simulate_hqc_attacks_batched; with 'circulant' "
                         "one K8 launch a round) — the fast path "
                         "for the reference's 100-label default sweep")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    logging.getLogger("sca_ldpc_tpu_torch").setLevel(logging.WARNING)

    # looked up at call time, so that a stub set on the package is the one run
    from sca_ldpc_tpu_torch.models.hqc import simulate_hqc_idealized_oracle
    from sca_ldpc_tpu_torch.utils import make_random_state
    from sca_ldpc_tpu_torch.utils.table import append_csv, drop_config_rows

    state_dir = args.state_dir or (args.csv + ".state")
    os.makedirs(state_dir, exist_ok=True)

    configs = [(label, w) for label in args.labels for w in args.weights]
    logger.info(f"{len(configs)} configs; resume markers in {state_dir}")

    def marker_path(label, weight):
        return os.path.join(state_dir, f"{args.param_set}-{label}-w{weight}.done")

    def seed_of(label, weight):
        return args.seed_base + zlib.crc32(f"{label}-{weight}".encode()) % (2**31)

    def drop_stale_rows(label, weight):
        # a crash between CSV append and marker write leaves partial rows;
        # drop them before re-running the config
        dropped = drop_config_rows(args.csv, label, weight)
        if dropped:
            logger.warning(f"dropping {dropped} stale rows for {label} w={weight}")

    def append_result(label, weight, ok, tracking, wall):
        append_csv(args.csv, tracking.decoder_stats_table(label=label))
        with open(marker_path(label, weight), "w") as f:
            f.write(f"success={ok} wall={wall:.1f}\n")

    if args.batch_size > 1:
        from sca_ldpc_tpu_torch.models.hqc.batched import simulate_hqc_attacks_batched

        for weight in args.weights:
            todo = [l for l in args.labels if not os.path.exists(marker_path(l, weight))]
            done_n = len(args.labels) - len(todo)
            if done_n:
                logger.info(f"w={weight}: {done_n} labels already done")
            for i in range(0, len(todo), args.batch_size):
                group = todo[i : i + args.batch_size]
                for label in group:
                    drop_stale_rows(label, weight)
                seeds = [seed_of(label, weight) for label in group]
                t0 = time.time()
                results, calls = simulate_hqc_attacks_batched(
                    seeds, args.decode_every, weight,
                    error_rate=args.error_rate, param_set=args.param_set,
                    max_oracle_calls=args.max_oracle_calls,
                    oracle_backend=args.oracle_backend,
                    decode_backend=args.decode_backend,
                    device=args.device,
                )
                wall = time.time() - t0
                for label, res in zip(group, results):
                    if res is None:
                        logger.error(f"{label} w={weight}: instance died")
                        continue
                    ok, tracking = res
                    append_result(label, weight, ok, tracking, wall)
                n_ok = sum(1 for r in results if r and r[0])
                logger.info(
                    f"w={weight} batch {group[0]}..{group[-1]}: "
                    f"{n_ok}/{len(group)} recovered, {calls} batched decode "
                    f"calls, wall={wall:.1f}s"
                )
        return

    for i, (label, weight) in enumerate(configs):
        if os.path.exists(marker_path(label, weight)):
            logger.info(f"[{i+1}/{len(configs)}] {label} w={weight}: done, skipping")
            continue
        drop_stale_rows(label, weight)
        t0 = time.time()
        ok, tracking = simulate_hqc_idealized_oracle(
            make_random_state(seed_of(label, weight)),
            args.decode_every,
            weight,
            args.key_file,
            args.error_rate,
            args.param_set,
            max_oracle_calls=args.max_oracle_calls,
            oracle_backend=args.oracle_backend,
            decode_backend=args.decode_backend,
            device=args.device,
        )
        append_result(label, weight, ok, tracking, time.time() - t0)
        logger.info(
            f"[{i+1}/{len(configs)}] {label} w={weight}: success={ok} "
            f"oracle_calls={tracking.num_oracle_calls} wall={time.time()-t0:.1f}s"
        )


if __name__ == "__main__":
    main()
