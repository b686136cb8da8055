#!/usr/bin/env python
"""Kyber-768 recovery vs asymmetric per-position oracle noise (the JAX
package's ``scripts/kyber_noise_curve.py`` on the port).

Extends the idealized recovery curve (``kyber_curve``, uniform oracle
accuracy from the pattern databases) into a channel-robustness statement:
sweeps false-positive / false-negative asymmetries and per-position skews
through the matched FalsePositiveNegativePositionalOracle pipeline (the
reference defines that oracle, max_likelihood.py:21-38, but its kyber
experiment only ever instantiates the uniform SimpleOracle).

Each row: noise configuration x runs -> average correct coefficients (with
its standard error) and full recoveries, with the per-position rates
recorded as columns, for each pattern-database accuracy swept (0.995 and
0.95 by default).  The decodes run on ``--device`` (default ``cuda``, the
CUDA kernel K7; raises without a card); the CSV is rewritten after every
configuration (a killed sweep keeps the ones done), without pandas
(``utils/table.py``), byte for byte as the JAX script writes it.

    python -m sca_ldpc_tpu_torch.scripts.kyber_noise_curve --out artifacts/kyber768_noise_curve.csv
"""

import argparse
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/kyber768_noise_curve.csv")
    ap.add_argument("--runs", type=int, default=32)
    ap.add_argument("--accuracies", type=float, nargs="+",
                    default=[0.995, 0.95],
                    help="pattern-database accuracies (select codings); "
                         "0.95 is the cross-validation operating point")
    ap.add_argument("--num-patterns", type=int, default=3)
    ap.add_argument("--num-patterns-sum", type=int, default=3)
    ap.add_argument("--check-blocks", type=int, default=2)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    import numpy as np

    from sca_ldpc_tpu_torch.models.kyber import simulate_kyber_attack
    from sca_ldpc_tpu_torch.utils import make_random_state
    from sca_ldpc_tpu_torch.utils.table import csv_text, table

    m = args.num_patterns

    # (label, fp, fn) — scalars or per-position length-m lists.
    configs = []
    for eps in (0.005, 0.02, 0.05, 0.08, 0.12):
        configs.append((f"sym-{eps}", eps, eps))
    for fp_r, fn_r in ((0.01, 0.09), (0.09, 0.01), (0.02, 0.14),
                       (0.14, 0.02), (0.05, 0.15), (0.15, 0.05)):
        configs.append((f"asym-fp{fp_r}-fn{fn_r}", fp_r, fn_r))
    # per-position skew: one noisy measurement position among clean ones
    # (realistic channels degrade specific probe positions, not all alike)
    for hot in (0.1, 0.2, 0.3):
        rates = [0.01] * m
        rates[0] = hot
        configs.append((f"pos0-{hot}", list(rates), 0.01))
        configs.append((f"pos0-fn-{hot}", 0.01, list(rates)))

    rows = []
    for accuracy in args.accuracies:
        for label, fp, fn in configs:
            t0 = time.time()
            results = simulate_kyber_attack(
                make_random_state(args.seed),
                accuracy=accuracy,
                num_patterns=args.num_patterns,
                num_patterns_sum=args.num_patterns_sum,
                check_blocks=args.check_blocks,
                iterations=args.iterations,
                runs=args.runs,
                fp=fp,
                fn=fn,
                device=args.device,
            )
            correct = np.array([r["correct_coefficients"] for r in results], float)
            avg = float(correct.mean())
            # standard error of the mean, the statistic an asymmetry claim must clear
            sem = float(correct.std(ddof=1) / np.sqrt(len(correct)))
            rec = sum(r["recovered"] for r in results)
            fp_arr = np.broadcast_to(np.asarray(fp, float), (m,))
            fn_arr = np.broadcast_to(np.asarray(fn, float), (m,))
            row = {
                "config": label,
                "db_accuracy": accuracy,
                "num_patterns": args.num_patterns,
                "check_blocks": args.check_blocks,
                "runs": args.runs,
                "fp": json.dumps(list(np.round(fp_arr, 4))),
                "fn": json.dumps(list(np.round(fn_arr, 4))),
                "mean_fp": round(float(fp_arr.mean()), 4),
                "mean_fn": round(float(fn_arr.mean()), 4),
                "avg_correct": round(avg, 2),
                "sem_correct": round(sem, 3),
                "total_coefficients": results[0]["total_coefficients"],
                "recoveries": rec,
            }
            for i in range(m):
                row[f"fp_pos{i}"] = round(float(fp_arr[i]), 4)
                row[f"fn_pos{i}"] = round(float(fn_arr[i]), 4)
            rows.append(row)
            print(f"acc={accuracy} {label}: avg correct "
                  f"{avg:.1f}±{sem:.2f}/{row['total_coefficients']}, "
                  f"recoveries {rec}/{args.runs} ({time.time() - t0:.1f}s)",
                  flush=True)
            # incremental write: a killed sweep keeps its completed configs
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            tmp = args.out + ".tmp"
            with open(tmp, "w", newline="") as f:
                f.write(csv_text(table(rows)))
            os.replace(tmp, args.out)

    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
