#!/usr/bin/env python
"""Kyber-768 recovery-rate vs oracle-accuracy curve, with the
information-budget analysis that places the recovery threshold (the JAX
package's ``scripts/kyber_curve.py`` on the port).

The paper's Kyber experiment: per oracle accuracy, how many coefficient
errors remain after decoding.  Sweeps the pattern database's supported
accuracies AND measurement-pattern counts, and writes per-run rows plus the
per-configuration information budget:

- ``info_single``: expected bits/coefficient from the single-coefficient
  patterns (the DB's recorded expected-information values,
  kyber.py:115-283);
- ``info_sum_per_coeff``: bits/coefficient contributed by the R sum checks
  (R/N x the sum-pattern info);
- ``secret_entropy``: H(s) of the centered-binomial secret (eta=2:
  2.0306 bits);
- ``info_margin`` = info_single + info_sum_per_coeff - secret_entropy.

Recovery transitions where the margin clears ~0.2 bits/coefficient: at
accuracy 0.95 with 3 patterns the margin is +0.20 (runs miss by 1-3
coefficients of 768); 4 patterns raise it to +0.37 and recovery completes.

The decodes run on ``--device`` (default ``cuda``, the CUDA kernel K7;
raises without a card); the CSV is written without pandas
(``utils/table.py``), byte for byte as the JAX script writes it.

    python -m sca_ldpc_tpu_torch.scripts.kyber_curve --out kyber_curve.csv --runs 16 \\
        --accuracies 0.9 0.95 0.995 --num-patterns 3 4 5
"""

import argparse
import math
import time


def secret_entropy(eta=2):
    from math import comb

    probs = [comb(2 * eta, i) / 4**eta for i in range(2 * eta + 1)]
    return -sum(p * math.log2(p) for p in probs if p)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="kyber_curve.csv")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--accuracies", type=float, nargs="+", default=[0.9, 0.95, 0.995])
    ap.add_argument("--num-patterns", type=int, nargs="+", default=[3],
                    help="single-coefficient measurement counts to sweep "
                         "(DB supports 1-5 depending on accuracy)")
    ap.add_argument("--num-patterns-sum", type=int, nargs="+", default=[3])
    ap.add_argument("--sum-weight", type=int, default=6)
    ap.add_argument("--check-blocks", type=int, nargs="+", default=[2])
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    from sca_ldpc_tpu_torch.models.kyber import simulate_kyber_attack
    from sca_ldpc_tpu_torch.models.kyber.params import BLOCK_LEN, ETA, NUM_BLOCKS
    from sca_ldpc_tpu_torch.models.kyber.patterns import SINGLE_PATTERNS, SUM_PATTERNS
    from sca_ldpc_tpu_torch.utils import make_random_state
    from sca_ldpc_tpu_torch.utils.table import csv_text, table

    h_secret = secret_entropy(ETA)
    n_coeff = BLOCK_LEN * NUM_BLOCKS

    rows = []
    for acc in args.accuracies:
        for nps in args.num_patterns_sum:
            for cb in args.check_blocks:
                r_checks = BLOCK_LEN * cb
                for np_single in args.num_patterns:
                    if np_single not in SINGLE_PATTERNS.get(acc, {}):
                        print(f"accuracy {acc}: no {np_single}-pattern DB entry, skipping")
                        continue
                    info_single = SINGLE_PATTERNS[acc][np_single][1]
                    info_sum = SUM_PATTERNS[args.sum_weight][nps][0]
                    info_sum_per_coeff = info_sum * r_checks / n_coeff
                    margin = info_single + info_sum_per_coeff - h_secret
                    t0 = time.time()
                    results = simulate_kyber_attack(
                        make_random_state(args.seed),
                        accuracy=acc,
                        num_patterns=np_single,
                        num_patterns_sum=nps,
                        sum_weight=args.sum_weight,
                        check_blocks=cb,
                        iterations=args.iterations,
                        runs=args.runs,
                        device=args.device,
                    )
                    for r in results:
                        rows.append({
                            "accuracy": acc,
                            "num_patterns": np_single,
                            "num_patterns_sum": nps,
                            "check_blocks": cb,
                            "info_single": info_single,
                            "info_sum_per_coeff": round(info_sum_per_coeff, 4),
                            "secret_entropy": round(h_secret, 4),
                            "info_margin": round(margin, 4),
                            **r,
                        })
                    avg = sum(r["correct_coefficients"] for r in results) / len(results)
                    rec = sum(r["recovered"] for r in results)
                    print(f"accuracy {acc} x {np_single}p x {nps}sp x {cb}cb "
                          f"(margin {margin:+.3f} bits): avg correct {avg:.1f}/768, "
                          f"full recoveries {rec}/{len(results)}, {time.time()-t0:.1f}s")

    with open(args.out, "w", newline="") as f:
        f.write(csv_text(table(rows)))
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
