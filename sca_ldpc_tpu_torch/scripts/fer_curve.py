#!/usr/bin/env python
"""FER-vs-error-rate curves with a CPU-reference comparison (the JAX
package's ``scripts/fer_curve.py`` on the port).

Runs the port's FER step (``--backend fused``: the CUDA kernel K1;
``decode``: the decoder API, K2 on a card) and a NumPy reference decoder over
a sweep of error rates on the HQC-128 attack code, and writes a CSV (without
pandas, ``utils/table.py``) and optionally a plot.  The step runs on
``--device`` (default ``cuda``; raises without a card) on a mesh of one rank
(``parallel.make_mesh``); the device columns are ``gpu_fer`` and
``gpu_frames``.

    python -m sca_ldpc_tpu_torch.scripts.fer_curve --out fer_curve.csv --runs 2048
"""

import argparse
import time

import numpy as np


def cpu_reference_decode(lay, prior_llr, syndrome, max_iter=30):
    """One frame, NumPy product-sum syndrome BP on the circulant layout (the
    JAX benchmark's ``bench.py`` reference, copied)."""
    n = lay.n
    w = lay.weight
    shifts = np.asarray(lay.shifts)
    pc = prior_llr[:n]
    pi = prior_llr[n:]
    v2c = np.stack([np.roll(pc, k) for k in shifts])  # [w, n] check-major
    sgn_syn = 1.0 - 2.0 * syndrome

    def phi(x):
        x = np.clip(x, 1e-9, 60.0)
        return -np.log(np.tanh(0.5 * x))

    e_c = (pc < 0).astype(int)
    e_i = (pi < 0).astype(int)
    it = -1
    for it in range(max_iter):
        planes = np.concatenate([v2c, pi[None, :]], axis=0)  # [w+1, n]
        sgn = np.where(planes >= 0, 1.0, -1.0)
        mag = np.abs(planes)
        total_sign = sgn.prod(axis=0) * sgn_syn
        pm = phi(mag)
        total_pm = pm.sum(axis=0)
        c2v = (total_sign * sgn) * phi(np.maximum(total_pm - pm, 1e-9))
        c2v_c, c2v_i = c2v[:w], c2v[w]
        c2v_var = np.stack([np.roll(c2v_c[t], -k) for t, k in enumerate(shifts)])
        total_c = pc + c2v_var.sum(axis=0)
        v2c_var = np.clip(total_c[None, :] - c2v_var, -60, 60)
        v2c = np.stack([np.roll(v2c_var[t], k) for t, k in enumerate(shifts)])
        total_i = pi + c2v_i
        e_c = (total_c < 0).astype(int)
        e_i = (total_i < 0).astype(int)
        syn = (sum(np.roll(e_c, k) for k in shifts) + e_i) % 2
        if (syn == syndrome).all():
            break
    return np.concatenate([e_c, e_i]), it + 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fer_curve.csv")
    ap.add_argument("--runs", type=int, default=2048)
    ap.add_argument("--cpu-runs", type=int, default=64)
    ap.add_argument("--rates", type=float, nargs="+",
                    default=[0.01, 0.02, 0.03, 0.04, 0.045, 0.05, 0.055, 0.06])
    ap.add_argument("--weight", type=int, default=20)
    ap.add_argument("--max-iter", type=int, default=50)
    ap.add_argument("--backend", default="fused", choices=["fused", "decode"],
                    help="'fused' (K1; the JAX 'pallas') or 'decode' (the JAX 'xla')")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default; raises without a card) or 'cpu'")
    ap.add_argument("--plot", default=None, help="optional output plot path (needs matplotlib)")
    args = ap.parse_args(argv)

    import torch

    from sca_ldpc_tpu_torch.parallel import make_mesh, make_sharded_fer_step
    from sca_ldpc_tpu_torch.scripts.profile_trace import build_code
    from sca_ldpc_tpu_torch.utils.table import csv_text, table

    lay = build_code(weight=args.weight)
    mesh = make_mesh(data=1, model=1, device=args.device)

    def generator(seed):
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(seed)
        return gen

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    rows = []
    for rate in args.rates:
        probs = np.full(lay.n_vars, rate, np.float32)
        step = make_sharded_fer_step(lay, probs, mesh, max_iter=args.max_iter, method="product_sum",
                                     backend=args.backend)
        batch = max(8, (args.runs // 8) * 8)
        step(generator(0), batch)  # builds the kernel, outside the timing
        sync()
        t0 = time.perf_counter()
        ok, _conv, _ = step(generator(int(rate * 1e6)), batch)
        gpu_fer = 1.0 - int(ok) / batch
        gpu_dt = time.perf_counter() - t0

        # CPU reference on fewer frames (it is ~3 orders slower)
        rng = np.random.RandomState(int(rate * 1e6))
        prior = np.log((1 - probs) / probs).astype(np.float64)
        cpu_ok = 0
        t0 = time.perf_counter()
        for _ in range(args.cpu_runs):
            e = (rng.rand(lay.n_vars) < rate).astype(int)
            syn = (sum(np.roll(e[: lay.n], k) for k in lay.shifts) + e[lay.n:]) % 2
            e_hat, _ = cpu_reference_decode(lay, prior, syn, args.max_iter)
            cpu_ok += int((e_hat == e).all())
        cpu_fer = 1.0 - cpu_ok / args.cpu_runs
        rows.append({
            "error_rate": rate, "gpu_fer": gpu_fer, "gpu_frames": batch,
            "cpu_fer": cpu_fer, "cpu_frames": args.cpu_runs,
        })
        print(f"rate {rate}: {mesh.device} FER {gpu_fer:.4f} ({batch} frames, {gpu_dt:.1f}s) "
              f"| cpu FER {cpu_fer:.4f} ({args.cpu_runs} frames, {time.perf_counter() - t0:.1f}s)")

    with open(args.out, "w", newline="") as f:
        f.write(csv_text(table(rows)))
    print(f"wrote {args.out}")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        rate = [r["error_rate"] for r in rows]
        plt.semilogy(rate, [max(r["gpu_fer"], 1e-5) for r in rows], "o-", label="GPU")
        plt.semilogy(rate, [max(r["cpu_fer"], 1e-5) for r in rows], "s--", label="CPU ref")
        plt.xlabel("channel error rate")
        plt.ylabel("frame error rate")
        plt.legend()
        plt.grid(True, which="both", alpha=0.3)
        plt.savefig(args.plot, dpi=150, bbox_inches="tight")
        print(f"wrote {args.plot}")
    return rows


if __name__ == "__main__":
    main()
