#!/usr/bin/env python
"""Phase-profile a single-instance HQC key recovery.

Measures where the attack's wall time goes — periodic LDPC decodes vs
raw oracle probes vs host control flow — for any parameter set / decode
backend (the JAX package's ``scripts/attack_phase_profile.py``), from the
attack's own spans and counters (``utils/spans.py``), recorded for the run.

Phases:
- decode:  the ``attack.decode`` span, each periodic decode's wall (host
           array building + device call + result fetch); inside it,
           ``attack.decode.build`` (``build_masked_arrays`` /
           ``build_arrays``), ``attack.decode.stats``
           (``stats_from_masked`` / ``stats_from_decoded``) and, for
           ``circulant`` on a CUDA device, K8's own device time (CUDA
           events around each launch); the rest of the decode is copies,
           launch overhead and host syncs
- oracle:  ``attack.oracle``, HqcOracle._raw / HqcOracle.query_candidates
           (the idealized fast-oracle spectrum updates, host numpy)
- other:   everything else (search control flow, bookkeeping); inside it,
           ``attack.flip``, the ciphertext mutations
           ``HqcOracle.flip_block`` / ``flip_bit`` (under the fast backend
           each updates the Walsh-spectrum state) as ``oracle_flip_seconds``

The artifact keeps the JAX script's keys.  ``p_bucket`` is null: the port
has no compile-shape buckets (``MaskedCirculantCheckDecoder.P_BUCKET`` is
an XLA compile option), so ``--p-bucket`` is gone.  ``--key-file`` (not in
the JAX script, whose attack draws a fresh key) fixes the key, and
``--cprofile N`` adds the N functions with the most own time under
``cProfile`` (a second accounting; it slows the run, so its times are not
the split's).

Usage:
    python -m sca_ldpc_tpu_torch.scripts.attack_phase_profile --param-set 128 \\
        --code-weight 20 --decode-every 50 --seed 0 --key-file fixtures/test-hqc128.key \\
        --decode-backend circulant --out hqc128_phase_profile.json
"""

import argparse
import contextlib
import json
import logging
import os
import time


def profile(args):
    """Run the attack with its spans recorded; returns the artifact."""
    import torch

    import sca_ldpc_tpu_torch.models.hqc.attack as atk
    from sca_ldpc_tpu_torch.ops.kernels import circulant_cuda
    from sca_ldpc_tpu_torch.utils import make_random_state, spans
    from sca_ldpc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    timing = contextlib.nullcontext()
    if device.type == "cuda" and args.decode_backend == "circulant":
        timing = circulant_cuda.timed_multi_decodes()

    profiler = None
    if args.cprofile:
        import cProfile

        profiler = cProfile.Profile()
    spans.reset()
    t0 = time.perf_counter()
    try:
        with spans.collect(), timing as timed:
            if profiler:
                profiler.enable()
            ok, tracking = atk.simulate_hqc_idealized_oracle(
                make_random_state(args.seed),
                args.decode_every,
                args.code_weight,
                args.key_file,
                0.0,
                args.param_set,
                max_oracle_calls=args.max_oracle_calls,
                decode_backend=args.decode_backend,
                device=device,
            )
            if device.type == "cuda":
                torch.cuda.synchronize()
    finally:
        if profiler:
            profiler.disable()
        wall = time.perf_counter() - t0

    # the batched candidate probes (query_candidates) bypass _raw under the
    # fast backend; under another backend a _raw inside them is counted once
    recorded = spans.snapshot()
    acc = {phase: recorded["spans"].get(f"attack.{phase}", {"host_s": 0.0})["host_s"]
           for phase in ("decode", "decode.build", "decode.stats", "oracle", "flip")}
    calls = {n: recorded["counters"].get(f"attack.{n}", 0) for n in ("decodes", "raw_queries", "flips")}
    k8_s = timed.seconds() if timed else None
    artifact = {
        "experiment": "hqc_attack_phase_profile",
        "param_set": args.param_set,
        "code_weight": args.code_weight,
        "decode_every": args.decode_every,
        "decode_backend": args.decode_backend,
        "p_bucket": None,
        "platform": device.type,
        "device": str(device),
        "key_file": args.key_file,
        "seed": args.seed,
        "success": bool(ok),
        "wall_seconds": wall,
        "decode_seconds": acc["decode"],
        "oracle_seconds": acc["oracle"],
        "other_seconds": wall - acc["decode"] - acc["oracle"],
        "decode_share": acc["decode"] / wall,
        "oracle_share": acc["oracle"] / wall,
        "num_decodes": calls["decodes"],
        "num_raw_queries": calls["raw_queries"],
        "oracle_calls": tracking.num_oracle_calls,
        "seconds_per_decode": acc["decode"] / max(calls["decodes"], 1),
        "decode_build_seconds": acc["decode.build"],
        "decode_stats_seconds": acc["decode.stats"],
        "k8_seconds": k8_s,
        "k8_launches": len(timed.events) if timed else None,
        "decode_rest_seconds": acc["decode"] - acc["decode.build"] - acc["decode.stats"] - (k8_s or 0.0),
        "oracle_flip_seconds": acc["flip"],
        "num_flips": calls["flips"],
    }
    if profiler:
        import pstats

        stats = pstats.Stats(profiler)
        top = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:args.cprofile]
        artifact["cprofile_top"] = [
            {"function": f"{os.path.relpath(f) if f.startswith('/') else f}:{line}({name})", "calls": nc,
             "own_seconds": tt, "cumulative_seconds": ct}
            for (f, line, name), (_cc, nc, tt, ct, _callers) in top
        ]
    return artifact


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--param-set", default="256")
    ap.add_argument("--code-weight", type=int, default=30)
    ap.add_argument("--decode-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--key-file", default=None,
                    help="serialized key (created if missing); default: a fresh key from the OS")
    ap.add_argument("--decode-backend", default="circulant",
                    choices=["general", "padded", "circulant"])
    ap.add_argument("--device", default="cuda",
                    help="device of the decodes: 'cuda' (raises without a card) or 'cpu'")
    ap.add_argument("--max-oracle-calls", type=int, default=None)
    ap.add_argument("--cprofile", type=int, default=0,
                    help="also list the N functions with the most own time under cProfile")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    artifact = profile(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact, indent=1))
    return artifact


if __name__ == "__main__":
    main()
