#!/usr/bin/env python
"""Phase-profile a single-instance HQC key recovery.

Measures where the attack's wall time goes — periodic LDPC decodes vs
raw oracle probes vs host control flow — for any parameter set / decode
backend (the JAX package's ``scripts/attack_phase_profile.py``, on the
port's classes, wrapped in place).

Phases:
- decode:  decoder.decode() wall (host array building + device call +
           result fetch); inside it, the array building
           (``build_masked_arrays`` / ``build_arrays``), the statistics
           (``stats_from_masked`` / ``stats_from_decoded``) and, for
           ``circulant`` on a CUDA device, K8's own device time (CUDA
           events around each launch); the rest of the decode is copies,
           launch overhead and host syncs
- oracle:  HqcOracle._raw / HqcOracle.query_candidates (the idealized
           fast-oracle spectrum updates, host numpy)
- other:   everything else (search control flow, bookkeeping); inside it,
           the ciphertext mutations ``HqcOracle.flip_block`` /
           ``flip_bit`` (under the fast backend each updates the
           Walsh-spectrum state) as ``oracle_flip_seconds``

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


class _Phases:
    """Wall-time accumulators for methods wrapped in place; a method called
    inside another of the same phase is counted once."""

    def __init__(self):
        self.seconds, self.calls, self._depth, self._undo = {}, {}, {}, []

    def wrap(self, cls, name, phase, count=None):
        orig = cls.__dict__[name]
        self.seconds.setdefault(phase, 0.0)
        self._depth.setdefault(phase, 0)
        if count:
            self.calls.setdefault(count, 0)

        def timed(*a, **k):
            if count:
                self.calls[count] += 1
            if self._depth[phase]:
                return orig(*a, **k)
            self._depth[phase] += 1
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                self.seconds[phase] += time.perf_counter() - t0
                self._depth[phase] -= 1

        setattr(cls, name, timed)
        self._undo.append((cls, name, orig))

    def restore(self):
        for cls, name, orig in reversed(self._undo):
            setattr(cls, name, orig)
        self._undo.clear()


def profile(args):
    """Run the attack with the phases wrapped; returns the artifact."""
    import torch

    import sca_ldpc_tpu_torch.models.hqc.attack as atk
    from sca_ldpc_tpu_torch.ops.kernels import circulant_cuda
    from sca_ldpc_tpu_torch.utils import make_random_state
    from sca_ldpc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    decoder_cls = {
        "circulant": atk.MaskedCirculantCheckDecoder,
        "padded": atk.PaddedCheckDecoder,
        "general": atk.CheckDecoder,
    }[args.decode_backend]
    phases = _Phases()
    phases.wrap(decoder_cls, "decode", "decode", count="n_decodes")
    if args.decode_backend == "circulant":
        phases.wrap(atk.MaskedCirculantCheckDecoder, "build_masked_arrays", "build")
        phases.wrap(atk.MaskedCirculantCheckDecoder, "stats_from_masked", "stats")
    else:
        phases.wrap(atk.CheckDecoder, "build_arrays", "build")
    phases.wrap(atk.CheckDecoder, "stats_from_decoded", "stats")
    # the batched candidate probes (query_candidates) bypass _raw under the
    # fast backend; under another backend a _raw inside them is counted once
    phases.wrap(atk.HqcOracle, "_raw", "oracle", count="n_raw")
    phases.wrap(atk.HqcOracle, "query_candidates", "oracle")
    phases.wrap(atk.HqcOracle, "flip_block", "flip", count="n_flips")
    phases.wrap(atk.HqcOracle, "flip_bit", "flip", count="n_flips")
    timing = contextlib.nullcontext()
    if device.type == "cuda" and args.decode_backend == "circulant":
        timing = circulant_cuda.timed_multi_decodes()

    profiler = None
    if args.cprofile:
        import cProfile

        profiler = cProfile.Profile()
    t0 = time.perf_counter()
    try:
        with timing as timed:
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
        phases.restore()

    acc, calls = phases.seconds, phases.calls
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
        "num_decodes": calls["n_decodes"],
        "num_raw_queries": calls["n_raw"],
        "oracle_calls": tracking.num_oracle_calls,
        "seconds_per_decode": acc["decode"] / max(calls["n_decodes"], 1),
        "decode_build_seconds": acc["build"],
        "decode_stats_seconds": acc["stats"],
        "k8_seconds": k8_s,
        "k8_launches": len(timed.events) if timed else None,
        "decode_rest_seconds": acc["decode"] - acc["build"] - acc["stats"] - (k8_s or 0.0),
        "oracle_flip_seconds": acc["flip"],
        "num_flips": calls["n_flips"],
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
