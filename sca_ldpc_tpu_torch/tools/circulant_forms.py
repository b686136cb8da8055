"""Time the port's circulant kernels against their forms before the Hopper
redesigns, on one NVIDIA GPU, in one process: K1 (``circulant_bp.cu``'s FER
step) and the lean kernel K3/K4 (``circulant_lean.cu``'s decode and FER step).

The earlier sources are ``sca_ldpc_tpu_torch/csrc/circulant_bp.cu`` as of commit
7f3dcaf, whose ``circulant_fer_step`` takes ``c2v [B, w, N]`` and ``tot [B, N]``
and no launch configuration, and ``sca_ldpc_tpu_torch/csrc/circulant_lean.cu`` as
of commit cef7e57, whose entry points take two plane arrays ``v2c`` and ``c2v
[B, w, N]``, ``acc_phi``, ``acc_neg`` and ``tot [B, N]`` and no launch
configuration; this script binds those interfaces.  Write them into the
git-ignored ``build/`` from a checkout with history, then run the script (the
card's machine needs no git):

    mkdir -p build/k1_old build/lean_old
    git show 7f3dcaf:sca_ldpc_tpu_torch/csrc/circulant_bp.cu > build/k1_old/circulant_bp.cu
    git show cef7e57:sca_ldpc_tpu_torch/csrc/circulant_lean.cu > build/lean_old/circulant_lean.cu
    python3 -m sca_ldpc_tpu_torch.tools.circulant_forms --out build/k1_forms.json

Each is compiled with the package's nvcc flags beside the current source.
``--kernels k1`` or ``--kernels lean`` runs one of the two parts.

K1, for each cell (HQC-128 at batch 4096 and 512, HQC-192 and HQC-256 at batch
2048; error rate 0.01, product-sum, up to 30 iterations, errors sampled on the
card from a fixed seed): checks that both forms give the same success and
convergence flags, times a step of each in turns (old, new, new, old; CUDA
events, best of 3 after a warm-up), records each one's peak device memory, and
sweeps max_iter over 0-3 (set-up, first and later iterations).  The bound of
each step comes from the frames' own iteration counts (``circulant_bp_cuda`` on
the same frames), less the first, and ``ops/kernels/bounds.py``.

The lean kernel, for the three FER cells (HQC-128 at batch 4096, HQC-192 and
HQC-256 at 2048, rate 0.01, up to 30 iterations) and for 8192 hard HQC-128
frames at rate 0.05 with up to 50 iterations: checks that both forms give the
same flags (K4) and the same decisions, flags and per-frame iteration counts
(K3) on every frame, times K4 and K3 in the same turns, records peak memory,
and sweeps K4's max_iter over 0-3.

``--variant PATH`` (repeatable) also compiles another source that has the
current ``circulant_lean.cu``'s interface, says whether its flags equal the
current kernel's on each FER cell, and sweeps its K4 beside the current one's:
the way to try a tuning of the kernel before it replaces the source.

Prints one line per cell and writes everything as JSON, with the ptxas reports
of the builds beside it.  Exits non-zero if any cell's forms disagree.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..codes import CirculantLayout, random_circulant_first_row
from ..ops.kernels import _build, circulant_cuda
from ..ops.kernels.bounds import circulant_bound_ms
from ..ops.kernels.circulant_cuda import (
    circulant_bp_cuda,
    circulant_bp_lean_cuda,
    circulant_fer_cuda,
    circulant_fer_lean_cuda,
)
from ..utils import make_random_state

RATE, MAX_ITER = 0.01, 30
CELLS = (("HQC-128", 17669, 20, 4096), ("HQC-128", 17669, 20, 512), ("HQC-192", 35851, 30, 2048),
         ("HQC-256", 57637, 30, 2048))
# (cell, N, w, batch, error rate, max_iter)
LEAN_CELLS = (("HQC-128", 17669, 20, 4096, RATE, MAX_ITER), ("HQC-192", 35851, 30, 2048, RATE, MAX_ITER),
              ("HQC-256", 57637, 30, 2048, RATE, MAX_ITER), ("HQC-128 hard", 17669, 20, 8192, 0.05, 50))


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _compile_old(src, name):
    """Compile an earlier source with the package's flags; returns (lib, ptxas log)."""
    data = Path(src).read_bytes()
    out = _build.BUILD_DIR / f"lib{name}_old-{hashlib.sha256(data).hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def _build_old(src):
    """K1's earlier form; returns (lib, ptxas log)."""
    lib, log = _compile_old(src, "circulant_bp")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.circulant_fer_step.argtypes = [p, f, p, i, i, i, i, i, p, p, p, p, p, p, p]
    lib.circulant_fer_step.restype = i
    return lib, log


def _build_old_lean(src):
    """The lean kernel's earlier form; returns (lib, ptxas log)."""
    lib, log = _compile_old(src, "circulant_lean")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.circulant_bp_lean_decode.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p, p, p, p, p]
    lib.circulant_bp_lean_decode.restype = i
    lib.circulant_fer_lean_step.argtypes = [p, f, p, i, i, i, i, p, p, p, p, p, p, p, p, p, p]
    lib.circulant_fer_lean_step.restype = i
    return lib, log


def _build_variant(src):
    """Another source with the current lean interface; returns (lib, ptxas log)."""
    lib, log = _compile_old(src, "circulant_lean_" + Path(src).stem)
    for name in ("circulant_bp_lean_decode", "circulant_fer_lean_step"):
        current = getattr(circulant_cuda._lean_lib(), name)
        getattr(lib, name).argtypes, getattr(lib, name).restype = current.argtypes, current.restype
    return lib, log


def _with_lean_lib(lib, fn):
    """Run ``fn()`` with the lean wrappers launching ``lib``'s kernels."""
    saved = circulant_cuda._lean_lib
    circulant_cuda._lean_lib = lambda: lib
    try:
        return fn()
    finally:
        circulant_cuda._lean_lib = saved


def _old_lean_state(b, w, n, dev):
    """The earlier lean form's scratch: v2c, c2v [B, w, N] bf16, acc_phi [B, N]
    f32, acc_neg [B, N] u8, tot [B, N] f32."""
    return (*(torch.empty((b, w, n), dtype=torch.bfloat16, device=dev) for _ in range(2)),
            torch.empty((b, n), dtype=torch.float32, device=dev), torch.empty((b, n), dtype=torch.uint8, device=dev),
            torch.empty((b, n), dtype=torch.float32, device=dev))


def _old_lean_fer(lib, errors, shifts, rate, max_iter):
    """The earlier form's K4 (its own wrapper)."""
    b, n2 = errors.shape
    n, w, dev = n2 // 2, len(shifts), errors.device
    k = torch.tensor(shifts, dtype=torch.int32, device=dev)
    state = _old_lean_state(b, w, n, dev)
    syn = torch.empty((b, n), dtype=torch.uint8, device=dev)
    e = torch.empty((b, 2 * n), dtype=torch.uint8, device=dev)
    ok = torch.empty((b,), dtype=torch.uint8, device=dev)
    conv = torch.empty((b,), dtype=torch.uint8, device=dev)
    rc = lib.circulant_fer_lean_step(errors.data_ptr(), float(np.log((1 - rate) / rate)), k.data_ptr(), w, n, b,
                                     int(max_iter), *(x.data_ptr() for x in state), syn.data_ptr(), e.data_ptr(),
                                     ok.data_ptr(), conv.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old circulant_fer_lean_step failed: CUDA error {rc}")
    return ok.bool(), conv.bool()


def _old_lean_bp(lib, prior_c, prior_i, syndrome, shifts, max_iter):
    """The earlier form's K3 (its own wrapper)."""
    b, n = prior_c.shape
    w, dev = len(shifts), prior_c.device
    k = torch.tensor(shifts, dtype=torch.int32, device=dev)
    syn = syndrome.to(torch.uint8).contiguous()
    state = _old_lean_state(b, w, n, dev)
    e = torch.empty((b, 2 * n), dtype=torch.uint8, device=dev)
    conv = torch.empty((b,), dtype=torch.uint8, device=dev)
    iters = torch.empty((b,), dtype=torch.int32, device=dev)
    rc = lib.circulant_bp_lean_decode(prior_c.data_ptr(), prior_i.data_ptr(), syn.data_ptr(), k.data_ptr(), w, n, b,
                                      int(max_iter), *(x.data_ptr() for x in state), e.data_ptr(), conv.data_ptr(),
                                      iters.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old circulant_bp_lean_decode failed: CUDA error {rc}")
    return e.to(torch.int32), conv.bool(), iters


def _old_fer(lib, errors, shifts, rate, max_iter):
    """The earlier form's FER step (its own wrapper, product-sum)."""
    b, n2 = errors.shape
    n, w, dev = n2 // 2, len(shifts), errors.device
    k = torch.tensor(shifts, dtype=torch.int32, device=dev)
    c2v = torch.empty((b, w, n), dtype=torch.float32, device=dev)
    tot = torch.empty((b, n), dtype=torch.float32, device=dev)
    syn = torch.empty((b, n), dtype=torch.uint8, device=dev)
    e = torch.empty((b, 2 * n), dtype=torch.uint8, device=dev)
    ok = torch.empty((b,), dtype=torch.uint8, device=dev)
    conv = torch.empty((b,), dtype=torch.uint8, device=dev)
    rc = lib.circulant_fer_step(errors.data_ptr(), float(np.log((1 - rate) / rate)), k.data_ptr(), w, n, b,
                                int(max_iter), 0, c2v.data_ptr(), tot.data_ptr(), syn.data_ptr(), e.data_ptr(),
                                ok.data_ptr(), conv.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old circulant_fer_step failed: CUDA error {rc}")
    return ok.bool(), conv.bool()


def _ms(fn, repeats=3):
    fn()
    best = float("inf")
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _peak_gb(fn, dev):
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated(dev) - base) / 1e9


def _ptxas(log):
    return [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]


def _code(codes, n, w):
    if n not in codes:
        codes[n] = CirculantLayout.from_first_row(random_circulant_first_row(n, w, make_random_state(0)), True)
    return codes[n]


def _turns(old, new):
    """Times in turns old, new, new, old; returns (turns, best old, best new)."""
    turns = [("old", _ms(old)), ("new", _ms(new)), ("new", _ms(new)), ("old", _ms(old))]
    return turns, min(t for k, t in turns if k == "old"), min(t for k, t in turns if k == "new")


def _sweep(fn):
    t = [_ms(lambda m=m: fn(m)) for m in range(4)]
    return {"ms_at_max_iter_0_1_2_3": t, "set_up": t[0], "first": t[1] - t[0], "later": (t[3] - t[1]) / 2}


def _sweep_line(sweep):
    return " ".join(f"{label} {[round(sweep[label][k], 3) for k in ('set_up', 'first', 'later')]}" for label in sweep)


def _k1_cells(old_lib, codes, dev, card):
    cells = []
    for name, n, w, batch in CELLS:
        lay = _code(codes, n, w)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1000 + batch)
        errors = (torch.rand((batch, 2 * n), generator=gen, device=dev) < RATE).to(torch.uint8)

        def new(max_iter=MAX_ITER):
            return circulant_fer_cuda(errors, lay.shifts, RATE, max_iter)

        def old(max_iter=MAX_ITER):
            return _old_fer(old_lib, errors, lay.shifts, RATE, max_iter)

        ok_n, conv_n = new()
        ok_o, conv_o = old()
        same = torch.equal(ok_n, ok_o) and torch.equal(conv_n, conv_o)
        syn = (sum(torch.roll(errors[:, :n].int(), k, dims=-1) for k in lay.shifts) + errors[:, n:]) % 2
        prior = torch.full((batch, n), float(np.log((1 - RATE) / RATE)), dtype=torch.float32, device=dev)
        iters = int(circulant_bp_cuda(prior, prior, syn, lay.shifts, MAX_ITER, "product_sum")[2].sum())
        # the first iteration needs no phi a message under the step's one constant prior
        bound, bound_by = circulant_bound_ms(iters - batch, w, n, batch * 2 * n + 2 * batch)
        turns, t_old, t_new = _turns(old, new)
        cell = {"cell": name, "kernel": "K1", "n": n, "w": w, "batch": batch, "flags_equal": same,
                "successes": int(ok_n.sum()), "iterations_per_frame": iters / batch,
                "turns_ms": turns, "old_ms": t_old, "new_ms": t_new, "speedup": t_old / t_new,
                "bound_ms": bound, "bound_by": bound_by, "new_share_of_bound": bound / t_new,
                "old_share_of_bound": bound / t_old,
                "peak_gb_old": _peak_gb(old, dev), "peak_gb_new": _peak_gb(new, dev)}
        if batch == max(c[3] for c in CELLS if c[1] == n):
            cell["sweep"] = {"old": _sweep(old), "new": _sweep(new)}
        cells.append(cell)
        print(f"K1 {name} batch {batch}: flags equal {same}, successes {cell['successes']}/{batch}, "
              f"{cell['iterations_per_frame']:.3f} iterations a frame; old {t_old:.3f} ms, new {t_new:.3f} ms "
              f"({cell['speedup']:.2f}x); bound {bound:.3f} ms ({bound_by}), new at {100 * bound / t_new:.1f}% "
              f"of it; peak {cell['peak_gb_old']:.2f} / {cell['peak_gb_new']:.2f} GB [{card}]")
        if "sweep" in cell:
            print(f"  sweep (set-up, first, later ms): {_sweep_line(cell['sweep'])}")
    return cells


def _lean_cells(old_lib, codes, dev, card, variants=()):
    cells = []
    for name, n, w, batch, rate, max_iter in LEAN_CELLS:
        lay = _code(codes, n, w)
        gen = torch.Generator(device=dev)
        gen.manual_seed(2000 + batch)
        errors = (torch.rand((batch, 2 * n), generator=gen, device=dev) < rate).to(torch.uint8)
        syn = ((sum(torch.roll(errors[:, :n].int(), k, dims=-1) for k in lay.shifts) + errors[:, n:]) % 2).to(torch.uint8)
        prior = torch.full((batch, n), float(np.log((1 - rate) / rate)), dtype=torch.float32, device=dev)

        def new(m=max_iter):
            return circulant_fer_lean_cuda(errors, lay.shifts, rate, m)

        def old(m=max_iter):
            return _old_lean_fer(old_lib, errors, lay.shifts, rate, m)

        def new_bp():
            return circulant_bp_lean_cuda(prior, prior, syn, lay.shifts, max_iter)

        def old_bp():
            return _old_lean_bp(old_lib, prior, prior, syn, lay.shifts, max_iter)

        ok_n, conv_n = new()
        ok_o, conv_o = old()
        e_n, bconv_n, it_n = new_bp()
        e_o, bconv_o, it_o = old_bp()
        flags = torch.equal(ok_n, ok_o) and torch.equal(conv_n, conv_o) and torch.equal(bconv_n, bconv_o)
        same = flags and torch.equal(it_n, it_o) and torch.equal(e_n, e_o) and torch.equal(conv_n, bconv_n)
        iters = int(it_n.sum())
        del e_n, e_o
        # K4's first iteration needs no phi a message under its one constant prior
        bound, bound_by = circulant_bound_ms(iters - batch, w, n, batch * 2 * n + 2 * batch)
        bound_bp, _ = circulant_bound_ms(iters, w, n, batch * (17 * n + 5))  # priors, u8 syndrome, int32 decisions
        turns, t_old, t_new = _turns(old, new)
        bp_turns, bp_old, bp_new = _turns(old_bp, new_bp)
        cell = {"cell": name, "kernel": "K3/K4", "n": n, "w": w, "batch": batch, "rate": rate, "max_iter": max_iter,
                "flags_equal": flags, "flags_iters_decisions_equal": same,
                "successes": int(ok_n.sum()), "converged": int(conv_n.sum()), "iterations_per_frame": iters / batch,
                "turns_ms": turns, "old_ms": t_old, "new_ms": t_new, "speedup": t_old / t_new,
                "bound_ms": bound, "bound_by": bound_by, "new_share_of_bound": bound / t_new,
                "old_share_of_bound": bound / t_old,
                "k3_turns_ms": bp_turns, "k3_old_ms": bp_old, "k3_new_ms": bp_new, "k3_bound_ms": bound_bp,
                "peak_gb_old": _peak_gb(old, dev), "peak_gb_new": _peak_gb(new, dev),
                "sweep": {"old": _sweep(old), "new": _sweep(new)}}
        cells.append(cell)
        print(f"K4 {name} batch {batch} rate {rate}, {max_iter} iterations: flags, iters and decisions equal {same}, "
              f"successes {cell['successes']}/{batch}, {cell['iterations_per_frame']:.3f} iterations a frame; old "
              f"{t_old:.3f} ms, new {t_new:.3f} ms ({cell['speedup']:.2f}x); bound {bound:.3f} ms ({bound_by}), new at "
              f"{100 * bound / t_new:.1f}% of it; K3 old {bp_old:.3f} ms, new {bp_new:.3f} ms, bound {bound_bp:.3f}; "
              f"peak {cell['peak_gb_old']:.2f} / {cell['peak_gb_new']:.2f} GB [{card}]")
        for label, lib in variants:
            ok_v, conv_v = _with_lean_lib(lib, new)
            cell["sweep"][label] = _with_lean_lib(lib, lambda: _sweep(new))
            cell["sweep"][label]["step_ms"] = _with_lean_lib(lib, lambda: _ms(new))
            cell["sweep"][label]["flags_equal"] = torch.equal(ok_v, ok_n) and torch.equal(conv_v, conv_n)
        print(f"  sweep (set-up, first, later ms): {_sweep_line(cell['sweep'])}")
        for label, _ in variants:
            v = cell["sweep"][label]
            print(f"  variant {label}: step {v['step_ms']:.3f} ms, flags equal to the current kernel: {v['flags_equal']}")
    return cells


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default="build/k1_old/circulant_bp.cu", help="the earlier circulant_bp.cu")
    ap.add_argument("--old-lean", default="build/lean_old/circulant_lean.cu", help="the earlier circulant_lean.cu")
    ap.add_argument("--kernels", choices=("k1", "lean", "both"), default="both")
    ap.add_argument("--variant", action="append", default=[], metavar="PATH",
                    help="another source with the current circulant_lean.cu's interface, swept beside it")
    ap.add_argument("--out", default="build/k1_forms.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("circulant_forms: no CUDA device", file=sys.stderr)
        return 1
    parts = [(key, src) for key, src in (("k1", args.old), ("lean", args.old_lean)) if args.kernels in (key, "both")]
    for _, src in parts:
        if not Path(src).is_file():
            print(f"circulant_forms: no earlier source at {src}; write it with git show (see the module's "
                  "docstring)", file=sys.stderr)
            return 1
    dev = torch.device("cuda:0")
    card = _card()
    print(card)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    results = {"card": card, "torch": torch.__version__, "cells": []}
    codes = {}
    for key, src in parts:
        old_lib, old_log = (_build_old if key == "k1" else _build_old_lean)(src)
        new_log = _build.build("circulant_bp" if key == "k1" else "circulant_lean").with_suffix(".log").read_text()
        out.with_name(f"{out.stem}_{key}_ptxas_old.log").write_text(old_log)
        out.with_name(f"{out.stem}_{key}_ptxas_new.log").write_text(new_log)
        if key == "k1":
            results["cells"] += _k1_cells(old_lib, codes, dev, card)
        else:
            variants = []
            for path in args.variant:
                lib, log = _build_variant(path)
                variants.append((Path(path).stem, lib))
                print(f"ptxas variant {Path(path).stem}:", " | ".join(_ptxas(log)))
            results["cells"] += _lean_cells(old_lib, codes, dev, card, variants)
        print(f"ptxas {key} old:", " | ".join(_ptxas(old_log)))
        print(f"ptxas {key} new:", " | ".join(_ptxas(new_log)))
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    bad = [f"{c['kernel']} {c['cell']}" for c in results["cells"]
           if not c.get("flags_iters_decisions_equal", c["flags_equal"])
           or (c.get("rate", RATE) == RATE and c["successes"] < 0.999 * c["batch"])]
    if bad:
        print(f"circulant_forms: the forms disagree, or frames were lost, in {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
