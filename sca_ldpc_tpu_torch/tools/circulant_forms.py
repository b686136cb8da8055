"""Time the port's circulant FER-step kernel K1 against its form before the
Hopper redesign, on one NVIDIA GPU, in one process.

The earlier source is ``sca_ldpc_tpu_torch/csrc/circulant_bp.cu`` as of commit
7f3dcaf, whose ``circulant_fer_step`` takes ``c2v [B, w, N]`` and ``tot [B, N]``
and no launch configuration; this script binds that interface.  Write it into
the git-ignored ``build/`` from a checkout with history, then run the script
(the card's machine needs no git):

    mkdir -p build/k1_old
    git show 7f3dcaf:sca_ldpc_tpu_torch/csrc/circulant_bp.cu > build/k1_old/circulant_bp.cu
    python3 -m sca_ldpc_tpu_torch.tools.circulant_forms --out build/k1_forms.json

It is compiled with the package's nvcc flags beside the current source.  For each cell (HQC-128 at batch 4096 and
512, HQC-192 and HQC-256 at batch 2048; error rate 0.01, product-sum, up to 30
iterations, errors sampled on the card from a fixed seed) the script checks
that both forms give the same success and convergence flags, times a step of
each in turns (old, new, new, old; CUDA events, best of 3 after a warm-up),
records each one's peak device memory, and sweeps max_iter over 0-3 (set-up,
first and later iterations).  The bound of each step comes from the frames'
own iteration counts (``circulant_bp_cuda`` on the same frames), less the
first, and ``ops/kernels/bounds.py``.  Prints one line per cell and writes
everything as JSON, with the ptxas reports of both builds beside it.
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
from ..ops.kernels import _build
from ..ops.kernels.bounds import circulant_bound_ms
from ..ops.kernels.circulant_cuda import circulant_bp_cuda, circulant_fer_cuda
from ..utils import make_random_state

RATE, MAX_ITER = 0.01, 30
CELLS = (("HQC-128", 17669, 20, 4096), ("HQC-128", 17669, 20, 512), ("HQC-192", 35851, 30, 2048),
         ("HQC-256", 57637, 30, 2048))


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _build_old(src):
    """Compile the earlier source with the package's flags; returns (lib, ptxas log)."""
    data = Path(src).read_bytes()
    out = _build.BUILD_DIR / f"libcirculant_bp_old-{hashlib.sha256(data).hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.circulant_fer_step.argtypes = [p, f, p, i, i, i, i, i, p, p, p, p, p, p, p]
    lib.circulant_fer_step.restype = i
    return lib, proc.stdout + proc.stderr


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default="build/k1_old/circulant_bp.cu", help="the earlier circulant_bp.cu")
    ap.add_argument("--out", default="build/k1_forms.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("circulant_forms: no CUDA device", file=sys.stderr)
        return 1
    if not Path(args.old).is_file():
        print(f"circulant_forms: no earlier source at {args.old}; write it with git show (see the module's "
              "docstring)", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = _card()
    print(card)
    old_lib, old_log = _build_old(args.old)
    new_log = _build.build("circulant_bp").with_suffix(".log").read_text()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.with_name(out.stem + "_ptxas_old.log").write_text(old_log)
    out.with_name(out.stem + "_ptxas_new.log").write_text(new_log)
    results = {"card": card, "torch": torch.__version__, "cells": []}
    codes = {}
    for name, n, w, batch in CELLS:
        if n not in codes:
            lay = CirculantLayout.from_first_row(random_circulant_first_row(n, w, make_random_state(0)), True)
            codes[n] = lay
            sweep = {}
        lay = codes[n]
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
        turns = [("old", _ms(old)), ("new", _ms(new)), ("new", _ms(new)), ("old", _ms(old))]
        t_old = min(t for k, t in turns if k == "old")
        t_new = min(t for k, t in turns if k == "new")
        cell = {"cell": name, "n": n, "w": w, "batch": batch, "flags_equal": same,
                "successes": int(ok_n.sum()), "iterations_per_frame": iters / batch,
                "turns_ms": turns, "old_ms": t_old, "new_ms": t_new, "speedup": t_old / t_new,
                "bound_ms": bound, "bound_by": bound_by, "new_share_of_bound": bound / t_new,
                "old_share_of_bound": bound / t_old,
                "peak_gb_old": _peak_gb(old, dev), "peak_gb_new": _peak_gb(new, dev)}
        if batch == max(c[3] for c in CELLS if c[1] == n):
            for label, fn in (("old", old), ("new", new)):
                t = [_ms(lambda m=m: fn(m)) for m in range(4)]
                sweep[label] = {"ms_at_max_iter_0_1_2_3": t, "set_up": t[0], "first": t[1] - t[0],
                                "later": (t[3] - t[1]) / 2}
            cell["sweep"] = sweep
        results["cells"].append(cell)
        print(f"{name} batch {batch}: flags equal {same}, successes {cell['successes']}/{batch}, "
              f"{cell['iterations_per_frame']:.3f} iterations a frame; old {t_old:.3f} ms, new {t_new:.3f} ms "
              f"({cell['speedup']:.2f}x); bound {bound:.3f} ms ({bound_by}), new at {100 * bound / t_new:.1f}% "
              f"of it; peak {cell['peak_gb_old']:.2f} / {cell['peak_gb_new']:.2f} GB [{card}]")
        if "sweep" in cell:
            print(f"  sweep (set-up, first, later ms): old {[round(sweep['old'][k], 3) for k in ('set_up', 'first', 'later')]}"
                  f" new {[round(sweep['new'][k], 3) for k in ('set_up', 'first', 'later')]}")
    print("ptxas old:", " | ".join(_ptxas(old_log)))
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    bad = [c["cell"] for c in results["cells"] if not c["flags_equal"] or c["successes"] < 0.999 * c["batch"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
