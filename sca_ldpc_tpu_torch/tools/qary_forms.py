"""Time the port's Kyber decode kernel K7 (``qary_min_sum.cu``'s
``qary_special_min_sum_fused``) against its form before the Hopper redesign,
on one NVIDIA GPU, in one process.

The earlier source is ``sca_ldpc_tpu_torch/csrc/qary_min_sum.cu`` as of commit
f75bded, whose K7 entry point takes no launch configuration (8 warps a block,
one instance).  Write it into the git-ignored ``build/`` from a checkout with
history, then run the script (the card's machine needs no git):

    mkdir -p build/qary_old
    git show f75bded:sca_ldpc_tpu_torch/csrc/qary_min_sum.cu > build/qary_old/qary_min_sum.cu
    python3 -m sca_ldpc_tpu_torch.tools.qary_forms --out build/qary_forms.json

It is compiled with the package's nvcc flags beside the current source.  The
cells are DecoderN1280R512SW6 (``gen_ldpc_matrix(6, seed 0, check_blocks=2)``)
at eta = 2 and 3, 10 iterations: 512 frames of the Dirichlet channels that
``chip_smoke.py`` phase 8 makes (its seed, in its order), and 4096 frames of
Dirichlet channels from another seed (K7's time does not depend on the
values: fixed iterations, no branch on data).  For each cell: checks that both
forms give the same ``hard_b`` and ``hard_s`` on every frame, times them in
turns (old, new, new, old; CUDA events, best of 3 after a warm-up), sweeps
``max_iter`` over 0, 1 and 2 (set-up, the last iteration, and each earlier
one), and times the current kernel at every one of its instances whose block
fits the card (``SPECIAL_WARPS``), each checked against the chosen one.  Both
forms are called through their C entry points (the wrapper's argument checks,
about 0.2 ms a call with a host sync, are timed by ``chip_smoke.py``).

``--variant PATH`` (repeatable) also compiles an edited copy of either
source (told apart by ``qary_special_fused_occupancy``, which only the current
interface has), says on each cell whether its decisions equal the current
kernel's, and times it; a copy with the current interface runs at every
instance whose block, by the copy's own count of shared memory, fits.  The
way to read what bounds the kernel (an edited copy gives wrong decisions and
only its time is read) or to try a tuning before it replaces the source.

Prints one line per cell and writes everything as JSON, with the ptxas reports
of the builds beside it.  Exits non-zero if the forms or the instances
disagree on any frame.
"""

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..channels import probs_to_llr
from ..models.kyber import gen_ldpc_matrix
from ..ops import QarySpecialDecoder, minplus
from ..ops.kernels import _build
from ..ops.kernels.bounds import chain_bound_ms
from ..ops.kernels.circulant_cuda import smem_limits
from ..ops.kernels import qary_cuda
from ..ops.kernels.qary_cuda import SPECIAL_WARPS, special_fused_launch, special_fused_ptxas
from ..ops.qary import _signed
from .circulant_forms import _card, _compile_old, _ms, _ptxas, _turns

SW, ITERS, SMOKE_SEED = 6, 10, 5678
# (cell, eta, frames); the 512-frame cells are chip_smoke.py phase 8's inputs
CELLS = (("eta 2, 512 frames", 2, 512), ("eta 2, batch 4096", 2, 4096), ("eta 3, 512 frames", 3, 512),
         ("eta 3, batch 4096", 3, 4096))


class _Lib:
    """A built K7 source: its library and whether it has the current
    interface (a warp count a block)."""

    def __init__(self, lib, log):
        self.lib, self.log = lib, log
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.current = hasattr(self.lib, "qary_special_fused_occupancy")
        self.lib.qary_special_min_sum_fused.argtypes = [p] * 8 + [i] * (9 if self.current else 8) + [p, p, p]
        self.lib.qary_special_min_sum_fused.restype = i
        self.lib.qary_special_fused_smem_bytes.argtypes = [i] * (6 if self.current else 5)
        self.lib.qary_special_fused_smem_bytes.restype = ll

    @classmethod
    def compile(cls, src):
        return cls(*_compile_old(src, "qary_min_sum_" + Path(src).stem))

    def instances(self, n_b, r, eta, bsum, dev):
        """The warp counts whose block fits the card by this source's own
        count (None: the earlier form's one launch)."""
        if not self.current:
            return [None]
        smem_block = smem_limits(dev)[0]
        return [w for w in SPECIAL_WARPS if self.lib.qary_special_fused_smem_bytes(n_b, r, SW, eta, bsum, w) <= smem_block]

    def __call__(self, args, eta, bsum, max_iter, warps=None):
        llr_b, llr_s, vsum, bvar_idx, bvar_sign, bvar_mask, var_flat, sum_sign = args
        bt, n_b, _ = llr_b.shape
        r, dv = bvar_idx.shape[0], var_flat.shape[1]
        hard_b = torch.empty((bt, n_b), dtype=torch.int32, device=llr_b.device)
        hard_s = torch.empty((bt, r), dtype=torch.int32, device=llr_b.device)
        rc = self.lib.qary_special_min_sum_fused(*(x.data_ptr() for x in args), bt, n_b, r, SW, dv, eta, bsum,
                                                 int(max_iter), *(() if warps is None else (warps,)),
                                                 hard_b.data_ptr(), hard_s.data_ptr(),
                                                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"qary_special_min_sum_fused (warps {warps}) failed: CUDA error {rc}")
        return hard_b, hard_s


def _inputs(H, dec, eta, frames, rng, dev):
    """K7's inputs as phase 8 makes them: clipped LLRs of Dirichlet channels,
    the sum channel in row order and its signed form, the adjacency."""
    bsum = SW * eta
    r = H.shape[0]
    probs_b = rng.dirichlet(np.ones(2 * eta + 1), size=(frames, H.shape[1] - r)).astype(np.float32)
    probs_s = rng.dirichlet(np.ones(2 * bsum + 1), size=(frames, r)).astype(np.float32)
    llr_b = minplus.clip_inf(probs_to_llr(torch.from_numpy(probs_b).to(dev))).contiguous()
    llr_s = minplus.clip_inf(probs_to_llr(torch.from_numpy(probs_s).to(dev)))
    llr_s = llr_s.index_select(1, dec._sum_var).contiguous()
    return (llr_b, llr_s, _signed(llr_s, dec._args[6]).contiguous(), *dec._args[:4], dec._args[6])


def _sweep(fn):
    t = [_ms(lambda m=m: fn(m)) for m in range(3)]
    return {"ms_at_max_iter_0_1_2": t, "set_up": t[0], "last_iteration": t[1] - t[0], "iteration": t[2] - t[1]}


def _same(x, y):
    return torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


def _cells(old, new, variants, dev, card):
    H = gen_ldpc_matrix(SW, 0, check_blocks=2)
    r, n_b = H.shape[0], H.shape[1] - H.shape[0]
    decs = {eta: QarySpecialDecoder(H, eta, SW * eta, ITERS, backend="fused", device=dev) for eta in (2, 3)}
    smoke_rng = np.random.RandomState(SMOKE_SEED)
    smoke = {eta: _inputs(H, decs[eta], eta, 512, smoke_rng, dev) for eta in (2, 3)}  # phase 8's draws, in order
    cells = []
    for name, eta, frames in CELLS:
        bsum = SW * eta
        rng = np.random.RandomState(frames + eta)
        args = smoke[eta] if frames == 512 else _inputs(H, decs[eta], eta, frames, rng, dev)
        cfg = special_fused_launch(n_b, r, SW, eta, bsum, *smem_limits(dev))

        def run_new(m=ITERS, warps=cfg.warps):
            return new(args, eta, bsum, m, warps)

        def run_old(m=ITERS):
            return old(args, eta, bsum, m)

        out_n = run_new()
        same = _same(out_n, run_old())
        torch.cuda.synchronize()
        nbytes = sum(x.numel() * x.element_size() for x in (*args, *out_n))
        bound, bound_by = chain_bound_ms(frames * r * ITERS, SW, eta, (2 * SW - 1) * eta, eta, bsum, nbytes)
        turns, t_old, t_new = _turns(run_old, run_new)
        instances = {w: {"equal": _same(run_new(warps=w), out_n), "ms": _ms(lambda: run_new(warps=w))}
                     for w in new.instances(n_b, r, eta, bsum, dev)}
        cell = {"cell": name, "eta": eta, "frames": frames, "iterations": ITERS, "launch": cfg._asdict(),
                "decisions_equal": same, "turns_ms": turns, "old_ms": t_old, "new_ms": t_new,
                "speedup": t_old / t_new, "bound_ms": bound, "bound_by": bound_by,
                "new_share_of_bound": bound / t_new, "old_share_of_bound": bound / t_old,
                "instances": instances, "sweep": {"old": _sweep(run_old), "new": _sweep(run_new)}, "variants": {}}
        print(f"K7 {name}: decisions equal {same}; old {t_old:.3f} ms, new {t_new:.3f} ms ({cell['speedup']:.2f}x) "
              f"at {cfg.warps} warps a block, {cfg.blocks_per_sm} an SM ({cfg.smem_bytes} B); bound {bound:.3f} ms "
              f"({bound_by}), new at {100 * bound / t_new:.1f}% of it [{card}]")
        print("  instances (warps a block: ms, equal): " + " | ".join(
            f"{k} {v['ms']:.3f} {v['equal']}" for k, v in instances.items()))
        print("  sweep (set-up, last iteration, each earlier one, ms): " + " ".join(
            f"{k} {[round(v[x], 3) for x in ('set_up', 'last_iteration', 'iteration')]}"
            for k, v in cell["sweep"].items()))
        for label, lib in variants:
            v = {}
            for w in lib.instances(n_b, r, eta, bsum, dev):
                v["-" if w is None else w] = {"equal": _same(lib(args, eta, bsum, ITERS, w), out_n),
                                              "ms": _ms(lambda: lib(args, eta, bsum, ITERS, w)),
                                              "sweep": _sweep(lambda m: lib(args, eta, bsum, m, w))}
            cell["variants"][label] = v
            print(f"  variant {label}: " + " | ".join(
                f"{k} {x['ms']:.3f} ms, decisions equal to the current kernel {x['equal']}, iteration "
                f"{x['sweep']['iteration']:.3f}" for k, x in v.items()))
        cells.append(cell)
        del args
    return cells


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default="build/qary_old/qary_min_sum.cu", help="the earlier qary_min_sum.cu")
    ap.add_argument("--variant", action="append", default=[], metavar="PATH",
                    help="an edited copy of either source, timed beside the current kernel")
    ap.add_argument("--out", default="build/qary_forms.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qary_forms: no CUDA device", file=sys.stderr)
        return 1
    if not Path(args.old).is_file():
        print(f"qary_forms: no earlier source at {args.old}; write it with git show (see the module's docstring)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = _card()
    print(card)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(args.variant) + 2) as pool:  # one nvcc a source, all at once
        built = pool.submit(_build.build, "qary_min_sum")
        libs = list(pool.map(_Lib.compile, [args.old, *args.variant]))
        new = _Lib(qary_cuda._lib(), built.result().with_suffix(".log").read_text())
    old, variants = libs[0], [(Path(p).stem, lib) for p, lib in zip(args.variant, libs[1:])]
    out.with_name(f"{out.stem}_ptxas_old.log").write_text(old.log)
    out.with_name(f"{out.stem}_ptxas_new.log").write_text(new.log)
    print("ptxas old:", " | ".join(_ptxas(old.log)))
    print("ptxas new K7 {warps a block: (registers, spill bytes)}:", special_fused_ptxas())
    for label, lib in variants:
        print(f"ptxas variant {label}:", " | ".join(_ptxas(lib.log)))
    results = {"card": card, "torch": torch.__version__, "cells": _cells(old, new, variants, dev, card)}
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    bad = [c["cell"] for c in results["cells"]
           if not c["decisions_equal"] or not all(v["equal"] for v in c["instances"].values())]
    if bad:
        print(f"qary_forms: the forms or the instances disagree in {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
