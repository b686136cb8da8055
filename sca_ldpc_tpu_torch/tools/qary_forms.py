"""Time the port's q-ary kernels K5 (``qary_min_sum.cu``'s
``qary_chain_exclusive``, the check update), K6 (``qary_min_sum_fused``) and
K7 (``qary_special_min_sum_fused``, the Kyber decode) against their forms
before the Hopper redesigns, on one NVIDIA GPU, in one process.

The earlier sources are ``sca_ldpc_tpu_torch/csrc/qary_min_sum.cu`` as of
commit 73cefcb for K5, 75ccc0c for K6 and f75bded for K7; in each, the
kernel's entry point takes no launch configuration (8 warps a block, one
instance).  Write them into the git-ignored ``build/`` from a checkout with
history, then run the script (the card's machine needs no git):

    mkdir -p build/qary_old build/qary_old_k6 build/qary_old_k5
    git show f75bded:sca_ldpc_tpu_torch/csrc/qary_min_sum.cu > build/qary_old/qary_min_sum.cu
    git show 75ccc0c:sca_ldpc_tpu_torch/csrc/qary_min_sum.cu > build/qary_old_k6/qary_min_sum.cu
    git show 73cefcb:sca_ldpc_tpu_torch/csrc/qary_min_sum.cu > build/qary_old_k5/qary_min_sum.cu
    python3 -m sca_ldpc_tpu_torch.tools.qary_forms --out build/qary_forms.json

``--kernels k5``, ``k6`` or ``k7`` runs some parts.  Each earlier source is
compiled with the package's nvcc flags beside the current one.

K5's cells (``K5_CELLS``) are its calls on the chain backends' paths: the
medium decoder's check update [Bt, 150, 7, 15] (s_mid 42, s_out 7) on
``chip_smoke.py`` phase 5's 512 frames and at batch 4096, the early-exit q-ary
FER's [4096, 150, 7, 3] (6, 1), and the Kyber-768 chain's [4096, 512, 6, 5] +
extra [4096, 512, 25] (22, 2) and [4096, 512, 6, 7] + [4096, 512, 37] (33,
3): operands uniform in [0, 20) with 10% BIG, in the extra cells 5% of the
operands and extra entries negated too (which makes the padding terms
matter).  For each: outputs bit-equal between the forms and to the plain
version, both timed in turns, and every instance (warps a block, checks a
warp) whose block fits, each bit-equal to the chosen one.

K6's cells are the medium decoder
(``make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, seed 1)``,
N = 450, R = 150, DC = 7) at B = 7, 10 iterations: 512 frames of the
Dirichlet channels that ``chip_smoke.py`` phase 6 makes (its seed, after
phase 5's draws, in its order), and 4096 frames of Dirichlet channels from
another seed; and the same code at B = 1, 5 iterations, 4096 frames of the
q-ary FER's channel at rate 0.005 (``DecoderN450R150V3C7B1``'s K6 call).
K7's cells are DecoderN1280R512SW6 (``gen_ldpc_matrix(6, seed 0, check_blocks=2)``)
at eta = 2 and 3, 10 iterations: 512 frames of the Dirichlet channels that
``chip_smoke.py`` phase 8 makes (its seed, in its order), and 4096 frames of
Dirichlet channels from another seed (K7's time does not depend on the
values: fixed iterations, no branch on data; nor does K6's).  For each cell:
checks that both forms give the same decisions on every frame, times them in
turns (old, new, new, old; CUDA events, best of 3 after a warm-up), sweeps
``max_iter`` over 0, 1 and 2 (set-up, the last iteration, and each earlier
one), and times the current kernel at every one of its instances whose block
fits the card (``FUSED_WARPS``, ``SPECIAL_WARPS``), each checked against the
chosen one.  Both forms are called through their C entry points (the
wrapper's argument checks, about 0.2 ms a call with a host sync, are timed
by ``chip_smoke.py``).

``--variant PATH`` (repeatable) also compiles an edited copy of any
source (a K6 that takes a warp count has ``qary_fused_occupancy``, a K7
that takes one has it or ``qary_special_fused_occupancy``, a K5 that takes
an instance has ``qary_chain_table_bytes``), says on each cell whether its
outputs equal the current kernel's, and times it; a copy with the current
interface runs at every instance whose block, by the copy's own count of
shared memory, fits.  The
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
from typing import NamedTuple

import numpy as np
import torch

from ..channels import probs_to_llr
from ..codes import make_regular_ldpc_parity_check_matrix_identity
from ..models.kyber import gen_ldpc_matrix
from ..ops import QaryDecoder, QarySpecialDecoder, minplus
from ..ops.kernels import _build
from ..ops.kernels.bounds import chain_bound_ms
from ..ops.kernels.circulant_cuda import smem_limits
from ..ops.kernels import qary_cuda
from ..ops.kernels.qary_cuda import (
    CHAIN_CHECKS,
    CHAIN_PER_WARP_WARPS,
    CHAIN_WARPS,
    FUSED_WARPS,
    SPECIAL_WARPS,
    _c_table,
    chain_exclusive_plain,
    chain_instance,
    chain_launch,
    chain_ptxas,
    fused_launch,
    fused_ptxas,
    special_fused_launch,
)
from ..ops.qary import _signed
from .circulant_forms import _card, _compile_old, _ms, _ptxas, _turns

SW, ITERS, SMOKE_SEED = 6, 10, 5678
# (cell, eta, frames); the 512-frame cells are chip_smoke.py phase 8's inputs
CELLS = (("eta 2, 512 frames", 2, 512), ("eta 2, batch 4096", 2, 4096), ("eta 3, 512 frames", 3, 512),
         ("eta 3, batch 4096", 3, 4096))
K6_SMOKE_SEED, FER_RATE = 4321, 0.005
# (cell, B, iterations, frames); the 512-frame cell is chip_smoke.py phase 6's inputs
K6_CELLS = (("medium decoder, 512 frames", 7, 10, 512), ("medium decoder, batch 4096", 7, 10, 4096),
            ("Q = 3, batch 4096", 1, 5, 4096))
# (cell, v2c shape, s_mid, s_out, extra width or 0); the first is chip_smoke.py phase 5's inputs
K5_CELLS = (("medium, phase 5's", (512, 150, 7, 15), 42, 7, 0), ("medium, batch 4096", (4096, 150, 7, 15), 42, 7, 0),
            ("Q = 3, batch 4096", (4096, 150, 7, 3), 6, 1, 0),
            ("Kyber eta 2, batch 4096", (4096, 512, 6, 5), 22, 2, 25),
            ("Kyber eta 3, batch 4096", (4096, 512, 6, 7), 33, 3, 37))


class _Cell(NamedTuple):
    """One cell: its inputs as the C entry point takes them."""

    kernel: int  # 6 or 7
    name: str
    meta: dict  # the cell's alphabet, frames and iterations, as written out
    inputs: tuple  # tensors, in the entry point's order
    ints: tuple  # the entry point's ints before max_iter
    out_shapes: tuple  # its int32 outputs'
    smem_args: tuple  # its count of a block's shared memory takes these, then the warps
    cfg: object  # the chooser's FusedLaunch
    bound: object  # nbytes -> (bound ms, "operations" or "bytes")


class _Lib:
    """A built source's K6 (``kernel`` 6) or K7 (7): its entry point, its
    own count of a block's shared memory, and whether it has the current
    interface (a warp count a block)."""

    def __init__(self, kernel, lib, log):
        self.log = log
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if kernel == 6:  # channel and 4 adjacency arrays, 7 ints, hard
            self.current = hasattr(lib, "qary_fused_occupancy")
            self.fn, self.smem, self.warps = lib.qary_min_sum_fused, lib.qary_fused_smem_bytes, FUSED_WARPS
            n_ptr, n_int, n_smem, n_out = 5, 7, 4, 1
        else:  # 3 channels and 5 adjacency arrays, 8 ints, hard_b and hard_s
            self.current = hasattr(lib, "qary_fused_occupancy") or hasattr(lib, "qary_special_fused_occupancy")
            self.fn, self.smem, self.warps = (lib.qary_special_min_sum_fused, lib.qary_special_fused_smem_bytes,
                                              SPECIAL_WARPS)
            n_ptr, n_int, n_smem, n_out = 8, 8, 5, 2
        self.fn.argtypes = [p] * n_ptr + [i] * (n_int + self.current) + [p] * (n_out + 1)
        self.fn.restype = i
        self.smem.argtypes = [i] * (n_smem + self.current)
        self.smem.restype = ll

    def instances(self, cell):
        """The warp counts whose block fits the card by this source's own
        count (None: the earlier form's one launch)."""
        if not self.current:
            return [None]
        smem_block = smem_limits(cell.inputs[0].device)[0]
        return [w for w in self.warps if self.smem(*cell.smem_args, w) <= smem_block]

    def __call__(self, cell, max_iter, warps=None):
        outs = tuple(torch.empty(s, dtype=torch.int32, device=cell.inputs[0].device) for s in cell.out_shapes)
        rc = self.fn(*(x.data_ptr() for x in cell.inputs), *cell.ints, int(max_iter),
                     *(() if warps is None else (warps,)), *(o.data_ptr() for o in outs),
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K{cell.kernel} (warps {warps}) failed: CUDA error {rc}")
        return outs


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


def _k6_smoke_llr(rng, n, dev):
    """chip_smoke.py phase 6's medium-decoder LLRs: phase 5's draws first."""
    for shape in ((512, 150, 7, 15), (512, 150, 7, 15), (512, 512, SW, 5), (512, 512, 25)):
        rng.rand(*shape)
    probs = rng.dirichlet(np.ones(15), size=(512, n)).astype(np.float32)
    return minplus.clip_inf(probs_to_llr(torch.from_numpy(probs).to(dev))).contiguous()


def _k6_inputs(b, frames, n, rng, dev):
    """Dirichlet LLRs (B = 7) or the q-ary FER's channel at FER_RATE (B = 1:
    each symbol's good or bad distribution), clipped as QaryDecoder clips them."""
    q = 2 * b + 1
    if b > 1:
        probs = rng.dirichlet(np.ones(q), size=(frames, n)).astype(np.float32)
    else:
        good = np.full(q, 1.0 / q, np.float32)
        bad = good.copy()
        good[[b, -1]] = [1.75 / q, 0.25 / q]
        bad[[-1, b]] = [1.75 / q, 0.25 / q]
        probs = np.where((rng.rand(frames, n) < FER_RATE)[..., None], bad, good)
    return minplus.clip_inf(probs_to_llr(torch.from_numpy(probs).to(dev))).contiguous()


def _k6_cells(dev):
    """K6's cells, one at a time (each frees the one before)."""
    H = make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, 1)
    r, n = H.shape
    smoke = _k6_smoke_llr(np.random.RandomState(K6_SMOKE_SEED), n, dev)
    for name, b, iters, frames in K6_CELLS:
        q = 2 * b + 1
        adjacency = QaryDecoder(H, b, iters, backend="fused", device=dev)._args
        dc, dv = adjacency[0].shape[1], adjacency[3].shape[1]
        llr = smoke if frames == 512 else _k6_inputs(b, frames, n, np.random.RandomState(frames + b), dev)
        yield _Cell(6, name, {"b": b, "frames": frames, "iterations": iters}, (llr, *adjacency),
                    (frames, n, r, dc, dv, q), ((frames, n),), (n, r, dc, q), fused_launch(n, r, dc, q, *smem_limits(dev)),
                    lambda nbytes, b=b, dc=dc, iters=iters, frames=frames: chain_bound_ms(
                        frames * r * iters, dc, b, (dc - 1) * b, b, 0, nbytes))


def _k7_cells(dev):
    """K7's cells, one at a time (each frees the one before)."""
    H = gen_ldpc_matrix(SW, 0, check_blocks=2)
    r, n_b = H.shape[0], H.shape[1] - H.shape[0]
    decs = {eta: QarySpecialDecoder(H, eta, SW * eta, ITERS, backend="fused", device=dev) for eta in (2, 3)}
    smoke_rng = np.random.RandomState(SMOKE_SEED)
    smoke = {eta: _inputs(H, decs[eta], eta, 512, smoke_rng, dev) for eta in (2, 3)}  # phase 8's draws, in order
    for name, eta, frames in CELLS:
        bsum = SW * eta
        args = smoke[eta] if frames == 512 else _inputs(H, decs[eta], eta, frames, np.random.RandomState(frames + eta),
                                                         dev)
        dv = args[6].shape[1]
        yield _Cell(7, name, {"eta": eta, "frames": frames, "iterations": ITERS}, args,
                    (frames, n_b, r, SW, dv, eta, bsum), ((frames, n_b), (frames, r)), (n_b, r, SW, eta, bsum),
                    special_fused_launch(n_b, r, SW, eta, bsum, *smem_limits(dev)),
                    lambda nbytes, eta=eta, bsum=bsum, frames=frames: chain_bound_ms(
                        frames * r * ITERS, SW, eta, (2 * SW - 1) * eta, eta, bsum, nbytes))


class _K5Lib:
    """A built source's K5: its entry point, and whether it has the current
    interface (a table and an instance) with its own count of a block's
    shared memory."""

    def __init__(self, lib, log):
        self.log = log
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.current = hasattr(lib, "qary_chain_table_bytes")
        self.fn = lib.qary_chain_exclusive
        self.fn.argtypes = [p, p, p, ll, p, i, i, i, p] if self.current else [p, p, p, ll, i, i, i, i, i, p]
        self.fn.restype = i
        if self.current:
            self.smem = lib.qary_chain_smem_bytes
            self.smem.argtypes = [p, i, i]
            self.smem.restype = ll

    def instances(self, cell):
        """The instances whose block fits the card by this source's own count
        (None: the earlier form's one launch)."""
        if not self.current:
            return [None]
        smem_block = smem_limits(cell["v2c"].device)[0]
        shape = cell["shape"]
        return [(w, k) for k in CHAIN_CHECKS for w in CHAIN_WARPS if self.smem(ctypes.byref(_c_table(*shape, k)), w, k)
                <= smem_block] + [(CHAIN_PER_WARP_WARPS, 0)]

    def __call__(self, cell, instance=None):
        v2c, extra = cell["v2c"], cell["extra"]
        d, q, s_mid, s_out, we = cell["shape"]
        out = torch.empty(v2c.shape[:3] + (2 * s_out + 1,), dtype=torch.float32, device=v2c.device)
        n = v2c.shape[0] * v2c.shape[1]
        ptrs = (v2c.data_ptr(), extra.data_ptr() if extra is not None else None, out.data_ptr(), n)
        if self.current:
            warps, checks = instance or tuple(cell["cfg"][:2])
            cfg = chain_instance(d, q, s_mid, s_out, we, warps, checks, *smem_limits(v2c.device))
            blocks = torch.cuda.get_device_properties(v2c.device).multi_processor_count * max(cfg.blocks_per_sm, 1)
            rc = self.fn(*ptrs, ctypes.byref(_c_table(d, q, s_mid, s_out, we, checks)), warps, checks, blocks,
                         torch.cuda.current_stream().cuda_stream)
        else:
            rc = self.fn(*ptrs, d, q, s_mid, s_out, we, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K5 (instance {instance}) failed: CUDA error {rc}")
        return out


def _k5_cells(dev):
    """K5's cells, one at a time (each frees the one before)."""
    for name, shape, s_mid, s_out, we in K5_CELLS:
        bt, r, d, q = shape
        rng = np.random.RandomState(K6_SMOKE_SEED if bt == 512 else bt + q)
        v2c = (rng.rand(*shape) * 20).astype(np.float32)
        v2c[rng.rand(*shape) < 0.1] = minplus.BIG
        extra = None
        if we:
            v2c[rng.rand(*shape) < 0.05] *= -1
            extra = (rng.rand(bt, r, we) * 20).astype(np.float32)
            extra[rng.rand(*extra.shape) < 0.05] *= -1
            extra = torch.from_numpy(extra).to(dev)
        key = (d, q, s_mid, s_out, we)
        yield {"name": name, "v2c": torch.from_numpy(v2c).to(dev), "extra": extra, "shape": key,
               "cfg": chain_launch(*key, *smem_limits(dev)),
               "bound": lambda nbytes, n=bt * r, key=key: chain_bound_ms(n, key[0], (key[1] - 1) // 2, key[2], key[3],
                                                                        (key[4] - 1) // 2 if key[4] else 0, nbytes)}


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _run_k5(cell, old, new, variants, card):
    """Both forms of K5, the current one's instances and the variants on one cell."""
    v2c, extra, (d, q, s_mid, s_out, we) = cell["v2c"], cell["extra"], cell["shape"]
    out_n = new(cell)
    same = _bits_equal(out_n, old(cell))
    plain = _bits_equal(out_n, chain_exclusive_plain(v2c, s_mid, s_out, extra))
    torch.cuda.synchronize()
    bound, bound_by = cell["bound"](sum(x.numel() * x.element_size() for x in (v2c, extra, out_n) if x is not None))
    turns, t_old, t_new = _turns(lambda: old(cell), lambda: new(cell))
    instances = {f"{w}x{k}": {"equal": _bits_equal(new(cell, (w, k)), out_n), "ms": _ms(lambda: new(cell, (w, k)))}
                 for w, k in new.instances(cell)}
    cfg = cell["cfg"]
    res = {"kernel": "K5", "cell": cell["name"], "v2c": list(v2c.shape), "extra": None if extra is None else
           list(extra.shape), "s_mid": s_mid, "s_out": s_out, "launch": cfg._asdict(), "outputs_equal": same,
           "equal_to_plain": plain, "turns_ms": turns, "old_ms": t_old, "new_ms": t_new, "speedup": t_old / t_new,
           "bound_ms": bound, "bound_by": bound_by, "new_share_of_bound": bound / t_new,
           "old_share_of_bound": bound / t_old, "instances": instances, "variants": {}}
    print(f"K5 {cell['name']} {list(v2c.shape)}{'' if extra is None else ' + ' + str(list(extra.shape))}: outputs "
          f"equal {same}, equal to plain {plain}; old {t_old:.3f} ms, new {t_new:.3f} ms ({res['speedup']:.2f}x) at "
          f"{cfg.warps} warps x {cfg.checks} checks a block, {cfg.blocks_per_sm} an SM ({cfg.smem_bytes} B); bound "
          f"{bound:.4f} ms ({bound_by}), old at {100 * bound / t_old:.1f}%, new at {100 * bound / t_new:.1f}% [{card}]")
    print("  instances (warps x checks: ms, equal): " + " | ".join(
        f"{k} {v['ms']:.3f} {v['equal']}" for k, v in instances.items()))
    for label, lib in variants:
        v = {"-" if w is None else f"{w[0]}x{w[1]}": {"equal": _bits_equal(lib(cell, w), out_n),
                                                      "ms": _ms(lambda: lib(cell, w))} for w in lib.instances(cell)}
        res["variants"][label] = v
        print(f"  variant {label}: " + " | ".join(f"{k} {x['ms']:.3f} ms, equal {x['equal']}" for k, x in v.items()))
    return res


def _run(cell, old, new, variants, card):
    """Both forms, the current one's instances and the variants on one cell."""
    cfg, iters = cell.cfg, cell.meta["iterations"]

    def run_new(m=iters, warps=cfg.warps):
        return new(cell, m, warps)

    def run_old(m=iters):
        return old(cell, m)

    out_n = run_new()
    same = _same(out_n, run_old())
    torch.cuda.synchronize()
    bound, bound_by = cell.bound(sum(x.numel() * x.element_size() for x in (*cell.inputs, *out_n)))
    turns, t_old, t_new = _turns(run_old, run_new)
    instances = {w: {"equal": _same(run_new(warps=w), out_n), "ms": _ms(lambda: run_new(warps=w))}
                 for w in new.instances(cell)}
    res = {"kernel": f"K{cell.kernel}", "cell": cell.name, **cell.meta, "launch": cfg._asdict(),
           "decisions_equal": same, "turns_ms": turns, "old_ms": t_old, "new_ms": t_new,
           "speedup": t_old / t_new, "bound_ms": bound, "bound_by": bound_by,
           "new_share_of_bound": bound / t_new, "old_share_of_bound": bound / t_old,
           "instances": instances, "sweep": {"old": _sweep(run_old), "new": _sweep(run_new)}, "variants": {}}
    print(f"K{cell.kernel} {cell.name}: decisions equal {same}; old {t_old:.3f} ms, new {t_new:.3f} ms "
          f"({res['speedup']:.2f}x) at {cfg.warps} warps a block, {cfg.blocks_per_sm} an SM ({cfg.smem_bytes} B); "
          f"bound {bound:.3f} ms ({bound_by}), new at {100 * bound / t_new:.1f}% of it [{card}]")
    print("  instances (warps a block: ms, equal): " + " | ".join(
        f"{k} {v['ms']:.3f} {v['equal']}" for k, v in instances.items()))
    print("  sweep (set-up, max_iter 1 less 0, 2 less 1, ms): " + " ".join(
        f"{k} {[round(v[x], 3) for x in ('set_up', 'last_iteration', 'iteration')]}" for k, v in res["sweep"].items()))
    for label, lib in variants:
        v = {}
        for w in lib.instances(cell):
            v["-" if w is None else w] = {"equal": _same(lib(cell, iters, w), out_n),
                                          "ms": _ms(lambda: lib(cell, iters, w)),
                                          "sweep": _sweep(lambda m: lib(cell, m, w))}
        res["variants"][label] = v
        print(f"  variant {label}: " + " | ".join(
            f"{k} {x['ms']:.3f} ms, decisions equal to the current kernel {x['equal']}, iteration "
            f"{x['sweep']['iteration']:.3f}" for k, x in v.items()))
    return res


def _sweep(fn):
    t = [_ms(lambda m=m: fn(m)) for m in range(3)]
    return {"ms_at_max_iter_0_1_2": t, "set_up": t[0], "last_iteration": t[1] - t[0], "iteration": t[2] - t[1]}


def _same(x, y):
    return all(torch.equal(a, b) for a, b in zip(x, y))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", nargs="+", choices=("k5", "k6", "k7"), default=["k5", "k6", "k7"])
    ap.add_argument("--old", default="build/qary_old/qary_min_sum.cu", help="K7's earlier qary_min_sum.cu (f75bded)")
    ap.add_argument("--old-k6", default="build/qary_old_k6/qary_min_sum.cu",
                    help="K6's earlier qary_min_sum.cu (75ccc0c)")
    ap.add_argument("--old-k5", default="build/qary_old_k5/qary_min_sum.cu",
                    help="K5's earlier qary_min_sum.cu (73cefcb)")
    ap.add_argument("--variant", action="append", default=[], metavar="PATH",
                    help="an edited copy of any of the sources, timed beside the current kernels")
    ap.add_argument("--out", default="build/qary_forms.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qary_forms: no CUDA device", file=sys.stderr)
        return 1
    olds = {"k5": args.old_k5, "k6": args.old_k6, "k7": args.old}
    kernels = [k for k in ("k5", "k6", "k7") if k in args.kernels]
    missing = [olds[k] for k in kernels if not Path(olds[k]).is_file()]
    if missing:
        print(f"qary_forms: no earlier source at {missing}; write it with git show (see the module's docstring)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = _card()
    print(card)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    srcs = [olds[k] for k in kernels] + args.variant
    with ThreadPoolExecutor(len(srcs) + 1) as pool:  # one nvcc a source, all at once
        built = pool.submit(_build.build, "qary_min_sum")
        compiled = list(pool.map(lambda src: _compile_old(src, "qary_min_sum_" + Path(src).stem), srcs))
        new = (qary_cuda._lib(), built.result().with_suffix(".log").read_text())
    old = dict(zip(kernels, compiled))
    variants = [(Path(src).stem, c) for src, c in zip(args.variant, compiled[len(kernels):])]
    out.with_name(f"{out.stem}_ptxas_new.log").write_text(new[1])
    for k, (_, log) in old.items():
        out.with_name(f"{out.stem}_ptxas_old_{k}.log").write_text(log)
        print(f"ptxas old {k}:", " | ".join(_ptxas(log)))
    print("ptxas new K5 {(warps, checks): (registers, spill bytes)}:", chain_ptxas())
    for kernel in (6, 7):
        print(f"ptxas new K{kernel} {{warps a block: (registers, spill bytes)}}:", fused_ptxas(kernel))
    for label, (_, log) in variants:
        print(f"ptxas variant {label}:", " | ".join(_ptxas(log)))
    cells = []
    if "k5" in old:
        libs = [(label, _K5Lib(*c)) for label, c in variants]
        cells += [_run_k5(cell, _K5Lib(*old["k5"]), _K5Lib(*new), libs, card) for cell in _k5_cells(dev)]
    for k, kernel, make in (("k6", 6, _k6_cells), ("k7", 7, _k7_cells)):
        if k in old:
            libs = [(label, _Lib(kernel, *c)) for label, c in variants]
            cells += [_run(cell, _Lib(kernel, *old[k]), _Lib(kernel, *new), libs, card) for cell in make(dev)]
    results = {"card": card, "torch": torch.__version__, "cells": cells}
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    bad = [f"{c['kernel']} {c['cell']}" for c in cells
           if not c.get("decisions_equal", c.get("outputs_equal")) or not c.get("equal_to_plain", True)
           or not all(v["equal"] for v in c["instances"].values())]
    if bad:
        print(f"qary_forms: the forms or the instances disagree in {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
