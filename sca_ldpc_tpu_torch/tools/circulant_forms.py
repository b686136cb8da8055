"""Time the port's circulant kernels against their earlier forms, on one
NVIDIA GPU, in one process: K1 (``circulant_bp.cu``'s FER step, against its
form before the planes were staged through shared memory), the lean kernel
K3/K4 (``circulant_lean.cu``'s decode and FER step) and K8
(``circulant_multi.cu``, the HQC attack's masked decode), against their forms
before the Hopper redesigns.

The earlier sources are ``sca_ldpc_tpu_torch/csrc/circulant_bp.cu`` as of commit
503e714 (the unstaged form: the launch configuration's placement, threads,
shared memory and plane stride, no slots), and
``sca_ldpc_tpu_torch/csrc/circulant_lean.cu`` as
of commit cef7e57, whose entry points take two plane arrays ``v2c`` and ``c2v
[B, w, N]``, ``acc_phi``, ``acc_neg`` and ``tot [B, N]`` and no launch
configuration; this script binds those interfaces.  Write them into the
git-ignored ``build/`` from a checkout with history, then run the script (the
card's machine needs no git):

    mkdir -p build/k1_old build/lean_old build/k8_old
    git show 503e714:sca_ldpc_tpu_torch/csrc/circulant_bp.cu > build/k1_old/circulant_bp.cu
    git show cef7e57:sca_ldpc_tpu_torch/csrc/circulant_lean.cu > build/lean_old/circulant_lean.cu
    git show 46cf7a6:sca_ldpc_tpu_torch/csrc/circulant_multi.cu > build/k8_old/circulant_multi.cu
    python3 -m sca_ldpc_tpu_torch.tools.circulant_forms --out build/k1_forms.json

Each is compiled with the package's nvcc flags beside the current source.
``--kernels k1``, ``lean`` or ``k8`` runs one part, ``both`` (the default)
K1 and the lean kernel, ``all`` the three.

K1, for each cell (HQC-128 at batch 4096 and 512, HQC-192 and HQC-256 at batch
2048; error rate 0.01, product-sum, up to 30 iterations, errors sampled on the
card from a fixed seed): checks that both forms give the same success and
convergence flags and per-frame iteration counts (at HQC-256, where the launch
stages nothing, the two forms run the same code), times a step of each in
turns (old, new, new, old; CUDA events, best of 3 after a warm-up), records
each one's peak device memory, and sweeps max_iter over 0-3 (set-up, first
and later iterations).  The bound of each step comes from the frames' own
iteration counts (the step's ``iters_out``), less the first, and
``ops/kernels/bounds.py``.

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

K8, for each of ``chip_smoke.py`` phase 16's cells (``tools/attack_cells.py``:
the seed-0 attack's check sets, recorded from a run of the attack on the card;
the recovery's 2,850 rows at P = 1, 3, 8, the same rows at their true values,
the first decode's 50 at P = 1, 3, 8, each at batch 1 and 16; 100
iterations): checks that 46cf7a6's form (four launches an iteration from a
host loop that reads the running count every 4 iterations; its
``multi_circulant_bp_decode`` takes ``state [2B + 1]`` and no grid) and the
current one give the plain version's decisions, flags and iteration counts on
every frame, and times them in the same turns, with the bound from
``ops/kernels/bounds.py``.  Beside them, the edited copies of the current
source that ``tools/k8_variants.py`` writes (the barrier floor and the
per-sweep floors, timed only; stage 2, held against plain too).  Then the seed-0
attack through ``"circulant"`` (``tools/attack_cells.py``'s) with each
form of K8, in turns old, new, new, old: the wall time, the seconds inside
the decodes and K8's device span in them (CUDA events around each call of
the wrapper), and the attack's success sequence and oracle calls, which
both forms must give alike.

Prints one line per cell and writes everything as JSON, with the ptxas reports
of the builds beside it.  Exits non-zero if any cell's forms disagree.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..codes import CirculantLayout, random_circulant_first_row
from ..ops.kernels import _build, circulant_cuda
from ..ops.kernels.bounds import circulant_bound_ms, multi_circulant_bound_ms
from ..ops.kernels.circulant_cuda import (
    circulant_bp_lean_cuda,
    circulant_fer_cuda,
    circulant_fer_lean_cuda,
    circulant_form,
    circulant_launch,
    multi_circulant_bp_cuda,
    multi_circulant_bp_plain,
    multi_circulant_launch,
    multi_circulant_occupancy,
    smem_limits,
)
from ..utils import make_random_state
from . import attack_cells, k8_variants

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
    lib.circulant_fer_step.argtypes = [p, f, p, i, i, i, i, i, i, i, i, p, p, p, p, p, p, p, p]
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


def _old_fer(lib, errors, shifts, rate, max_iter, iters_out=None):
    """The earlier form's FER step (its own wrapper, product-sum), at the
    current launch configuration less the staged slots."""
    b, n2 = errors.shape
    n, w, dev = n2 // 2, len(shifts), errors.device
    cfg = circulant_launch(n, w, *smem_limits(dev))
    k = torch.tensor(shifts, dtype=torch.int32, device=dev)
    c2v = torch.empty((b, w, cfg.ld), dtype=torch.float32, device=dev)
    tot = torch.empty((b, n), dtype=torch.float32, device=dev) if cfg.placement == "device" else None
    syn = torch.empty((b, n), dtype=torch.uint8, device=dev)
    e_i = torch.empty((b, n), dtype=torch.uint8, device=dev)
    ok = torch.empty((b,), dtype=torch.uint8, device=dev)
    conv = torch.empty((b,), dtype=torch.uint8, device=dev)
    rc = lib.circulant_fer_step(errors.data_ptr(), float(np.log((1 - rate) / rate)), k.data_ptr(), w, n, cfg.ld, b,
                                int(max_iter), 0, cfg.threads, cfg.smem_bytes, c2v.data_ptr(),
                                None if tot is None else tot.data_ptr(), syn.data_ptr(), e_i.data_ptr(),
                                ok.data_ptr(), conv.data_ptr(), None if iters_out is None else iters_out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old circulant_fer_step failed: CUDA error {rc}")
    return ok.bool(), conv.bool()


def _build_old_k8(src):
    """K8's earlier form (46cf7a6); returns (lib, ptxas log)."""
    lib, log = _compile_old(src, "circulant_multi")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.multi_circulant_bp_decode.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, p, p, p, p]
    lib.multi_circulant_bp_decode.restype = i
    return lib, log


def _build_k8_copy(src, name):
    """A source with the current K8 interface; returns (lib, ptxas log)."""
    lib, log = _compile_old(src, "circulant_multi_" + name)
    current = circulant_cuda._multi_lib()
    for fn in ("multi_circulant_bp_decode", "multi_circulant_bp_occupancy"):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = getattr(current, fn).argtypes, getattr(current, fn).restype
    return lib, log


def _old_multi(lib, prior_c, prior_i, syn, shifts, max_iter, method="product_sum"):
    """The earlier form's K8 (its own wrapper)."""
    b, p, n = syn.shape
    w, dev = shifts.shape[1], prior_c.device
    ld = -(-n // 32) * 32
    k = (shifts.to(torch.int64) % n).to(torch.int32).contiguous()
    c2v = torch.empty((b, p, w, ld), dtype=torch.float32, device=dev)
    tot = torch.empty((b, n), dtype=torch.float32, device=dev)
    state = torch.empty((2 * b + 1,), dtype=torch.int32, device=dev)
    e_c = torch.empty((b, n), dtype=torch.uint8, device=dev)
    e_i = torch.empty((b, p, n), dtype=torch.uint8, device=dev)
    conv = torch.empty((b,), dtype=torch.uint8, device=dev)
    iters = torch.empty((b,), dtype=torch.int32, device=dev)
    rc = lib.multi_circulant_bp_decode(prior_c.data_ptr(), prior_i.data_ptr(), syn.data_ptr(), k.data_ptr(), p, w, n,
                                       ld, b, int(max_iter), 0 if method == "product_sum" else 1, c2v.data_ptr(),
                                       tot.data_ptr(), state.data_ptr(), e_c.data_ptr(), e_i.data_ptr(),
                                       conv.data_ptr(), iters.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"old multi_circulant_bp_decode failed: CUDA error {rc}")
    return e_c.to(torch.int32), e_i.to(torch.int32), conv.bool(), iters


def _same_frames(a, b):
    """Frames on which two decodes' decisions, conv and iteration counts are equal."""
    return int(((a[0] == b[0]).all(dim=-1) & (a[1] == b[1]).flatten(1).all(dim=-1) & (a[2] == b[2])
                & (a[3] == b[3])).sum())


def _k8_cells(old_lib, copies, dev, card):
    """K8's forms on phase 16's cells; ``copies``: [(label, lib, outputs
    meaningful)] of edited copies and variants."""
    ok, tracking, sets = attack_cells.record_sets(dev)
    if not ok or len(sets) < attack_cells.BATCH:
        raise SystemExit("circulant_forms: the seed-0 attack did not recover the key with enough decodes")
    n, w, iters = attack_cells.N, attack_cells.ATTACK["weight"], attack_cells.ITERATIONS
    print(f"K8 cells: the seed-0 attack's {len(sets)} check sets ({tracking.num_oracle_calls} oracle calls)")
    cells = []
    for label, end, true_values, p in attack_cells.cells():
        for b in (1, attack_cells.BATCH):
            args = attack_cells.masked_cell(attack_cells.pick(sets, end, b), p, dev, true_values)

            def new():
                return multi_circulant_bp_cuda(*args, iters)

            def old():
                return _old_multi(old_lib, *args, iters)

            out_p = multi_circulant_bp_plain(*args, iters)
            out_n, out_o = new(), old()
            same = {"new": _same_frames(out_n, out_p), "old": _same_frames(out_o, out_p)}
            turns, t_old, t_new = _turns(old, new)
            occ = multi_circulant_occupancy(w, "product_sum", p, dev)
            grid = multi_circulant_launch(b, p, n, occ["blocks_per_sm"], occ["sms"]).grid
            run = int(out_n[3].sum())
            nbytes = sum(t.numel() * t.element_size() for t in args) + b * (n + p * n) + 5 * b
            bound, bound_by = multi_circulant_bound_ms(run, p, w, n, nbytes)
            cell = {"cell": label, "kernel": "K8", "p": p, "batch": b, "iterations": out_n[3].tolist(),
                    "converged": int(out_n[2].sum()), "frames_equal_to_plain": same, "grid": grid,
                    "blocks_per_sm": occ["blocks_per_sm"], "turns_ms": turns, "old_ms": t_old, "new_ms": t_new,
                    "speedup": t_old / t_new, "bound_ms": bound, "bound_by": bound_by,
                    "new_share_of_bound": bound / t_new, "old_share_of_bound": bound / t_old,
                    "max_iter": iters, "variants": {}}
            for vlabel, lib, meaningful in copies:
                with circulant_cuda.multi_lib_installed(lib):
                    v = {"ms": _ms(new)}
                    if meaningful:
                        v["frames_equal_to_plain"] = _same_frames(new(), out_p)
                cell["variants"][vlabel] = v
            cells.append(cell)
            its = max(max(cell["iterations"]), 1)
            print(f"K8 {label} P={p} batch {b}: equal to plain on {same['new']}/{b} frames (old form {same['old']}/{b}), "
                  f"{its} iterations; old {t_old:.3f} ms, new {t_new:.3f} ms ({cell['speedup']:.2f}x; "
                  f"{t_new / its * 1e3:.2f} us an iteration); grid {grid} ({occ['blocks_per_sm']} an SM); bound "
                  f"{bound:.4f} ms ({bound_by}), new at {100 * bound / t_new:.2f}%, old at {100 * bound / t_old:.2f}%; "
                  + " | ".join(f"{k} {v['ms']:.3f} ms" + (f" equal {v['frames_equal_to_plain']}/{b}"
                                                         if "frames_equal_to_plain" in v else "")
                               for k, v in cell["variants"].items()) + f" [{card}]")
    return cells


def _k8_attack(old_lib, dev, card):
    """The seed-0 attack through ``"circulant"`` with K8's earlier and
    current forms, in turns old, new, new, old; returns the runs."""
    from ..models.hqc import simulate_hqc_idealized_oracle
    from ..utils import make_random_state

    current = circulant_cuda.multi_circulant_bp_cuda

    def old(prior_c, prior_i, syndrome, shifts, max_iter, method="product_sum"):
        k = circulant_cuda._check_multi(prior_c, prior_i, syndrome, shifts, max_iter, method)[4]
        return _old_multi(old_lib, prior_c, prior_i, syndrome.to(torch.uint8).contiguous(), k, max_iter, method)

    runs = []
    for form in ("old", "new", "new", "old"):
        events = []

        def timed(*a, fn=old if form == "old" else current, events=events):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a)
            end.record()
            events.append((start, end))
            return out

        timed.launches = 0  # the current wrapper counts its launches on the name it is bound to
        circulant_cuda.multi_circulant_bp_cuda = timed
        try:
            t0 = time.perf_counter()
            ok, tracking = simulate_hqc_idealized_oracle(make_random_state(0), decode_backend="circulant", device=dev,
                                                         **attack_cells.ATTACK)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            circulant_cuda.multi_circulant_bp_cuda = current
        run = {"form": form, "success": bool(ok), "oracle_calls": tracking.num_oracle_calls,
               "decodes": len(tracking.decoder_stats), "calls": len(events),
               "successes": [d["success"] for d in tracking.decoder_stats], "wall_s": wall,
               "decode_s": tracking.decode_seconds,
               "k8_span_s": sum(start.elapsed_time(end) for start, end in events) / 1e3}
        runs.append(run)
        print(f"K8 attack, {form} form: success {ok}, {run['oracle_calls']} oracle calls, {run['decodes']} decodes; "
              f"wall {wall:.4f} s, {run['decode_s']:.4f} s inside the decodes, K8's span {run['k8_span_s']:.4f} s "
              f"over {run['calls']} calls [{card}]")
    return runs


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

        it_n, it_o = (torch.empty((batch,), dtype=torch.int32, device=dev) for _ in range(2))
        ok_n, conv_n = circulant_fer_cuda(errors, lay.shifts, RATE, MAX_ITER, iters_out=it_n)
        ok_o, conv_o = _old_fer(old_lib, errors, lay.shifts, RATE, MAX_ITER, iters_out=it_o)
        same = torch.equal(ok_n, ok_o) and torch.equal(conv_n, conv_o) and torch.equal(it_n, it_o)
        iters = int(it_n.sum())
        # the first iteration needs no phi a message under the step's one constant prior
        bound, bound_by = circulant_bound_ms(iters - batch, w, n, batch * 2 * n + 2 * batch)
        turns, t_old, t_new = _turns(old, new)
        form = circulant_form(circulant_launch(n, w, *smem_limits(dev)))
        cell = {"cell": name, "kernel": "K1", "n": n, "w": w, "batch": batch, "form": form, "flags_equal": same,
                "successes": int(ok_n.sum()), "iterations_per_frame": iters / batch,
                "turns_ms": turns, "old_ms": t_old, "new_ms": t_new, "speedup": t_old / t_new,
                "bound_ms": bound, "bound_by": bound_by, "new_share_of_bound": bound / t_new,
                "old_share_of_bound": bound / t_old,
                "peak_gb_old": _peak_gb(old, dev), "peak_gb_new": _peak_gb(new, dev)}
        if batch == max(c[3] for c in CELLS if c[1] == n):
            cell["sweep"] = {"old": _sweep(old), "new": _sweep(new)}
        cells.append(cell)
        print(f"K1 {name} batch {batch} ({form}): flags and iterations equal {same}, "
              f"successes {cell['successes']}/{batch}, "
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
    ap.add_argument("--old-k8", default="build/k8_old/circulant_multi.cu", help="the earlier circulant_multi.cu")
    ap.add_argument("--kernels", choices=("k1", "lean", "k8", "both", "all"), default="both",
                    help="both: K1 and the lean kernel; all: those and K8")
    ap.add_argument("--variant", action="append", default=[], metavar="PATH",
                    help="another source with the current circulant_lean.cu's interface, swept beside it")
    ap.add_argument("--out", default="build/k1_forms.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("circulant_forms: no CUDA device", file=sys.stderr)
        return 1
    wanted = {"both": ("k1", "lean"), "all": ("k1", "lean", "k8")}.get(args.kernels, (args.kernels,))
    parts = [(key, src) for key, src in (("k1", args.old), ("lean", args.old_lean), ("k8", args.old_k8))
             if key in wanted]
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
    sources = {"k1": "circulant_bp", "lean": "circulant_lean", "k8": "circulant_multi"}
    for key, src in parts:
        old_lib, old_log = {"k1": _build_old, "lean": _build_old_lean, "k8": _build_old_k8}[key](src)
        new_log = _build.build(sources[key]).with_suffix(".log").read_text()
        out.with_name(f"{out.stem}_{key}_ptxas_old.log").write_text(old_log)
        out.with_name(f"{out.stem}_{key}_ptxas_new.log").write_text(new_log)
        if key == "k1":
            results["cells"] += _k1_cells(old_lib, codes, dev, card)
        elif key == "lean":
            variants = []
            for path in args.variant:
                lib, log = _build_variant(path)
                variants.append((Path(path).stem, lib))
                print(f"ptxas variant {Path(path).stem}:", " | ".join(_ptxas(log)))
            results["cells"] += _lean_cells(old_lib, codes, dev, card, variants)
        else:
            circulant_cuda._multi_lib()  # built first: the copies take its interface
            sources = k8_variants.write(_build.BUILD_DIR / "k8_variants")
            with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc a copy, all at once
                built = list(pool.map(lambda item: _build_k8_copy(item[1], item[0]), sources.items()))
            copies = []
            for label, (lib, log) in zip(sources, built):
                copies.append((label, lib, not label.startswith("floor")))
                print(f"ptxas k8 {label}:", " | ".join(_ptxas(log)))
            results["cells"] += _k8_cells(old_lib, copies, dev, card)
            results["k8_attack"] = _k8_attack(old_lib, dev, card)
        print(f"ptxas {key} old:", " | ".join(_ptxas(old_log)))
        print(f"ptxas {key} new:", " | ".join(_ptxas(new_log)))
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    bad = [f"{c['kernel']} {c['cell']}" for c in results["cells"] if c["kernel"] != "K8" and (
           not c.get("flags_iters_decisions_equal", c["flags_equal"])
           or (c.get("rate", RATE) == RATE and c["successes"] < 0.999 * c["batch"]))]
    bad += [f"K8 {c['cell']} P={c['p']} batch {c['batch']}" for c in results["cells"] if c["kernel"] == "K8" and (
            min(c["frames_equal_to_plain"].values()) < c["batch"]
            or any(v.get("frames_equal_to_plain", c["batch"]) < c["batch"] for v in c["variants"].values()))]
    attack = results.get("k8_attack", [])
    if any(not r["success"] or r["calls"] != r["decodes"] or (r["successes"], r["oracle_calls"])
           != (attack[0]["successes"], attack[0]["oracle_calls"]) for r in attack):
        bad.append("K8 attack")
    if bad:
        print(f"circulant_forms: the forms disagree, or frames were lost, in {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
