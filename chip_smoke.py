#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

The main path is batched syndrome BP on the HQC-128 attack code
[circulant(17669, 20) | I] (35,338 columns): the FER step at batch 4096,
error rate 0.01, up to 30 product-sum iterations, and the decoder API.

Phases (each prints one line; any failure exits non-zero):
  1. build the CUDA kernels from csrc/ and the HQC-128 code (seed 0);
  2. K2 (circulant_bp_cuda) against its plain PyTorch version on the card:
     512 frames, product-sum and min-sum, decisions and flags equal;
  3. K1 (circulant_fer_cuda) against its plain version: 512 frames at error
     rates 0.01 (flags equal) and 0.05 (success counts within 2% of the
     frames: f32 sums run in another order, which can flip a frame near
     the decoding threshold);
  4. the main path through the public API, with the kernels' launch counts
     reset before and read after: fer_simulation at batch 4096 (frames/s
     best of 3 after a warm-up, success rate >= 0.999) and
     CirculantBPDecoder.decode_received on 4096 device-sampled frames.

Then one JSON line of per-kernel results, and as the last line
{"ok": true, "device": {...}}.  Run from the repository root:

    python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N, W, ERR, MAX_ITER = 17669, 20, 0.01, 30
CMP_FRAMES = 512
BATCH, BATCHES = 4096, 5


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _ms(fn, repeats=3):
    """Best-of-``repeats`` device time of ``fn()`` in ms (CUDA events), after one warm-up."""
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


def _errors(rng, frames, rate):
    return (rng.random_sample((frames, 2 * N)) < rate).astype(np.uint8)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "the port's kernels run only on an NVIDIA GPU", file=sys.stderr)
        return 1

    from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
    from sca_ldpc_tpu_torch.ops import CirculantBPDecoder
    from sca_ldpc_tpu_torch.ops.kernels import _build
    from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
        circulant_bp_cuda,
        circulant_bp_plain,
        circulant_fer_cuda,
        circulant_fer_plain,
    )
    from sca_ldpc_tpu_torch.parallel import fer_simulation
    from sca_ldpc_tpu_torch.utils import make_random_state, rng_to_torch_generator

    dev = torch.device("cuda:0")
    card = _card()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {nvcc.stdout.strip().splitlines()[-1]}")
    tag = f"[{card}]"

    # ---- phase 1: build and code
    t0 = time.perf_counter()
    lib_path = _build.build("circulant_bp")
    _build.load("circulant_bp")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    first_row = random_circulant_first_row(N, W, make_random_state(0))
    lay = CirculantLayout.from_first_row(first_row, with_identity=True)
    if lay.n != N or lay.weight != W:
        raise SystemExit(f"HQC-128 code has n={lay.n} w={lay.weight}")
    print(f"phase 1 build+code: built {lib_path.name} in {build_s:.1f} s; HQC-128 code "
          f"N={lay.n} w={lay.weight} n_vars={lay.n_vars}; ptxas: {' | '.join(ptxas)}")

    rng = np.random.RandomState(1234)
    results = {}

    # ---- phase 2: K2 against its plain version
    err = _errors(rng, CMP_FRAMES, ERR)
    err_t = torch.from_numpy(err).to(dev)
    syn = (sum(torch.roll(err_t[:, :N].int(), k, dims=-1) for k in lay.shifts) + err_t[:, N:]) % 2
    probs = torch.full((lay.n_vars,), ERR, dtype=torch.float32, device=dev)
    k2_err = 0
    for method in ("product_sum", "min_sum"):
        dec = CirculantBPDecoder(lay, max_iter=MAX_ITER, method=method, device=dev)
        e_k, conv_k, it_k = dec.decode_syndrome(syn, probs, return_aux=True)
        prior = dec._to_llr(probs[:N], N, CMP_FRAMES).contiguous()
        e_p, conv_p, _ = circulant_bp_plain(prior, prior, syn, lay.shifts, MAX_ITER, method)
        torch.cuda.synchronize()
        k2_err = max(k2_err, int((e_k - e_p).abs().max()))
        same = bool((e_k == e_p).all()) and bool((conv_k == conv_p).all())
        recovered = int((e_k == err_t).all(dim=-1).sum())
        print(f"phase 2 K2 {method}: kernel==plain on all {CMP_FRAMES} frames: {same}; "
              f"recovered {recovered}/{CMP_FRAMES}; converged {int(conv_k.sum())}; it {int(it_k)}")
        if not same:
            raise SystemExit(f"K2 {method}: kernel and plain version disagree")
        if method == "product_sum" and recovered != CMP_FRAMES:
            raise SystemExit("K2 product_sum: not every frame recovered at error rate 0.01")
        if method == "product_sum":
            results["bp_ms"] = _ms(lambda: circulant_bp_cuda(prior, prior, syn, lay.shifts, MAX_ITER, method))
            results["bp_plain_ms"] = _ms(lambda: circulant_bp_plain(prior, prior, syn, lay.shifts, MAX_ITER, method))
    if circulant_bp_cuda.launches <= 0:
        raise SystemExit("K2 never launched")
    print(f"phase 2 K2 launches {circulant_bp_cuda.launches}; product_sum {CMP_FRAMES} frames: "
          f"kernel {results['bp_ms']:.3f} ms, plain {results['bp_plain_ms']:.3f} ms {tag}")

    # ---- phase 3: K1 against its plain version
    k1_err = 0
    for rate in (0.01, 0.05):
        e_t = err_t if rate == 0.01 else torch.from_numpy(_errors(rng, CMP_FRAMES, rate)).to(dev)
        ok_k, conv_k = circulant_fer_cuda(e_t, lay.shifts, rate, MAX_ITER, "product_sum")
        ok_p, conv_p = circulant_fer_plain(e_t, lay.shifts, rate, MAX_ITER, "product_sum")
        nk, npl = int(ok_k.sum()), int(ok_p.sum())
        diff = int((ok_k != ok_p).sum())
        print(f"phase 3 K1 rate {rate}: successes kernel {nk} plain {npl} of {CMP_FRAMES}; "
              f"flags differ on {diff} frames")
        if rate == 0.01:
            k1_err = int((ok_k.int() - ok_p.int()).abs().max())
            if diff:
                raise SystemExit("K1: success flags differ from the plain version at rate 0.01")
            results["fer_ms"] = _ms(lambda: circulant_fer_cuda(e_t, lay.shifts, rate, MAX_ITER))
            results["fer_plain_ms"] = _ms(lambda: circulant_fer_plain(e_t, lay.shifts, rate, MAX_ITER))
        elif abs(nk - npl) > 0.02 * CMP_FRAMES:
            raise SystemExit("K1: success counts differ by more than 2% at rate 0.05")
    print(f"phase 3 K1 launches {circulant_fer_cuda.launches}; {CMP_FRAMES} frames at 0.01: "
          f"kernel {results['fer_ms']:.3f} ms, plain {results['fer_plain_ms']:.3f} ms {tag}")

    # ---- phase 4: the main path through the public API
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    circulant_bp_cuda.launches = 0
    circulant_fer_cuda.launches = 0
    gen = rng_to_torch_generator(make_random_state(0), dev)
    probs_np = np.full(lay.n_vars, ERR, np.float32)
    frames = BATCH * BATCHES

    def fer():
        return fer_simulation(lay, probs_np, frames, gen, dev, batch=BATCH, max_iter=MAX_ITER)

    fer()
    best, successes = float("inf"), 0
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        successes, done = fer()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        if done != frames:
            raise SystemExit(f"fer_simulation ran {done} frames, expected {frames}")
        if successes / frames < 0.999:
            raise SystemExit(f"FER success rate {successes / frames} < 0.999")
    dec = CirculantBPDecoder(lay, max_iter=MAX_ITER, method="product_sum", device=dev)
    z = (torch.rand((BATCH, lay.n_vars), generator=gen, device=dev) < ERR).int()
    z_hat = dec.decode_received(z, probs_np)
    torch.cuda.synchronize()
    launches = {"circulant_fer_cuda": circulant_fer_cuda.launches, "circulant_bp_cuda": circulant_bp_cuda.launches}
    decoded_ok = int((z_hat == 0).all(dim=-1).sum())
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    fps = frames / best
    print(f"phase 4 main path: fer_simulation {frames} frames (batch {BATCH}, {BATCHES} batches): "
          f"success {successes / frames:.6f}, {fps:.1f} frames/s (best of 3); "
          f"decode_received {decoded_ok}/{BATCH} recovered; launches {launches}; "
          f"peak memory {peak_gb:.2f} GB {tag}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the main path was not launched: {launches}")
    if decoded_ok / BATCH < 0.999:
        raise SystemExit(f"decode_received recovered {decoded_ok}/{BATCH}")

    plain_gen = rng_to_torch_generator(make_random_state(1), dev)
    u = torch.rand((CMP_FRAMES, lay.n_vars), generator=plain_gen, device=dev)
    e_plain = (u < ERR).to(torch.uint8)
    plain_s = _ms(lambda: circulant_fer_plain(e_plain, lay.shifts, ERR, MAX_ITER)) / 1e3
    print(f"phase 4 plain FER step at batch {CMP_FRAMES}: {CMP_FRAMES / plain_s:.1f} frames/s; "
          f"kernel fer_simulation at batch {BATCH}: {fps:.1f} frames/s {tag}")

    src = "sca_ldpc_tpu_torch/csrc/circulant_bp.cu"
    print(json.dumps({"kernels": [
        {"name": "circulant_fer_cuda", "route": "cuda", "source": src,
         "replaces": "sca_ldpc_tpu/ops/kernels/circulant_pallas.py:723",
         "launches": launches["circulant_fer_cuda"], "max_abs_err": k1_err,
         "ms": results["fer_ms"], "plain_ms": results["fer_plain_ms"]},
        {"name": "circulant_bp_cuda", "route": "cuda", "source": src,
         "replaces": "sca_ldpc_tpu/ops/kernels/circulant_pallas.py:190",
         "launches": launches["circulant_bp_cuda"], "max_abs_err": k2_err,
         "ms": results["bp_ms"], "plain_ms": results["bp_plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
