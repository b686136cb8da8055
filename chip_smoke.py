#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

Path 1 is batched syndrome BP on the HQC-128 attack code
[circulant(17669, 20) | I] (35,338 columns): the FER step at batch 4096,
error rate 0.01, up to 30 product-sum iterations, and the decoder API.
Path 2 is q-ary min-sum decoding: the q-ary FER simulation on
DecoderN450R150V3C7B1 (regular (3,6) code with identity, B = 1) and the
reference's "medium decoder" (N = 450, R = 150, DV = 3, DC = 7, B = 7,
10 iterations) at batch 4096.  Path 3 is the Kyber-768 attack: the
two-alphabet decoder DecoderN1280R512SW6 (768 secret coefficients in
[-2..2], 512 check sums in [-12..12], SW = 6, DV = 4) at batch 4096, and the
fixed-pattern and adaptive attack simulations.  Path 4 is the HQC-192 and
HQC-256 FER step ([circulant(35851, 30) | I] and [circulant(57637, 30) | I],
bench.py --param-sets) at batch 2048 through K1 and through the lean kernel
K4, which stores its message planes in bf16 as the TPU's lean kernel does,
and the HQC-128 FER step through K4.  Path 5 is the HQC-128 key-recovery
attack with the idealized oracle (seed 0, the fixture key, a decode every 50
checks, circulant weight 20) through its masked multi-circulant decode, the
CUDA kernel K8, and through the general binary BP decode; path 6 the batched
multi-instance attack, whose decode rounds are one K8 launch on per-instance
shifts [I, P, W]; path 7 the attack against the measured timing oracle
(cycle-timed decapsulations on the host, "circulant" decodes on the card);
path 8 binary FER simulation on a (3, 6)-regular LDPC code of 300 columns
(the reference's regular_ldpc_code command).

Phases (each prints one line; any failure exits non-zero):
  1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel)
     and the HQC-128 code (seed 0); print ptxas's registers and spills for
     each K1/K2 instance and, for the instances that HQC-128/192/256 run at
     w = 20 and 30, the placement from the card's shared-memory limits and
     the resident warps from the occupancy calculator: fails unless tot is
     in shared memory, a thread has at most 64 registers and no spills, and
     32 warps are resident per SM;
  2. K2 (circulant_bp_cuda) against its plain PyTorch version on the card:
     512 frames, product-sum and min-sum, decisions and flags equal;
  3. K1 (circulant_fer_cuda) against its plain version: 512 frames at error
     rates 0.01 (flags equal) and 0.05 (success counts within 2% of the
     frames: f32 sums run in another order, which can flip a frame near
     the decoding threshold);
  4. path 1 through the public API, with the kernels' launch counts reset
     before and read after: fer_simulation at batch 4096 (frames/s best of
     3 after a warm-up, success rate >= 0.999) and
     CirculantBPDecoder.decode_received on 4096 device-sampled frames;
  5. K5 (chain_exclusive_cuda) against its plain version, bitwise, at the
     chain backends' shapes: the medium decoder's [512, 150, 7, 15], the
     early-exit q-ary FER's [512, 150, 7, 3], and the Kyber chain's with the
     extra operand, [512, 512, 6, 5] + [512, 512, 25] (eta 2) and
     [512, 512, 6, 7] + [512, 512, 37] (eta 3), each on the instance (warps a
     block, checks a warp) that chain_launch picks from the card's limits,
     with its time, bound and share of it; before it, ptxas's registers and
     spills of every K5 instance (fails above 64 registers or on a spill);
  6. K6 (qary_min_sum_fused_cuda) against the plain decode on the medium
     decoder (512 frames of Dirichlet channels, 10 iterations) and on its
     code at B = 1 (Q = 3, DecoderN450R150V3C7B1; 512 frames, 5
     iterations), hard decisions equal on every frame, each on the instance
     that fused_launch picks from the card's limits; before it, ptxas's
     registers and spills of every K6 instance (fails above 64 registers or
     on a spill), and for each Q the warps a block and blocks an SM picked
     and the blocks the occupancy calculator holds resident (fails if fewer
     than picked);
  7. path 2 through the public API, with the launch counts reset before and
     read after: simulate_frame_error_rate_qary on DecoderN450R150V3C7B1
     (seed 1, rate 0.005, 5 iterations, 4 x 4096 frames, backend "fused",
     the same triple as backend "plain" on the same device-sampled frames),
     the same with early_exit=True through the default backend ("chain",
     K5 at Q = 3) against backend "plain" with early_exit=True, and
     QaryDecoder.min_sum_llr on the medium decoder at batch 4096 for the
     backends fused, chain and plain (frames/s best of 3 after a warm-up;
     every frame decodes to the all-zero word); every K6 and K5 instance
     these launch was held against plain in phase 6 or 5;
  8. K7 (qary_special_min_sum_fused_cuda) against the plain decode on
     DecoderN1280R512SW6: 512 frames of Dirichlet channels, 10 iterations,
     B and sum decisions equal on every frame, at eta = 2 and at the
     adaptive path's eta = 3 (QB = 7, QS = 37), each on the instance that
     special_fused_launch picks from the card's limits; before it, ptxas's
     registers and spills of every K7 instance, and for each eta the warps a
     block and blocks an SM picked and the blocks the occupancy calculator
     holds resident (fails if fewer than picked);
  9. path 3 through the public API, with the launch counts reset before and
     read after: QarySpecialDecoder.min_sum_llr at batch 4096, 10 iterations,
     on bench.py's Kyber channel (B-symbol 0 at 0.92, the others 0.02, sums
     certain at 0) for the backends fused, chain and plain (frames/s best of
     3 after a warm-up; every frame decodes to the all-zero word);
     simulate_kyber_attack (seed 7, accuracy 0.995, 2 runs) on the card,
     equal to the same call on the CPU with >= 95% of coefficients right;
     simulate_kyber_attack_adaptive (seed 0, eta = 3) with full recovery;
     every K7 and K5 instance these launch was held against plain in phase
     8 or 5;
 10. K3 (circulant_bp_lean_cuda) against its plain version at HQC-256
     (seed 0): 256 frames at error rate 0.01, decisions, flags and
     iteration counts equal; before it, ptxas's registers and spills and
     the resident blocks of the lean kernel's two instances: fails on a
     spill, on fewer than 32 resident warps per SM, or when the occupancy
     calculator's blocks are not those the launch configuration counts on;
 11. K4 (circulant_fer_lean_cuda) against its plain version on the same
     frames (flags equal); K3 and K4 on the w = 20 instance that path 4
     runs at HQC-128: 512 frames at rate 0.01, decisions, flags and
     iteration counts equal to plain and K4's flags equal to K3's; K4 on 512
     HQC-128 frames at rate 0.05, 50 iterations (success counts within 2%
     of the frames, as phase 3); K1 against its plain version on the w = 30
     instance that path 4 runs: 256 HQC-192 and 256 HQC-256 frames (the
     same as K3's) at rate 0.01 (flags equal) and 256 of each at 0.02
     (success counts within 2%);
 12. K2 on the HQC-128 circulant without the identity block
     (with_identity=False) against its plain version through
     CirculantBPDecoder: 512 frames, product-sum and min-sum, decisions
     equal;
 13. path 4 through the public API, with the launch counts reset before and
     read after: fer_simulation at rate 0.01, 30 iterations, backends
     "fused" (K1) and "lean" (K4), on HQC-192 and HQC-256 at batch 2048, and
     backend "lean" on HQC-128 at batch 4096 (phase 4 has "fused" there):
     frames/s best of 3 ("lean": of 2) after a warm-up, success rate >=
     0.999, peak device memory; and the lean decode API
     (circulant_bp_lean_cuda) on 2048 device-sampled HQC-256 frames;
 14. K1 against K4 on the same 8192 device-sampled HQC-128 frames at rates
     0.03 and 0.05, 50 iterations: success counts side by side (f32 against
     bf16 message planes; reported, not gated);
 15. K1's and K4's iteration sweeps on the three FER cells' traffic (HQC-128
     at batch 4096, HQC-192 and HQC-256 at 2048, rate 0.01): ms at max_iter
     0-3 (best of 3), so set-up, first and each later iteration;
 16. K8 (multi_circulant_bp_cuda, one cooperative launch a decode) against
     its plain version on the seed-0 attack's own check sets (N = 17,669,
     W = 20, recorded through a decode executor from a run of the attack;
     tools/attack_cells.py): the recovery's 2,850 rows, the same at their
     true values, and the first decode's 50 (which does not converge and
     runs 100 iterations), at P = 1, 3 and 8 blocks (every block measures
     the same rows, each with its value under that block's circulant, wrong
     where the attack's check was wrong) and batch 1 and 16 (the last or the
     first 16 decodes' sets): decisions, conv and iteration counts equal to
     plain on every frame, converged or not; at P = 1 equal to K2 on every
     frame either converged; ms a decode and an iteration (K8, plain, K2 at
     P = 1), the grid multi_circulant_launch picks and the blocks an SM,
     bound and share; before it, ptxas's registers and spills of every K8
     instance (fails on a spill) and the barriers an iteration;
 17. path 5 through the public API, with the launch counts reset before and
     read after: simulate_hqc_idealized_oracle with decode_backend
     "circulant" (K8), "general" and "padded" on the card, and "circulant"
     on the CPU, whose success sequence and oracle calls the card run must
     equal; success, oracle calls, decodes, wall s, s inside the decodes,
     and of those K8's own device time (CUDA events around each launch);
 18. K8 with per-instance shifts [I, P, W] on batched rounds built from the
     attack's recorded check sets (tools/attack_cells.instance_cell: each
     instance its own circulants and block count, padded to the round's
     largest), I = 4 (the last 4 decodes' sets, P = 1, 3, 8, 2) and I = 16
     (the first 8 and last 8 decodes' sets, P = 1 to 8): decisions, conv
     and iteration counts equal to plain and to one [P, W] launch an
     instance on every frame; [B, P, W] with equal rows bit-equal to the
     [P, W] launch (phase 16's 2,850-row cell at P = 3, batch 16); ms of
     the one launch against the I launches (the JAX executor's way), plain
     ms, bound and share; the one launch with the shifts staged a tile at a
     time (stage 2, forced) beside it;
 19. path 6 through the public API, with the launch counts reset before and
     read after: simulate_hqc_attacks_batched, 4 seeds (0-3), "circulant",
     every instance on the fixture key: each recovers it, with the success
     sequence and oracle calls of its own simulate_hqc_idealized_oracle run
     on the card; K8 launched once a round; wall s, the rounds' s, K8's
     device time;
 20. path 7: hqc_eval_oracle at tiny counts (the sweep's mechanics), then
     simulate_hqc_idealized_oracle with oracle_backend "timing" and
     "circulant" decodes on the card, run to key recovery (launch counts
     reset before and read after), with the cycle counter modelled
     (tools/attack_cells.ModelledClock: the plaintext's seed expansions
     times the card host's profiled cost, plus seeded noise) so that the
     run is the same on every host: calibration and its guard (measure 64,
     profile 2^13, 100 trials a class), the differential decisions,
     recalibration, the Bayesian amplification with CERTAINTY_CAP; the key
     recovered, at least one decode, each one K8 launch; decisions,
     decapsulations, decodes and s.  The host's own counter is measured
     by tools/timing_calibration.py, not here;
 21. path 8: simulate_frame_error_rate on
     make_regular_ldpc_parity_check_matrix(300, 150, 3, 6, seed 0) on the
     card at rate 0.02 (frames/s, FER) and 0.07 (FER near 0.25), each
     within 3 binomial sigma of the port's CPU run of the same call.

Then one JSON line of per-kernel results (time, plain version's time, the
bound from ops/kernels/bounds.py with the work this run's inputs needed, and
library_ms null: no single PyTorch call computes any of them), and as the
last line {"ok": true, "device": {...}}.  Run from the repository root:

    python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N, W, ERR, MAX_ITER = 17669, 20, 0.01, 30
CMP_FRAMES = 512
BATCH, BATCHES = 4096, 5
SOURCES = ("circulant_bp", "qary_min_sum", "circulant_lean", "circulant_multi")
QB, QITER = 7, 10  # medium decoder: B, iterations
FER_B, FER_RATE, FER_ITER, FER_BATCHES = 1, 0.005, 5, 4
KY_SW, KY_ITER = 6, 10  # Kyber-768 decoder: sum weight, iterations
N192, N256, W_BIG = 35851, 57637, 30  # HQC-192 and HQC-256 attack codes (bench.py:305-308)
LEAN_FRAMES, PS_BATCH, PS_BATCHES = 256, 2048, 2
BF16_FRAMES, BF16_ITER = 8192, 50
K1_HARD_RATE = 0.02  # a noisier HQC-192/256 rate: more iterations a frame


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


def _ptxas(lib_path):
    return [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
            if "registers" in ln or "spill" in ln]


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _entry(name, src, replaces, launches, err, ms, plain_ms, bound):
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None}


def _bitwise_equal(a, b):
    return a.shape == b.shape and bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def _best_s(fn, repeats=3):
    """Best-of-``repeats`` wall time of ``fn()`` in s, synchronised, after a warm-up;
    returns (seconds, last result)."""
    out = fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


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
    from sca_ldpc_tpu_torch.ops.kernels.bounds import circulant_bound_ms
    from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
        circulant_bp_cuda,
        circulant_bp_plain,
        circulant_fer_cuda,
        circulant_fer_plain,
        circulant_occupancy,
        circulant_ptxas,
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
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        lib_paths = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    for name in SOURCES:
        _build.load(name)
    build_s = time.perf_counter() - t0
    ptxas = circulant_ptxas()
    first_row = random_circulant_first_row(N, W, make_random_state(0))
    lay = CirculantLayout.from_first_row(first_row, with_identity=True)
    if lay.n != N or lay.weight != W:
        raise SystemExit(f"HQC-128 code has n={lay.n} w={lay.weight}")
    print(f"phase 1 build+code: built {', '.join(p.name for p in lib_paths.values())} in {build_s:.1f} s; HQC-128 code "
          f"N={lay.n} w={lay.weight} n_vars={lay.n_vars}; ptxas (K1/K2 instances, w <= MAXW): "
          f"{' | '.join(f'w<={mw} {m} {pl} {r} regs/{sp} B spill' for (mw, m, pl), (r, sp) in ptxas.items())}")
    occupancy = []
    for n_hqc in (N, N192, N256):
        for w_hqc in (W, W_BIG):
            for method in ("product_sum", "min_sum"):
                occ = circulant_occupancy(n_hqc, w_hqc, method, dev)
                # w = 20 and 30 have instances of exactly that MAXW
                regs, spill = ptxas[(w_hqc, method, occ["placement"])]
                occupancy.append(f"N={n_hqc} w={w_hqc} {method}: tot in {occ['placement']} memory, "
                                 f"{occ['resident_blocks']} x {occ['threads']} threads = {occ['resident_warps']} "
                                 f"warps/SM, {regs} regs, {spill} B spill")
                if occ["placement"] != "shared" or occ["resident_warps"] < 32 or regs > 64 or spill:
                    raise SystemExit(f"K1/K2 launch configuration below the design: {occupancy[-1]}")
    print(f"phase 1 K1/K2 occupancy: {' | '.join(occupancy)}")

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
            # the frames' own iteration counts (K1 decodes the same frames in phase 3)
            results["iters"] = int(circulant_bp_cuda(prior, prior, syn, lay.shifts, MAX_ITER, method)[2].sum())
            results["bp_bytes"] = _nbytes(prior, prior, syn, e_k, conv_k) + 4 * CMP_FRAMES
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

    qary, k5_held = _qary_phases(dev, tag, lib_paths["qary_min_sum"])
    kyber = _kyber_phases(dev, tag, k5_held)
    lean = _lean_phases(dev, tag, lib_paths["circulant_lean"], lay)
    _k1_sweep(dev, tag, lay)
    attack = _attack_phases(dev, tag)
    _fer_phase(dev, tag)

    src = "sca_ldpc_tpu_torch/csrc/circulant_bp.cu"
    # K1's first iteration needs no phi a message under its one constant prior
    k1_bound = circulant_bound_ms(results["iters"] - CMP_FRAMES, W, N, _nbytes(err_t) + 2 * CMP_FRAMES)
    k2_bound = circulant_bound_ms(results["iters"], W, N, results["bp_bytes"])
    print(f"bounds [{card}]: K1 {k1_bound[0]:.3f} ms ({k1_bound[1]}), kernel at "
          f"{100 * k1_bound[0] / results['fer_ms']:.1f}%; K2 {k2_bound[0]:.3f} ms ({k2_bound[1]}), kernel at "
          f"{100 * k2_bound[0] / results['bp_ms']:.1f}%; {results['iters'] / CMP_FRAMES:.3f} iterations a frame")
    print(json.dumps({"kernels": [
        _entry("circulant_fer_cuda", src, "sca_ldpc_tpu/ops/kernels/circulant_pallas.py:723",
               launches["circulant_fer_cuda"], k1_err, results["fer_ms"], results["fer_plain_ms"], k1_bound),
        _entry("circulant_bp_cuda", src, "sca_ldpc_tpu/ops/kernels/circulant_pallas.py:190",
               launches["circulant_bp_cuda"], k2_err, results["bp_ms"], results["bp_plain_ms"], k2_bound),
        *qary,
        *kyber,
        *lean,
        *attack,
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _medium_code():
    from sca_ldpc_tpu_torch.codes import make_regular_ldpc_parity_check_matrix_identity
    from sca_ldpc_tpu_torch.utils import make_random_state

    rng = make_random_state(1)
    return make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, rng).astype(np.int8), rng


def _qary_phases(dev, tag, lib_path):
    """Phases 5-7; returns the q-ary kernels' entries of the JSON line and the
    K5 instances held against plain."""
    from sca_ldpc_tpu_torch.channels import probs_to_llr
    from sca_ldpc_tpu_torch.ops import QaryDecoder, decoder_name_for
    from sca_ldpc_tpu_torch.ops import minplus
    from sca_ldpc_tpu_torch.ops.kernels.bounds import chain_bound_ms
    from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import smem_limits
    from sca_ldpc_tpu_torch.ops.kernels.qary_cuda import (
        chain_exclusive_cuda,
        chain_exclusive_plain,
        chain_launch,
        chain_ptxas,
        fused_occupancy,
        fused_ptxas,
        qary_min_sum_fused_cuda,
        qary_min_sum_fused_plain,
    )
    from sca_ldpc_tpu_torch.sim import simulate_frame_error_rate_qary

    rng = np.random.RandomState(4321)
    q = 2 * QB + 1
    H, _ = _medium_code()

    # ---- phase 5: K5 against its plain version, bitwise
    print(f"phase 5 build: {lib_path.name}; ptxas: {' | '.join(_ptxas(lib_path))}")
    ptxas = chain_ptxas()
    print("phase 5 K5 instances (warps x checks a warp; 8 x 0 the per-warp form): " + " | ".join(
        f"{w}x{k} {regs} regs/{spill} B spill" for (w, k), (regs, spill) in ptxas.items()))
    if any(regs > 64 or spill for regs, spill in ptxas.values()):
        raise SystemExit(f"K5: an instance above 64 registers or with spills: {ptxas}")
    k5, k5_held = {}, set()
    dc = 7
    v2c = (rng.rand(CMP_FRAMES, 150, dc, q) * 20).astype(np.float32)
    v2c[rng.rand(*v2c.shape) < 0.1] = minplus.BIG
    v2c = torch.from_numpy(v2c).to(dev)
    sw, b2 = 6, 2
    se = sw * b2
    v2c2 = torch.from_numpy((rng.rand(CMP_FRAMES, 512, sw, 2 * b2 + 1) * 20).astype(np.float32)).to(dev)
    extra = torch.from_numpy((rng.rand(CMP_FRAMES, 512, 2 * se + 1) * 20).astype(np.float32)).to(dev)
    rng5 = np.random.RandomState(4322)  # the shapes added later draw apart, so phase 6's inputs stay
    v2c3 = (rng5.rand(CMP_FRAMES, 150, dc, 3) * 20).astype(np.float32)
    v2c3[rng5.rand(*v2c3.shape) < 0.1] = minplus.BIG
    v2c7 = (rng5.rand(CMP_FRAMES, 512, sw, 7) * 20).astype(np.float32)
    v2c7[rng5.rand(*v2c7.shape) < 0.1] = minplus.BIG
    v2c7[rng5.rand(*v2c7.shape) < 0.05] *= -1  # negative entries make the padding terms matter
    extra7 = (rng5.rand(CMP_FRAMES, 512, 2 * sw * 3 + 1) * 20).astype(np.float32)
    extra7[rng5.rand(*extra7.shape) < 0.05] *= -1
    for label, args in (("medium", (v2c, (dc - 1) * QB, QB)),
                        ("Q = 3", (torch.from_numpy(v2c3).to(dev), (dc - 1) * FER_B, FER_B)),
                        ("Kyber eta 2", (v2c2, (2 * sw - 1) * b2, b2, extra)),
                        ("Kyber eta 3", (torch.from_numpy(v2c7).to(dev), (2 * sw - 1) * 3, 3,
                                         torch.from_numpy(extra7).to(dev)))):
        x, s_mid, s_out, ex = (*args, None)[:4]
        d_, q_ = x.shape[2:]
        we = 0 if ex is None else ex.shape[-1]
        cfg = chain_launch(d_, q_, s_mid, s_out, we, *smem_limits(dev))
        k5_held.add((cfg.warps, cfg.checks))
        out_k = chain_exclusive_cuda(*args)
        out_p = chain_exclusive_plain(*args)
        torch.cuda.synchronize()
        same = _bitwise_equal(out_k, out_p)
        err = float((out_k - out_p).abs().max())
        ms = _ms(lambda: chain_exclusive_cuda(*args))
        plain_ms = _ms(lambda: chain_exclusive_plain(*args))
        bound = chain_bound_ms(x.shape[0] * x.shape[1], d_, (q_ - 1) // 2, s_mid, s_out, (we - 1) // 2 if we else 0,
                               _nbytes(*(t for t in args if isinstance(t, torch.Tensor)), out_k))
        k5[label] = (err, ms, plain_ms, bound)
        print(f"phase 5 K5 {label} {tuple(x.shape)}{'' if ex is None else ' + ' + str(tuple(ex.shape))} (s_mid "
              f"{s_mid}, s_out {s_out}): {cfg.warps} warps x {cfg.checks} checks a block, {cfg.blocks_per_sm} an SM, "
              f"{cfg.smem_bytes} B; kernel==plain bitwise: {same}; max_abs_err {err}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms; bound {bound[0]:.4f} ms ({bound[1]}), kernel at {100 * bound[0] / ms:.1f}% {tag}")
        if not same:
            raise SystemExit(f"K5 {label}: kernel and plain version disagree")
    if chain_exclusive_cuda.launches <= 0:
        raise SystemExit("K5 never launched")

    # ---- phase 6: K6 against the plain decode, medium decoder and Q = 3
    ptxas = fused_ptxas(6)
    print("phase 6 K6 instances (warps a block): " + " | ".join(
        f"{w} {regs} regs/{spill} B spill" for w, (regs, spill) in ptxas.items()))
    if any(regs > 64 or spill for regs, spill in ptxas.values()):
        raise SystemExit(f"K6: an instance above 64 registers or with spills: {ptxas}")
    k6, held = {}, set()
    for b, iters in ((QB, QITER), (FER_B, FER_ITER)):
        qb = 2 * b + 1
        dec = QaryDecoder(H, b, iters, backend="fused", device=dev)
        probs = rng.dirichlet(np.ones(qb), size=(CMP_FRAMES, H.shape[1])).astype(np.float32)
        llr = minplus.clip_inf(probs_to_llr(torch.from_numpy(probs).to(dev))).contiguous()
        # as the decoder launches it: its adjacency was checked when it was built
        k6_args = (llr, *dec._args, b, iters)
        lay = dec.layout
        occ = fused_occupancy(lay.n, lay.r, lay.dc, qb, dev)
        held.add(occ["warps"])
        hard_k = qary_min_sum_fused_cuda(*k6_args, check_adjacency=False)
        hard_p = qary_min_sum_fused_plain(*k6_args)
        torch.cuda.synchronize()
        differ = int((hard_k != hard_p).any(dim=-1).sum())
        err = int((hard_k - hard_p).abs().max())
        ms = _ms(lambda: qary_min_sum_fused_cuda(*k6_args, check_adjacency=False))
        plain_ms = _ms(lambda: qary_min_sum_fused_plain(*k6_args))
        bound = chain_bound_ms(CMP_FRAMES * lay.r * iters, lay.dc, b, (lay.dc - 1) * b, b, 0,
                               _nbytes(llr, *dec._args, hard_k))
        k6[b] = (err, ms, plain_ms, bound)
        print(f"phase 6 K6 {'medium decoder' if b == QB else decoder_name_for(H, b)} (Q {qb}): {occ['warps']} warps "
              f"a block, {occ['blocks_per_sm']} blocks an SM picked, {occ['resident_blocks']} resident "
              f"({occ['resident_warps']} warps), {occ['smem_bytes']} B shared memory a block; {CMP_FRAMES} Dirichlet "
              f"frames, {iters} iterations: hard decisions differ on {differ} frames; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms; bound {bound[0]:.4f} ms ({bound[1]}), kernel at {100 * bound[0] / ms:.1f}% {tag}")
        if differ:
            raise SystemExit(f"K6 Q {qb}: hard decisions differ from the plain version")
        if occ["resident_blocks"] < occ["blocks_per_sm"] or occ["lib_smem_bytes"] != occ["smem_bytes"]:
            raise SystemExit(f"K6 Q {qb}: the launch configuration is not what the card holds: {occ}")

    # ---- phase 7: path 2 through the public API
    torch.cuda.synchronize()
    chain_exclusive_cuda.launches = 0
    chain_exclusive_cuda.instances = set()
    qary_min_sum_fused_cuda.launches = 0
    qary_min_sum_fused_cuda.instances = set()
    H1, rng1 = _medium_code()
    name = decoder_name_for(H1, FER_B)
    runs = FER_BATCHES * BATCH
    t0 = time.perf_counter()
    fer = simulate_frame_error_rate_qary(H1, FER_B, FER_RATE, runs, rng1, iterations=FER_ITER,
                                         batch_size=BATCH, backend="fused", device=dev)
    fer_s = time.perf_counter() - t0
    H1p, rng1p = _medium_code()
    fer_plain = simulate_frame_error_rate_qary(H1p, FER_B, FER_RATE, runs, rng1p, iterations=FER_ITER,
                                               batch_size=BATCH, backend="plain", device=dev)
    print(f"phase 7 q-ary FER {name}: rate {FER_RATE}, {FER_ITER} iterations, {runs} frames: "
          f"(successes, max_errs_success, min_errs_fail) fused {fer} in {fer_s:.2f} s, plain {fer_plain} {tag}")
    if fer != fer_plain:
        raise SystemExit("q-ary FER: the fused backend and the plain backend disagree on the same frames")
    if not 0 < fer[0] < runs:
        raise SystemExit(f"q-ary FER: {fer[0]} successes of {runs} is outside (0, {runs})")
    if QaryDecoder(H, FER_B, FER_ITER, early_exit=True, device=dev).backend != "chain":
        raise SystemExit("the early-exit q-ary decoder's default backend on the card is not the chain kernel")
    fer_ee, ee_s = {}, {}
    for backend in (None, "plain"):
        H1e, rng1e = _medium_code()
        t0 = time.perf_counter()
        fer_ee[backend] = simulate_frame_error_rate_qary(H1e, FER_B, FER_RATE, runs, rng1e, iterations=FER_ITER,
                                                         batch_size=BATCH, backend=backend, early_exit=True,
                                                         device=dev)
        ee_s[backend] = time.perf_counter() - t0
    print(f"phase 7 q-ary FER {name} early exit: default backend (chain) {fer_ee[None]} in {ee_s[None]:.2f} s, "
          f"plain {fer_ee['plain']} in {ee_s['plain']:.2f} s {tag}")
    if fer_ee[None] != fer_ee["plain"]:
        raise SystemExit("early-exit q-ary FER: the chain backend and the plain backend disagree on the same frames")

    channel = np.zeros((BATCH, H.shape[1], q), np.float32)
    channel[:, :, QB] = 1.0
    channel[:, 1, QB] = 0.1
    channel[:, 1, q - 1] = 0.9
    llr_m = minplus.clip_inf(probs_to_llr(torch.from_numpy(channel).to(dev))).contiguous()
    fps = {}
    for backend in ("fused", "chain", "plain"):
        dec_b = QaryDecoder(H, QB, QITER, backend=backend, device=dev)
        best, hard = _best_s(lambda: dec_b.min_sum_llr(llr_m))
        zero = int((hard == 0).all(dim=-1).sum())
        fps[backend] = BATCH / best
        print(f"phase 7 medium decoder backend {backend}: {fps[backend]:.1f} frames/s at batch {BATCH} "
              f"(best of 3); all-zero {zero}/{BATCH} {tag}")
        if zero != BATCH:
            raise SystemExit(f"medium decoder backend {backend}: {BATCH - zero} frames not all-zero")
    torch.cuda.synchronize()
    launches = {"chain_exclusive_cuda": chain_exclusive_cuda.launches,
                "qary_min_sum_fused_cuda": qary_min_sum_fused_cuda.launches}
    launched = qary_min_sum_fused_cuda.instances
    k5_launched = chain_exclusive_cuda.instances
    print(f"phase 7 launches {launches}; K6 instances launched {sorted(launched)}, held against plain in phase 6 "
          f"{sorted(held)}; K5 instances launched {sorted(k5_launched)}, held in phase 5 {sorted(k5_held)}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the q-ary path was not launched: {launches}")
    if not launched <= held:
        raise SystemExit(f"K6 instances {sorted(launched - held)} ran on the q-ary path unchecked against plain")
    if not k5_launched <= k5_held:
        raise SystemExit(f"K5 instances {sorted(k5_launched - k5_held)} ran on the q-ary path unchecked against plain")

    src = "sca_ldpc_tpu_torch/csrc/qary_min_sum.cu"
    return [
        _entry("chain_exclusive_cuda", src, "sca_ldpc_tpu/ops/kernels/qary_pallas.py:104",
               launches["chain_exclusive_cuda"], max(x[0] for x in k5.values()), k5["medium"][1], k5["medium"][2],
               k5["medium"][3]),
        _entry("qary_min_sum_fused_cuda", src, "sca_ldpc_tpu/ops/kernels/qary_pallas.py:264",
               launches["qary_min_sum_fused_cuda"], max(k6[QB][0], k6[FER_B][0]), k6[QB][1], k6[QB][2], k6[QB][3]),
    ], k5_held


def _kyber_phases(dev, tag, k5_held):
    """Phases 8-9; returns K7's entry of the JSON line.  ``k5_held``: the K5
    instances phase 5 held against plain."""
    from sca_ldpc_tpu_torch.channels import probs_to_llr
    from sca_ldpc_tpu_torch.models.kyber import (
        gen_ldpc_matrix,
        simulate_kyber_attack,
        simulate_kyber_attack_adaptive,
    )
    from sca_ldpc_tpu_torch.ops import QarySpecialDecoder, get_decoder_by_name, minplus
    from sca_ldpc_tpu_torch.ops.qary import _signed
    from sca_ldpc_tpu_torch.ops.kernels.bounds import chain_bound_ms
    from sca_ldpc_tpu_torch.ops.kernels.qary_cuda import (
        chain_exclusive_cuda,
        fused_ptxas,
        qary_special_min_sum_fused_cuda,
        qary_special_min_sum_fused_plain,
        special_fused_occupancy,
    )
    from sca_ldpc_tpu_torch.utils import make_random_state

    rng = np.random.RandomState(5678)
    H = gen_ldpc_matrix(KY_SW, 0, check_blocks=2)
    n_b, r = H.shape[1] - H.shape[0], H.shape[0]

    # ---- phase 8: K7 against the plain decode
    print("phase 8 K7 instances (warps a block): " + " | ".join(
        f"{w} {regs} regs/{spill} B spill" for w, (regs, spill) in fused_ptxas(7).items()))
    k7, held = {}, set()
    for eta in (2, 3):
        bsum = KY_SW * eta
        dec = QarySpecialDecoder(H, eta, bsum, KY_ITER, backend="fused", device=dev)
        probs_b = rng.dirichlet(np.ones(2 * eta + 1), size=(CMP_FRAMES, n_b)).astype(np.float32)
        probs_s = rng.dirichlet(np.ones(2 * bsum + 1), size=(CMP_FRAMES, r)).astype(np.float32)
        # K7's inputs: clipped LLRs, the sum channel in row order and its signed form
        llr_b = minplus.clip_inf(probs_to_llr(torch.from_numpy(probs_b).to(dev))).contiguous()
        llr_s = minplus.clip_inf(probs_to_llr(torch.from_numpy(probs_s).to(dev)))
        llr_s = llr_s.index_select(1, dec._sum_var).contiguous()
        vsum = _signed(llr_s, dec._args[6]).contiguous()
        args = (llr_b, llr_s, vsum, *dec._args[:4], dec._args[6], eta, bsum, KY_ITER)
        occ = special_fused_occupancy(n_b, r, KY_SW, eta, bsum, dev)
        held.add(occ["warps"])
        hb_k, hs_k = qary_special_min_sum_fused_cuda(*args)
        hb_p, hs_p = qary_special_min_sum_fused_plain(*args)
        torch.cuda.synchronize()
        differ = int(((hb_k != hb_p).any(dim=-1) | (hs_k != hs_p).any(dim=-1)).sum())
        err = max(int((hb_k - hb_p).abs().max()), int((hs_k - hs_p).abs().max()))
        ms = _ms(lambda: qary_special_min_sum_fused_cuda(*args))
        plain_ms = _ms(lambda: qary_special_min_sum_fused_plain(*args))
        bound = chain_bound_ms(CMP_FRAMES * r * KY_ITER, KY_SW, eta, (2 * KY_SW - 1) * eta, eta, bsum,
                               _nbytes(*(x for x in args if isinstance(x, torch.Tensor)), hb_k, hs_k))
        k7[eta] = (err, ms, plain_ms, bound)
        print(f"phase 8 K7 DecoderN1280R512SW6 eta {eta} (QB {2 * eta + 1}, QS {2 * bsum + 1}): {occ['warps']} warps "
              f"a block, {occ['blocks_per_sm']} blocks an SM picked, {occ['resident_blocks']} resident "
              f"({occ['resident_warps']} warps), {occ['smem_bytes']} B shared memory a block; {CMP_FRAMES} Dirichlet "
              f"frames, {KY_ITER} iterations: decisions differ on {differ} frames, max_abs_err {err}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms {tag}")
        if differ:
            raise SystemExit(f"K7 eta {eta}: hard decisions differ from the plain version")
        if occ["resident_blocks"] < occ["blocks_per_sm"] or occ["lib_smem_bytes"] != occ["smem_bytes"]:
            raise SystemExit(f"K7 eta {eta}: the launch configuration is not what the card holds: {occ}")

    # ---- phase 9: path 3 through the public API
    torch.cuda.synchronize()
    chain_exclusive_cuda.launches = 0
    chain_exclusive_cuda.instances = set()
    qary_special_min_sum_fused_cuda.launches = 0
    qary_special_min_sum_fused_cuda.instances = set()
    ch_b = np.full((BATCH, n_b, 5), 0.02, np.float32)
    ch_b[:, :, 2] = 0.92
    ch_s = np.zeros((BATCH, r, 25), np.float32)
    ch_s[:, :, 12] = 1.0
    llr_b = probs_to_llr(torch.from_numpy(ch_b).to(dev))
    llr_s = probs_to_llr(torch.from_numpy(ch_s).to(dev))
    fps = {}
    for backend in ("fused", "chain", "plain"):
        dec = get_decoder_by_name("DecoderN1280R512SW6", H, KY_ITER, backend=backend, device=dev)
        best, hard = _best_s(lambda: dec.min_sum_llr(llr_b, llr_s))
        zero = int((hard == 0).all(dim=-1).sum())
        fps[backend] = BATCH / best
        print(f"phase 9 Kyber decoder backend {backend}: {fps[backend]:.1f} frames/s at batch {BATCH}, {KY_ITER} "
              f"iterations (best of 3); all-zero {zero}/{BATCH} {tag}")
        if zero != BATCH:
            raise SystemExit(f"Kyber decoder backend {backend}: {BATCH - zero} frames not all-zero")
    if QarySpecialDecoder(H, 2, 12, KY_ITER, device=dev).backend != "fused":
        raise SystemExit("the Kyber decoder's default backend on the card is not the fused kernel")

    kw = dict(accuracy=0.995, num_patterns=3, num_patterns_sum=3, sum_weight=KY_SW, check_blocks=2,
              iterations=KY_ITER, runs=2)
    t0 = time.perf_counter()
    attack = simulate_kyber_attack(make_random_state(7), device=dev, **kw)
    attack_s = time.perf_counter() - t0
    attack_cpu = simulate_kyber_attack(make_random_state(7), device="cpu", **kw)
    frac = min(res["correct_coefficients"] / res["total_coefficients"] for res in attack)
    print(f"phase 9 simulate_kyber_attack (seed 7, 2 runs) on the card in {attack_s:.2f} s: {attack}; "
          f"equal to the CPU run: {attack == attack_cpu}")
    if attack != attack_cpu:
        raise SystemExit(f"simulate_kyber_attack: card {attack} != CPU {attack_cpu}")
    if frac < 0.95:
        raise SystemExit(f"simulate_kyber_attack recovered only {frac:.4f} of the coefficients")
    t0 = time.perf_counter()
    adaptive = simulate_kyber_attack_adaptive(make_random_state(0), accuracy=0.995, runs=1, device=dev)
    print(f"phase 9 simulate_kyber_attack_adaptive (seed 0, eta 3) on the card in "
          f"{time.perf_counter() - t0:.2f} s: {adaptive}")
    if not adaptive[0]["recovered"]:
        raise SystemExit("simulate_kyber_attack_adaptive did not recover the secret")
    torch.cuda.synchronize()
    launches = {"qary_special_min_sum_fused_cuda": qary_special_min_sum_fused_cuda.launches,
                "chain_exclusive_cuda": chain_exclusive_cuda.launches}
    launched = qary_special_min_sum_fused_cuda.instances
    k5_launched = chain_exclusive_cuda.instances
    print(f"phase 9 launches {launches}; K7 instances launched {sorted(launched)}, held against plain in phase 8 "
          f"{sorted(held)}; K5 instances launched {sorted(k5_launched)}, held in phase 5 {sorted(k5_held)}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the Kyber path was not launched: {launches}")
    if not launched <= held:
        raise SystemExit(f"K7 instances {sorted(launched - held)} ran on the Kyber path unchecked against plain")
    if not k5_launched <= k5_held:
        raise SystemExit(f"K5 instances {sorted(k5_launched - k5_held)} ran on the Kyber path unchecked against plain")

    return [
        _entry("qary_special_min_sum_fused_cuda", "sca_ldpc_tpu_torch/csrc/qary_min_sum.cu",
               "sca_ldpc_tpu/ops/kernels/qary_pallas.py:414", launches["qary_special_min_sum_fused_cuda"],
               max(k7[2][0], k7[3][0]), k7[2][1], k7[2][2], k7[2][3]),
    ]


def _hqc_code(n):
    from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
    from sca_ldpc_tpu_torch.utils import make_random_state

    lay = CirculantLayout.from_first_row(random_circulant_first_row(n, W_BIG, make_random_state(0)), True)
    if lay.n != n or lay.weight != W_BIG:
        raise SystemExit(f"HQC code has n={lay.n} w={lay.weight}, expected {n}, {W_BIG}")
    return lay


def _lean_phases(dev, tag, lib_path, lay128):
    """Phases 10-14; returns the lean kernels' entries of the JSON line."""
    from sca_ldpc_tpu_torch.codes import CirculantLayout
    from sca_ldpc_tpu_torch.ops import CirculantBPDecoder
    from sca_ldpc_tpu_torch.ops.kernels import (
        circulant_bp_cuda,
        circulant_bp_lean_cuda,
        circulant_bp_lean_plain,
        circulant_fer_cuda,
        circulant_fer_lean_cuda,
        circulant_fer_lean_plain,
        circulant_fer_plain,
        circulant_bp_plain,
    )
    from sca_ldpc_tpu_torch.ops.kernels.bounds import circulant_bound_ms
    from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import circulant_lean_occupancy, circulant_lean_ptxas
    from sca_ldpc_tpu_torch.parallel import fer_simulation
    from sca_ldpc_tpu_torch.utils import make_random_state, rng_to_torch_generator

    rng = np.random.RandomState(2468)
    lay256 = _hqc_code(N256)
    n = lay256.n

    # ---- phase 10: K3 against its plain version at HQC-256
    ptxas, lean_cfg = circulant_lean_ptxas(), []
    for w_hqc in (W, W_BIG):
        for name, occ in circulant_lean_occupancy(w_hqc, dev).items():
            regs, spill = ptxas[name, occ["elems"]]
            lean_cfg.append(f"w={w_hqc} {name}: {occ['elems']} variables a thread, {occ['smem_bytes']} B staged, "
                            f"{regs} regs, {spill} B spill, {occ['resident_blocks']} blocks = "
                            f"{occ['resident_warps']} warps/SM")
            if spill or occ["resident_warps"] < 32 or occ["resident_blocks"] != occ["blocks_per_sm"]:
                raise SystemExit(f"the lean kernel spills, holds fewer than 32 warps an SM, or not the "
                                 f"{occ['blocks_per_sm']} blocks its launch configuration counts on: {lean_cfg[-1]}")
    print(f"phase 10 build: {lib_path.name}; lean kernel instances (decode K3, fer K4): {' | '.join(lean_cfg)}")
    err = torch.from_numpy((rng.random_sample((LEAN_FRAMES, 2 * n)) < ERR).astype(np.uint8)).to(dev)
    syn = (sum(torch.roll(err[:, :n].int(), k, dims=-1) for k in lay256.shifts) + err[:, n:]) % 2
    prior = torch.full((LEAN_FRAMES, n), float(np.log((1 - ERR) / ERR)), dtype=torch.float32, device=dev)
    k3_args = (prior, prior, syn, lay256.shifts, MAX_ITER)
    e_k, conv_k, it_k = circulant_bp_lean_cuda(*k3_args)
    e_p, conv_p, it_p = circulant_bp_lean_plain(*k3_args)
    torch.cuda.synchronize()
    k3_err = int((e_k - e_p).abs().max())
    same = torch.equal(e_k, e_p) and torch.equal(conv_k, conv_p) and torch.equal(it_k, it_p)
    recovered = int((e_k == err).all(dim=-1).sum())
    k3_ms = _ms(lambda: circulant_bp_lean_cuda(*k3_args))
    k3_plain_ms = _ms(lambda: circulant_bp_lean_plain(*k3_args))
    iters = int(it_k.sum())
    k3_bound = circulant_bound_ms(iters, W_BIG, n, _nbytes(prior, prior, syn, e_k, conv_k, it_k))
    print(f"phase 10 K3 HQC-256 N={n} w={W_BIG}, {LEAN_FRAMES} frames at {ERR}: decisions, conv and iters equal "
          f"to plain: {same}; recovered {recovered}/{LEAN_FRAMES}; iterations mean {float(it_k.float().mean()):.3f} "
          f"max {int(it_k.max())}; kernel {k3_ms:.3f} ms, plain {k3_plain_ms:.3f} ms {tag}")
    if not same:
        raise SystemExit("K3: kernel and plain version disagree")
    if recovered != LEAN_FRAMES:
        raise SystemExit("K3: not every HQC-256 frame recovered at error rate 0.01")

    # ---- phase 11: K4 against its plain version
    ok_k, conv_k = circulant_fer_lean_cuda(err, lay256.shifts, ERR, MAX_ITER)
    ok_p, conv_p = circulant_fer_lean_plain(err, lay256.shifts, ERR, MAX_ITER)
    torch.cuda.synchronize()
    k4_err = int((ok_k.int() - ok_p.int()).abs().max())
    same = torch.equal(ok_k, ok_p) and torch.equal(conv_k, conv_p)
    k4_ms = _ms(lambda: circulant_fer_lean_cuda(err, lay256.shifts, ERR, MAX_ITER))
    k4_plain_ms = _ms(lambda: circulant_fer_lean_plain(err, lay256.shifts, ERR, MAX_ITER))
    # the same frames as K3; the first iteration needs no phi a message under one constant prior
    k4_bound = circulant_bound_ms(iters - LEAN_FRAMES, W_BIG, n, _nbytes(err) + 2 * LEAN_FRAMES)
    print(f"phase 11 K4 HQC-256, the same {LEAN_FRAMES} frames: flags equal to plain: {same}; successes "
          f"{int(ok_k.sum())}; kernel {k4_ms:.3f} ms, plain {k4_plain_ms:.3f} ms {tag}")
    if not same:
        raise SystemExit("K4: success or convergence flags differ from the plain version at rate 0.01")
    # the w = 20 instance that path 4 runs at HQC-128 (another count of variables a thread than w = 30)
    e_s = torch.from_numpy(_errors(np.random.RandomState(1357), CMP_FRAMES, ERR)).to(dev)
    syn_s = (sum(torch.roll(e_s[:, :N].int(), k, dims=-1) for k in lay128.shifts) + e_s[:, N:]) % 2
    prior_s = torch.full((CMP_FRAMES, N), float(np.log((1 - ERR) / ERR)), dtype=torch.float32, device=dev)
    k3_s = circulant_bp_lean_cuda(prior_s, prior_s, syn_s, lay128.shifts, MAX_ITER)
    p3_s = circulant_bp_lean_plain(prior_s, prior_s, syn_s, lay128.shifts, MAX_ITER)
    k4_s = circulant_fer_lean_cuda(e_s, lay128.shifts, ERR, MAX_ITER)
    p4_s = circulant_fer_lean_plain(e_s, lay128.shifts, ERR, MAX_ITER)
    torch.cuda.synchronize()
    same3 = all(torch.equal(a, b) for a, b in zip(k3_s, p3_s))
    same4 = all(torch.equal(a, b) for a, b in zip(k4_s, p4_s))
    agree = torch.equal(k4_s[0], (k3_s[0] == e_s).all(dim=-1)) and torch.equal(k4_s[1], k3_s[1])
    print(f"phase 11 K3/K4 HQC-128 N={N} w={W} rate {ERR}, {CMP_FRAMES} frames: K3 decisions, conv and iters equal "
          f"to plain: {same3}; K4 flags equal to plain: {same4}; K4's flags equal K3's decisions and conv: {agree}; "
          f"successes {int(k4_s[0].sum())}, iterations mean {float(k3_s[2].float().mean()):.3f} max "
          f"{int(k3_s[2].max())}")
    if not (same3 and same4 and agree):
        raise SystemExit("K3/K4 at HQC-128: kernel and plain version disagree at rate 0.01")
    del e_s, syn_s, prior_s, k3_s, p3_s
    e_t = torch.from_numpy(_errors(rng, CMP_FRAMES, 0.05)).to(dev)
    ok_k, _ = circulant_fer_lean_cuda(e_t, lay128.shifts, 0.05, BF16_ITER)
    ok_p, _ = circulant_fer_lean_plain(e_t, lay128.shifts, 0.05, BF16_ITER)
    nk, npl = int(ok_k.sum()), int(ok_p.sum())
    print(f"phase 11 K4 HQC-128 rate 0.05, {BF16_ITER} iterations: successes kernel {nk} plain {npl} of "
          f"{CMP_FRAMES}; flags differ on {int((ok_k != ok_p).sum())} frames")
    if abs(nk - npl) > 0.02 * CMP_FRAMES:
        raise SystemExit("K4: success counts differ by more than 2% at rate 0.05")
    # K1 on the instance that path 4 runs (w = 30, tot in shared memory, 1 x 1024 threads)
    lay192 = _hqc_code(N192)
    for name, lay_b in (("HQC-192", lay192), ("HQC-256", lay256)):
        for rate in (ERR, K1_HARD_RATE):
            e_b = err if lay_b is lay256 and rate == ERR else torch.from_numpy(
                (rng.random_sample((LEAN_FRAMES, lay_b.n_vars)) < rate).astype(np.uint8)).to(dev)
            ok_k, conv_k = circulant_fer_cuda(e_b, lay_b.shifts, rate, MAX_ITER)
            ok_p, conv_p = circulant_fer_plain(e_b, lay_b.shifts, rate, MAX_ITER)
            torch.cuda.synchronize()
            nk, npl = int(ok_k.sum()), int(ok_p.sum())
            diff = int(((ok_k != ok_p) | (conv_k != conv_p)).sum())
            print(f"phase 11 K1 {name} N={lay_b.n} w={lay_b.weight} rate {rate}, {LEAN_FRAMES} frames: successes "
                  f"kernel {nk} plain {npl}; converged {int(conv_k.sum())} / {int(conv_p.sum())}; flags differ on "
                  f"{diff} frames")
            if rate == ERR and diff:
                raise SystemExit(f"K1 {name}: flags differ from the plain version at rate {ERR}")
            if abs(nk - npl) > 0.02 * LEAN_FRAMES:
                raise SystemExit(f"K1 {name}: success counts differ by more than 2% at rate {rate}")

    # ---- phase 12: K2 without the identity block
    lay_c = CirculantLayout(n=lay128.n, shifts=lay128.shifts, with_identity=False)
    e_c = torch.from_numpy((rng.random_sample((CMP_FRAMES, N)) < ERR).astype(np.uint8)).to(dev)
    syn_c = sum(torch.roll(e_c.int(), k, dims=-1) for k in lay_c.shifts) % 2
    probs = torch.full((N,), ERR, dtype=torch.float32, device=dev)
    zeros = torch.zeros((CMP_FRAMES, N), dtype=torch.float32, device=dev)
    launches = circulant_bp_cuda.launches
    for method in ("product_sum", "min_sum"):
        dec = CirculantBPDecoder(lay_c, max_iter=MAX_ITER, method=method, device=dev)
        e_k, conv_k = dec.decode_syndrome(syn_c, probs, return_aux=True)[:2]
        pr = dec._to_llr(probs, N, CMP_FRAMES).contiguous()
        e_p, conv_p, _ = circulant_bp_plain(pr, zeros, syn_c, lay_c.shifts, MAX_ITER, method, with_identity=False)
        torch.cuda.synchronize()
        same = torch.equal(e_k, e_p) and torch.equal(conv_k, conv_p)
        recovered = int((e_k == e_c).all(dim=-1).sum())
        print(f"phase 12 K2 {method} on circulant({N}, {W}) without the identity, {CMP_FRAMES} frames: decisions "
              f"{tuple(e_k.shape)} equal to plain: {same}; recovered {recovered}; converged {int(conv_k.sum())}")
        if not same:
            raise SystemExit(f"K2 {method} without the identity: kernel and plain version disagree")
    if circulant_bp_cuda.launches != launches + 2:
        raise SystemExit("K2 without the identity did not launch the kernel")

    # ---- phase 13: path 4 through the public API
    torch.cuda.synchronize()
    circulant_fer_cuda.launches = 0
    circulant_fer_lean_cuda.launches = 0
    circulant_bp_lean_cuda.launches = 0
    for name, lay_b, backend, batch in (("HQC-128", lay128, "lean", BATCH), ("HQC-192", lay192, "fused", PS_BATCH),
                                        ("HQC-192", lay192, "lean", PS_BATCH), ("HQC-256", lay256, "fused", PS_BATCH),
                                        ("HQC-256", lay256, "lean", PS_BATCH)):
        frames = batch * PS_BATCHES
        torch.cuda.reset_peak_memory_stats(dev)
        gen = rng_to_torch_generator(make_random_state(0), dev)
        probs_np = np.full(lay_b.n_vars, ERR, np.float32)
        repeats = 2 if backend == "lean" else 3
        best, (successes, done) = _best_s(lambda: fer_simulation(
            lay_b, probs_np, frames, gen, dev, batch=batch, max_iter=MAX_ITER, backend=backend), repeats)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"phase 13 {name} N={lay_b.n} w={lay_b.weight} fer_simulation backend {backend}: {frames} frames "
              f"(batch {batch}): success {successes / done:.6f}, {frames / best:.1f} frames/s (best of {repeats}); "
              f"peak memory {peak_gb:.2f} GB {tag}")
        if done != frames or successes / done < 0.999:
            raise SystemExit(f"{name} {backend}: success {successes}/{done} < 0.999")
    gen = rng_to_torch_generator(make_random_state(1), dev)
    z = (torch.rand((PS_BATCH, 2 * n), generator=gen, device=dev) < ERR).to(torch.uint8)
    syn = (sum(torch.roll(z[:, :n].int(), k, dims=-1) for k in lay256.shifts) + z[:, n:]) % 2
    prior = torch.full((PS_BATCH, n), float(np.log((1 - ERR) / ERR)), dtype=torch.float32, device=dev)
    e_hat, conv, iters = circulant_bp_lean_cuda(prior, prior, syn, lay256.shifts, MAX_ITER)
    torch.cuda.synchronize()
    recovered = int((e_hat == z).all(dim=-1).sum())
    launches = {"circulant_fer_cuda": circulant_fer_cuda.launches,
                "circulant_fer_lean_cuda": circulant_fer_lean_cuda.launches,
                "circulant_bp_lean_cuda": circulant_bp_lean_cuda.launches}
    print(f"phase 13 HQC-256 lean decode API: {recovered}/{PS_BATCH} recovered, iterations mean "
          f"{float(iters.float().mean()):.3f}; launches {launches}")
    if recovered / PS_BATCH < 0.999:
        raise SystemExit(f"lean decode recovered {recovered}/{PS_BATCH}")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of path 4 was not launched: {launches}")

    # ---- phase 14: f32 (K1) against bf16 (K4) message planes, same frames
    gen = rng_to_torch_generator(make_random_state(2), dev)
    for rate in (0.03, 0.05):
        e_t = (torch.rand((BF16_FRAMES, lay128.n_vars), generator=gen, device=dev) < rate).to(torch.uint8)
        ok_1, conv_1 = circulant_fer_cuda(e_t, lay128.shifts, rate, BF16_ITER)
        ok_4, conv_4 = circulant_fer_lean_cuda(e_t, lay128.shifts, rate, BF16_ITER)
        torch.cuda.synchronize()
        print(f"phase 14 HQC-128 rate {rate}, {BF16_ITER} iterations, {BF16_FRAMES} frames: successes K1 (f32) "
              f"{int(ok_1.sum())}, K4 (bf16) {int(ok_4.sum())}; converged {int(conv_1.sum())} / "
              f"{int(conv_4.sum())}; only K1 {int((ok_1 & ~ok_4).sum())}, only K4 {int((ok_4 & ~ok_1).sum())}")

    src = "sca_ldpc_tpu_torch/csrc/circulant_lean.cu"
    return [
        _entry("circulant_bp_lean_cuda", src, "sca_ldpc_tpu/ops/kernels/circulant_pallas.py:503",
               launches["circulant_bp_lean_cuda"], k3_err, k3_ms, k3_plain_ms, k3_bound),
        _entry("circulant_fer_lean_cuda", src, "sca_ldpc_tpu/ops/kernels/circulant_pallas.py:620",
               launches["circulant_fer_lean_cuda"], k4_err, k4_ms, k4_plain_ms, k4_bound),
    ]


def _k1_sweep(dev, tag, lay128):
    """Phase 15: K1's and K4's times at max_iter 0-3 on the three FER cells' traffic."""
    from sca_ldpc_tpu_torch.ops.kernels import circulant_fer_cuda, circulant_fer_lean_cuda
    from sca_ldpc_tpu_torch.utils import make_random_state, rng_to_torch_generator

    for name, lay_b, batch in (("HQC-128", lay128, BATCH), ("HQC-192", _hqc_code(N192), PS_BATCH),
                               ("HQC-256", _hqc_code(N256), PS_BATCH)):
        gen = rng_to_torch_generator(make_random_state(3), dev)
        e_b = (torch.rand((batch, lay_b.n_vars), generator=gen, device=dev) < ERR).to(torch.uint8)
        for kernel, fer in (("K1", circulant_fer_cuda), ("K4", circulant_fer_lean_cuda)):
            t = [_ms(lambda m=m: fer(e_b, lay_b.shifts, ERR, m)) for m in range(4)]
            print(f"phase 15 {kernel} {name} batch {batch} sweep: ms at max_iter 0/1/2/3 "
                  f"{' / '.join(f'{x:.3f}' for x in t)}; set-up {t[0]:.3f}, first iteration {t[1] - t[0]:.3f}, each "
                  f"later one {(t[3] - t[1]) / 2:.3f} {tag}")
        del e_b


class _TimedLib:
    """K8's library with CUDA events recorded around each decode launch."""

    def __init__(self, lib):
        self.lib, self.events = lib, []

    def multi_circulant_bp_decode(self, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = self.lib.multi_circulant_bp_decode(*args)
        end.record()
        self.events.append((start, end))
        return rc

    def __getattr__(self, name):
        return getattr(self.lib, name)


def _attack_phases(dev, tag):
    """Phases 16-17; returns K8's entry of the JSON line."""
    from sca_ldpc_tpu_torch.models.hqc import simulate_hqc_idealized_oracle
    from sca_ldpc_tpu_torch.ops.kernels import circulant_bp_cuda, circulant_cuda, multi_circulant_bp_cuda, \
        multi_circulant_bp_plain
    from sca_ldpc_tpu_torch.ops.kernels.bounds import multi_circulant_bound_ms
    from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
        multi_circulant_launch,
        multi_circulant_occupancy,
        multi_circulant_ptxas,
    )
    from sca_ldpc_tpu_torch.tools.attack_cells import ATTACK, BATCH, BLOCKS, ITERATIONS, cells, masked_cell, pick, \
        record_sets
    from sca_ldpc_tpu_torch.utils import make_random_state

    # ---- phase 16: K8 against its plain version on the attack's check sets
    t0 = time.perf_counter()
    ok, tracking, sets = record_sets(dev)
    print(f"phase 16 check sets of the seed-0 attack: recovered {ok} after {tracking.num_oracle_calls} oracle calls, "
          f"{len(sets)} decodes of {len(sets[0][2])} to {len(sets[-1][2])} checks "
          f"({time.perf_counter() - t0:.2f} s)")
    if not ok or len(sets) < BATCH:
        raise SystemExit("phase 16: the seed-0 attack did not recover the key with enough decodes")
    ptxas = multi_circulant_ptxas()
    w = ATTACK["weight"]
    occ = {(p, m): multi_circulant_occupancy(w, m, p, dev) for p in BLOCKS for m in ("product_sum", "min_sum")}
    print("phase 16 K8 instances (MAXW, method: registers, spill bytes): " + " | ".join(
        f"{mw} {m}: {r}/{sp}" for (mw, m), (r, sp) in sorted(ptxas.items()))
          + "; blocks an SM at w = 20 (P, method): " + " | ".join(
        f"{p} {m}: {o['blocks_per_sm']} of {o['threads']} threads" for (p, m), o in occ.items())
          + f"; {occ[1, 'product_sum']['sms']} SMs, cooperative launch {occ[1, 'product_sum']['cooperative']}; "
          "3 grid barriers an iteration (check, variable, syndrome sweeps), one launch a decode")
    if any(sp for _r, sp in ptxas.values()):
        raise SystemExit(f"K8: an instance spills: {ptxas}")
    k8_err, main, frames = 0, None, 0
    for label, end, true_values, p in cells():
        for b in (1, BATCH):
            args = masked_cell(pick(sets, end, b), p, dev, true_values)
            out_k = multi_circulant_bp_cuda(*args, ITERATIONS)
            out_p = multi_circulant_bp_plain(*args, ITERATIONS)
            torch.cuda.synchronize()
            e_c, e_i, conv, it = out_k
            frames += b
            same = ((e_c == out_p[0]).all(dim=-1) & (e_i == out_p[1]).flatten(1).all(dim=-1)
                    & (it == out_p[3]) & (conv == out_p[2]))
            diff_bits = int((e_c != out_p[0]).sum() + (e_i != out_p[1]).sum())
            k8_err = max(k8_err, int((e_c - out_p[0]).abs().max()), int((e_i - out_p[1]).abs().max()))
            ms_k = _ms(lambda: multi_circulant_bp_cuda(*args, ITERATIONS))
            ms_p = _ms(lambda: multi_circulant_bp_plain(*args, ITERATIONS), repeats=1)
            iters = int(it.max())
            nbytes = _nbytes(*args, e_c.to(torch.uint8), e_i.to(torch.uint8), conv, it)
            bound = multi_circulant_bound_ms(int(it.sum()), p, w, N, nbytes)
            o = occ[p, "product_sum"]
            cfg = multi_circulant_launch(b, p, N, o["blocks_per_sm"], o["sms"])
            k2 = ""
            if p == 1:
                k2_args = (args[0], args[1][:, 0].contiguous(), args[2][:, 0].contiguous(), args[3][0].tolist(),
                           ITERATIONS, "product_sum")
                e2, conv2, it2 = circulant_bp_cuda(*k2_args)
                torch.cuda.synchronize()
                same2 = (torch.cat([e_c, e_i[:, 0]], dim=-1) == e2).all(dim=-1) & (it == it2) & (conv == conv2)
                either2 = conv | conv2
                ms_2 = _ms(lambda: circulant_bp_cuda(*k2_args))
                k2 = (f"; K2 {ms_2:.3f} ms ({ms_2 / max(int(it2.max()), 1):.4f} an iteration), equal to K8 on "
                      f"{int(same2.sum())}/{b} frames, on every converged one: {bool(same2[either2].all())}")
                if not bool(same2[either2].all()):
                    raise SystemExit(f"K8 {label} P=1 batch {b}: decisions differ from K2 on a converged frame")
            print(f"phase 16 K8 {label}{'' if b == 1 else f' (the {b} decodes at that end)'} P={p} batch {b}: "
                  f"converged {int(conv.sum())}/{b} (plain {int(out_p[2].sum())}), iterations {it.tolist()}; "
                  f"equal to plain on {int(same.sum())}/{b} frames ({diff_bits} decision bits differ); "
                  f"K8 {ms_k:.3f} ms ({ms_k / max(iters, 1):.4f} an iteration), plain {ms_p:.3f} ms "
                  f"({ms_p / max(iters, 1):.4f}){k2}; grid {cfg.grid} blocks of {cfg.threads} for {cfg.row_tiles} "
                  f"check + {cfg.var_tiles} variable tiles, {o['blocks_per_sm']} blocks an SM; bound "
                  f"{bound[0]:.4f} ms ({bound[1]}), K8 at {100 * bound[0] / ms_k:.2f}% {tag}")
            if not bool(same.all()):
                # K8 sums in the plain version's order, so it gives the same bits even on a frame that runs all
                # its iterations unconverged
                raise SystemExit(f"K8 {label} P={p} batch {b}: {int((~same).sum())} frames differ from plain "
                                 f"({diff_bits} decision bits; iterations {it.tolist()} against {out_p[3].tolist()})")
            if true_values and b == 1 and not bool(conv.all()):
                raise SystemExit("K8: the recovery's rows at their true values did not converge")
            if label == "2850 rows" and p == 1 and b == 1:
                main = (ms_k, ms_p, bound)  # the attack's own recovery decode
    print(f"phase 16 K8: all {frames} frames of the {2 * len(cells())} cells equal to plain; max_abs_err {k8_err}")

    # ---- phase 17: path 5 through the public API
    torch.cuda.synchronize()
    for kernel in (circulant_bp_cuda, multi_circulant_bp_cuda):
        kernel.launches = 0
    runs = {}
    lib = circulant_cuda._multi_lib
    for backend, device in (("circulant", dev), ("general", dev), ("padded", dev), ("circulant", "cpu")):
        timed = _TimedLib(lib()) if backend == "circulant" and device == dev else None
        if timed:
            circulant_cuda._multi_lib = lambda: timed
        t0 = time.perf_counter()
        try:
            ok, tracking = simulate_hqc_idealized_oracle(make_random_state(0), decode_backend=backend, device=device,
                                                         **ATTACK)
            if device == dev:
                torch.cuda.synchronize()
        finally:
            circulant_cuda._multi_lib = lib
        wall = time.perf_counter() - t0
        runs[backend, str(device)] = (ok, tracking)
        k8 = ""
        if timed:
            launches = multi_circulant_bp_cuda.launches
            k8_s = sum(start.elapsed_time(end) for start, end in timed.events) / 1e3
            k8 = (f" (K8's own device time {k8_s:.4f} s over its {len(timed.events)} launches, the rest "
                  f"{tracking.decode_seconds - k8_s:.4f} s)")
        print(f"phase 17 attack decode_backend {backend} on {device}: success {ok}, {tracking.num_oracle_calls} "
              f"oracle calls, {len(tracking.decoder_stats)} decodes, {wall:.2f} s, {tracking.decode_seconds:.2f} s "
              f"inside the decodes{k8}, {wall - tracking.decode_seconds:.2f} s outside"
              + (f" {tag}" if device == dev else ""))
        if not ok:
            raise SystemExit(f"the {backend} attack on {device} did not recover the key")
    card, cpu = runs["circulant", str(dev)][1], runs["circulant", "cpu"][1]
    same = ([d["success"] for d in card.decoder_stats] == [d["success"] for d in cpu.decoder_stats]
            and card.num_oracle_calls == cpu.num_oracle_calls)
    print(f"phase 17 launches {{'multi_circulant_bp_cuda': {launches}}}; the card's circulant run equals the CPU "
          f"run (success sequence, oracle calls): {same}; final stats equal: "
          f"{card.decoder_stats[-1] == cpu.decoder_stats[-1]}")
    if not same:
        raise SystemExit("the circulant attack on the card and on the CPU disagree")
    if launches != len(card.decoder_stats):
        raise SystemExit(f"K8 launched {launches} times for {len(card.decoder_stats)} decodes of path 5")
    k8_err = max(k8_err, _instance_phase(dev, tag, sets))
    launches += _batched_phase(dev, tag)
    launches += _timing_phase(dev, tag)
    print(f"K8 launches on the main paths (phases 17, 19, 20): {launches}")
    return [_entry("multi_circulant_bp_cuda", "sca_ldpc_tpu_torch/csrc/circulant_multi.cu",
                   "sca_ldpc_tpu/ops/circulant_bp.py:126", launches, k8_err, *main)]


def _instance_phase(dev, tag, sets):
    """Phase 18: K8 with per-instance shifts on batched rounds; returns its
    largest absolute difference from plain."""
    from sca_ldpc_tpu_torch.ops.kernels import circulant_cuda, multi_circulant_bp_cuda, multi_circulant_bp_plain
    from sca_ldpc_tpu_torch.ops.kernels.bounds import multi_circulant_bound_ms
    from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
        multi_circulant_launch,
        multi_circulant_occupancy,
        multi_circulant_stage,
    )
    from sca_ldpc_tpu_torch.tools.attack_cells import ITERATIONS, N as N128, instance_cell, masked_cell, pick

    w, err = W, 0
    rounds = (("the last 4 decodes", pick(sets, "last", 4), (1, 3, 8, 2)),
              ("the first 8 and last 8 decodes", pick(sets, "first", 8) + pick(sets, "last", 8),
               (1, 2, 3, 4, 5, 6, 7, 8) * 2))
    for label, round_sets, ps in rounds:
        t0 = time.perf_counter()
        args = instance_cell(round_sets, ps, dev)
        i_n, p_pad = args[2].shape[0], args[2].shape[1]
        build_s = time.perf_counter() - t0
        out_k = multi_circulant_bp_cuda(*args, ITERATIONS)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out_p = multi_circulant_bp_plain(*args, ITERATIONS)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        solo = [multi_circulant_bp_cuda(*(x[f:f + 1] for x in args[:3]), args[3][f], ITERATIONS) for f in range(i_n)]
        solo = tuple(torch.cat(parts) for parts in zip(*solo))
        torch.cuda.synchronize()
        same_p = [bool(torch.equal(a, b)) for a, b in zip(out_k, out_p)]
        same_s = [bool(torch.equal(a, b)) for a, b in zip(out_k, solo)]
        err = max(err, int((out_k[0] - out_p[0]).abs().max()), int((out_k[1] - out_p[1]).abs().max()))
        ms_one = _ms(lambda: multi_circulant_bp_cuda(*args, ITERATIONS))
        ms_each = _ms(lambda: [multi_circulant_bp_cuda(*(x[f:f + 1] for x in args[:3]), args[3][f], ITERATIONS)
                               for f in range(i_n)])
        # the same launch with the shifts staged a tile at a time (stage 2 forced), in turns 1, 2, 2, 1
        chosen = circulant_cuda.multi_circulant_stage
        circulant_cuda.multi_circulant_stage = lambda b, p, w, per_frame: 2 if per_frame else 0
        try:
            out_2 = multi_circulant_bp_cuda(*args, ITERATIONS)
            ms_tile = [_ms(lambda: multi_circulant_bp_cuda(*args, ITERATIONS)) for _turn in range(2)]
        finally:
            circulant_cuda.multi_circulant_stage = chosen
        ms_whole = [ms_one, _ms(lambda: multi_circulant_bp_cuda(*args, ITERATIONS))]
        torch.cuda.synchronize()
        same_2 = [bool(torch.equal(a, b)) for a, b in zip(out_k, out_2)]
        e_c, e_i, conv, it = out_k
        nbytes = _nbytes(*args, e_c.to(torch.uint8), e_i.to(torch.uint8), conv, it)
        bound = multi_circulant_bound_ms(int(it.sum()), p_pad, w, N128, nbytes)
        stage = multi_circulant_stage(i_n, p_pad, w, True)
        occ = multi_circulant_occupancy(w, "product_sum", p_pad, dev, i_n, stage)
        cfg = multi_circulant_launch(i_n, p_pad, N128, occ["blocks_per_sm"], occ["sms"])
        print(f"phase 18 K8 per-instance shifts, {label}: I={i_n}, P={list(ps)} padded to {p_pad} (stage {stage}: "
              f"{i_n * p_pad * w} shifts staged), built in {build_s:.1f} s; converged {int(conv.sum())}/{i_n}, "
              f"iterations {it.tolist()}; equal to plain (e_c, e_i, conv, iters) {same_p}, to {i_n} [P, W] "
              f"launches {same_s}; one [I, P, W] launch {ms_one:.3f} ms against {i_n} batch-1 launches "
              f"{ms_each:.3f} ms ({ms_each / ms_one:.2f}x), plain {plain_ms:.1f} ms; grid {cfg.grid} blocks, "
              f"{occ['blocks_per_sm']} an SM; bound {bound[0]:.4f} ms ({bound[1]}), K8 at "
              f"{100 * bound[0] / ms_one:.2f}% {tag}")
        print(f"phase 18 K8 staging, {label}: shifts staged whole (stage 1) {ms_whole[0]:.3f} / {ms_whole[1]:.3f} ms, "
              f"a tile at a time (stage 2, forced) {ms_tile[0]:.3f} / {ms_tile[1]:.3f} ms (turns 1, 2, 2, 1); stage 2 "
              f"equal to stage 1 {same_2} {tag}")
        if not all(same_p) or not all(same_s) or not all(same_2):
            raise SystemExit(f"K8 per-instance shifts ({label}): differs from plain, from the [P, W] launches or "
                             "between the stagings")
    args = masked_cell(pick(sets, "last", 16), 3, dev)
    shared = multi_circulant_bp_cuda(*args, ITERATIONS)
    rows = multi_circulant_bp_cuda(*args[:3], args[3].expand(16, -1, -1).contiguous(), ITERATIONS)
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, b)) for a, b in zip(shared, rows)]
    print(f"phase 18 K8 [B, P, W] with equal rows against the [P, W] launch (2850 rows, P=3, batch 16): bit-equal "
          f"{equal}")
    if not all(equal):
        raise SystemExit("K8: [B, P, W] shifts with equal rows differ from the [P, W] launch")
    return err


def _batched_phase(dev, tag):
    """Phase 19: the batched attack through the public API; returns K8's launches."""
    from sca_ldpc_tpu_torch.models.hqc import batched, simulate_hqc_attacks_batched, simulate_hqc_idealized_oracle
    from sca_ldpc_tpu_torch.ops.kernels import circulant_cuda, multi_circulant_bp_cuda
    from sca_ldpc_tpu_torch.tools.attack_cells import ATTACK, fixture_keys
    from sca_ldpc_tpu_torch.utils import make_random_state

    seeds = [0, 1, 2, 3]
    kw = {k: v for k, v in ATTACK.items() if k not in ("keyfile", "error_rate", "param_set")}
    with fixture_keys() as keypair:
        executor = batched.BatchedCirculantDecodeExecutor(len(seeds), device=dev)
        lib = circulant_cuda._multi_lib
        timed = _TimedLib(lib())
        circulant_cuda._multi_lib = lambda: timed
        torch.cuda.synchronize()
        multi_circulant_bp_cuda.launches = 0
        t0 = time.perf_counter()
        try:
            results, rounds = simulate_hqc_attacks_batched(seeds, decode_backend="circulant", executor=executor,
                                                           device=dev, **kw)
            torch.cuda.synchronize()
        finally:
            circulant_cuda._multi_lib = lib
        wall = time.perf_counter() - t0
        launches = multi_circulant_bp_cuda.launches
        k8_s = sum(start.elapsed_time(end) for start, end in timed.events) / 1e3
        solo_s, same = 0.0, []
        for seed, (ok, tracking) in zip(seeds, results):
            t0 = time.perf_counter()
            solo_ok, solo = simulate_hqc_idealized_oracle(make_random_state(seed), keypair=keypair,
                                                          decode_backend="circulant", device=dev, **kw)
            solo_s += time.perf_counter() - t0
            successes = [[d["success"] for d in t.decoder_stats] for t in (tracking, solo)]
            same.append(ok and solo_ok and tracking.num_oracle_calls == solo.num_oracle_calls
                        and successes[0] == successes[1])
    print(f"phase 19 simulate_hqc_attacks_batched seeds {seeds} (circulant, fixture key): recovered "
          f"{[ok for ok, _t in results]}, oracle calls {[t.num_oracle_calls for _ok, t in results]}, decodes "
          f"{[len(t.decoder_stats) for _ok, t in results]}, {rounds} rounds, K8 launches {launches}; "
          f"wall {wall:.2f} s, "
          f"{executor.seconds:.2f} s in the rounds, K8's device time {k8_s:.4f} s; each equal to its solo run "
          f"(success sequence, oracle calls) {same}, the 4 solo runs {solo_s:.2f} s {tag}")
    if not all(same):
        raise SystemExit("the batched attack: an instance did not recover the key or differs from its solo run")
    if launches != rounds:
        raise SystemExit(f"K8 launched {launches} times for {rounds} batched rounds")
    return launches


def _timing_phase(dev, tag):
    """Phase 20: the timing oracle; returns K8's launches in its attack."""
    import tempfile

    from sca_ldpc_tpu_torch.models.hqc import Hqc128, simulate_hqc_idealized_oracle
    from sca_ldpc_tpu_torch.models.hqc.eval_oracle import hqc_eval_oracle
    from sca_ldpc_tpu_torch.ops.kernels import multi_circulant_bp_cuda
    from sca_ldpc_tpu_torch.tools.attack_cells import ATTACK, ModelledClock
    from sca_ldpc_tpu_torch.utils import make_random_state

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        acc = hqc_eval_oracle(make_random_state(3), keyfile=ATTACK["keyfile"], num_trials=3, max_log2_measurements=2,
                              profile_measurements=2**6, state_file=f"{tmp}/state.json")
        print(f"phase 20 hqc_eval_oracle at tiny counts (3 trials, 1-2 measurements, profile 2^6): accuracy {acc} "
              f"in {time.perf_counter() - t0:.2f} s (mechanics only, no accuracy claimed)")
    # The attack against the timing channel, run to key recovery: calibration and its guard, TimingChannel's
    # differential decisions and recalibration, the Bayesian amplification with CERTAINTY_CAP, the decodes through
    # K8. The cycle counter is modelled (ModelledClock, seeded), so the run is the same on every host; the host's
    # own counter is measured by tools/timing_calibration.py.
    settings = dict(timing_measure=64, timing_profile_measurements=2**13, timing_calibration_trials=100)
    kw = dict(ATTACK, max_oracle_calls=None)
    torch.cuda.synchronize()
    multi_circulant_bp_cuda.launches = 0
    t0 = time.perf_counter()
    with ModelledClock(Hqc128, seed=0) as clock:
        ok, tracking = simulate_hqc_idealized_oracle(make_random_state(0), oracle_backend="timing",
                                                     decode_backend="circulant", device=dev, **settings, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = multi_circulant_bp_cuda.launches
    ch, cal = tracking.timing_channel, tracking.timing_calibration
    print(f"phase 20 timing-oracle attack (seed 0, fixture key, circulant, measure 64, profile 2^13, 100 calibration "
          f"trials; modelled cycle counter, seed 0, cost {clock.cost} cycles an expansion, noise sigma "
          f"{clock.sigma:.0f} + exponential {clock.tail:.0f}): profiled gap {ch.gap:.0f} cycles, margin {ch.margin:.0f}, calibrated "
          f"acc_fail {cal['acc_fail']:.3f} acc_success {cal['acc_success']:.3f}; {tracking.num_oracle_calls} "
          f"decisions, {ch.num_decaps} decapsulations a channel decision counts ({clock.decapsulations} modelled in "
          f"all), live accuracy (fail, success) {ch.empirical_accuracy()}, {ch.num_recals} recalibrations; "
          f"{len(tracking.decoder_stats)} decodes ({launches} K8 launches, {tracking.decode_seconds:.2f} s), "
          f"recovered {ok}; {wall:.1f} s {tag}")
    if not ok:
        raise SystemExit("the timing-oracle attack did not recover the key")
    if not tracking.decoder_stats or launches != len(tracking.decoder_stats):
        raise SystemExit(f"the timing attack ran {len(tracking.decoder_stats)} decodes and {launches} K8 launches")
    return launches


def _fer_phase(dev, tag):
    """Phase 21: binary FER simulation on the card against the port's CPU run,
    at rate 0.02 (the reference's default operating point; the frames/s) and
    at 0.07, where the FER is near 0.25 and 3 sigma catches a change in the
    decoder's behaviour."""
    from sca_ldpc_tpu_torch.channels import ErrorsProvider
    from sca_ldpc_tpu_torch.codes import make_regular_ldpc_parity_check_matrix
    from sca_ldpc_tpu_torch.sim import simulate_frame_error_rate
    from sca_ldpc_tpu_torch.utils import make_random_state

    H = make_regular_ldpc_parity_check_matrix(300, 150, 3, 6, make_random_state(0))
    for rate, runs in ((0.02, {"cuda": 20480, "cpu": 4096}), (0.07, {"cuda": 20480, "cpu": 2048})):
        ok, secs = {}, {}
        for device in ("cuda", "cpu"):
            rng = make_random_state(1)
            if device == "cuda":
                simulate_frame_error_rate(H, ErrorsProvider(rate, None, rng), 1024, rng, device=dev)  # warm-up
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok[device] = simulate_frame_error_rate(H, ErrorsProvider(rate, None, rng), runs[device], rng,
                                                   device=dev if device == "cuda" else "cpu")
            secs[device] = time.perf_counter() - t0
        fer = {d: 1 - ok[d] / runs[d] for d in ok}
        pooled = max((ok["cuda"] + ok["cpu"]) / (runs["cuda"] + runs["cpu"]), 1 / runs["cpu"])
        pooled = min(pooled, 1 - 1 / runs["cpu"])
        sigma = np.sqrt(pooled * (1 - pooled) * (1 / runs["cuda"] + 1 / runs["cpu"]))
        print(f"phase 21 simulate_frame_error_rate (3, 6)-regular n=300 code, rate {rate}, max_iter n, batch 1024: "
              f"card {runs['cuda']} frames FER {fer['cuda']:.5f} at {runs['cuda'] / secs['cuda']:.1f} frames/s; CPU "
              f"{runs['cpu']} frames FER {fer['cpu']:.5f} ({runs['cpu'] / secs['cpu']:.1f} frames/s); difference "
              f"{abs(fer['cuda'] - fer['cpu']):.5f}, 3 sigma {3 * sigma:.5f} {tag}")
        if abs(fer["cuda"] - fer["cpu"]) > 3 * sigma:
            raise SystemExit(f"binary FER at rate {rate} on the card differs from the CPU run by more than 3 "
                             "binomial sigma")


if __name__ == "__main__":
    sys.exit(main())
