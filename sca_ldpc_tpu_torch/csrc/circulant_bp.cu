// Syndrome belief propagation on H = [circulant(N, w) | I_N], one frame per
// thread block, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in sca_ldpc_tpu/ops/kernels/circulant_pallas.py:
//   circulant_bp_pallas  (body _make_kernel)      -> circulant_bp_decode()
//   circulant_fer_pallas (body _make_fer_kernel)  -> circulant_fer_step()
// and computes exactly what the JAX package's ops/circulant_bp.py
// _circulant_bp computes: product-sum or normalized min-sum (alpha 0.75),
// messages clipped at +-60 after the first iteration, each frame's first
// converged estimate kept, and per-frame early exit.  The decode API also
// takes H = circulant(N, w) alone (with_identity = 0: no identity plane and
// no identity parity term; decisions [B, N]), as the JAX decoder does.
//
// State.  One frame's f32 check-to-variable messages are w planes of N
// (1.4 MB at HQC-128), far above the 227 KB of shared memory a block has, so
// they stay in device memory:
//   c2v [B, w, ld] f32, ld = N rounded up to a multiple of 32 floats;
// the variable totals (prior + sum of incoming c2v, 4N bytes: 70,676 B at
// HQC-128, 143,404 B at HQC-192, 230,548 B at HQC-256) live in the block's
// dynamic shared memory for the whole decode, after the shifts.  An N whose
// totals do not fit (N > 58,080 at w <= 32) takes the second placement of the
// same template, tot [B, N] f32 in device memory; the host picks the
// placement from N and the device's shared-memory limits
// (ops/kernels/circulant_cuda.py circulant_launch).
// v2c is never stored: v2c[t][i] = clip(tot[(i - k_t) mod N] - c2v[t][i]),
// the identity behind circulant_pallas.py:152-157; the first iteration reads
// the unclipped prior, which is what tot holds then.
//
// Per iteration a block makes three sweeps with __syncthreads() between them:
//   check sweep    over checks i: rebuild the w+1 incoming messages (plane t
//                  from variable (i - k_t) mod N, the identity plane from its
//                  prior), write each extrinsic c2v[t][i] in place, and the
//                  identity variable's decision;
//   variable sweep over variables j: tot[j] = prior + sum_t c2v[t][(j + k_t) mod N],
//                  in plane order and without atomics, so the same inputs give
//                  bit-identical outputs on every launch;
//   syndrome sweep the syndrome of the decisions (signs of tot, identity
//                  decisions) against the input syndrome, reduced with
//                  __syncthreads_or.
// The circulant half of the decisions is read from tot once, at the end.
//
// What bounds it on the H100: device-memory latency in the phi chain.  Per
// message (check, plane) and iteration the product-sum decode evaluates phi =
// -log(tanh(x/2)) twice: 4 transcendentals on the SFU (16 a clock per SM);
// precise logf/tanhf (no fast-math: it changes phi near its ends) cost some
// 40 FP32 instructions per phi.  The c2v planes cost 12 B of device-memory
// traffic per message (check sweep read and write, variable sweep read):
// 1.42 MB of planes a frame at HQC-128, 374 MB for the 264 frames resident at
// once, far beyond the 50 MB L2, so about 52 MB a frame over its ~12.6
// iterations.  At the 25,916 frames/s the form before staging reached on an
// HQC-128 FER sweep that is 1.35 TB/s, 40% of the card's 3.35 TB/s, with the
// SFU bound at 10.7% and instruction issue (~100 FP32 instructions a message)
// about 30% used: no bound binds.  The check sweep held one check a thread and
// loaded its w magnitudes c2v[t * ld + i] one at a time (the t < w guard below
// keeps the compiler from hoisting them and spilling), so each phi waited out
// a device-memory round trip: one 4-byte load in flight per thread, ~4 KB an
// SM, where Little's law asks for ~20 KB to run near 3.35 TB/s.  The design:
//   1. tot in shared memory: the 2w gathers of tot per check and iteration
//      (check and syndrome sweeps) and the write of the variable sweep are
//      shared-memory accesses.
//   2. 32 resident warps per SM: __launch_bounds__(1024, 1) holds a thread
//      to 64 registers, so one block of 1024 threads (HQC-192/256) or two of
//      512 (HQC-128, 2 x 70.8 KB of shared memory) fill an SM.  The check
//      sweep keeps one check's w incoming magnitudes in registers, in a
//      fully unrolled loop over an array of MAXW: instances of exactly
//      MAXW = 20 and 30 (the HQC weights) and buckets of 8, 16, 32 and 64
//      for the rest.  Each step of the loop is guarded by t < w at run time,
//      which also keeps the compiler from hoisting all w loads ahead of the
//      phi chain (with w known at compile time it did, and spilled).  A
//      message's sign rides in its float's sign bit, so no sign mask is
//      kept.
//   3. Line-aligned planes: the stride ld makes every plane row start on a
//      128-byte line, so a warp's check-sweep load or store of a plane is one
//      aligned line (4 sectors; an odd N gave 5).
//   4. Loop-invariant work hoisted: in the FER step every prior is one
//      constant, so phi(|p_i|) is computed once per frame, and so is the
//      first iteration's extrinsic magnitude (every incoming message is the
//      prior then): that check sweep only writes signs, by the same
//      arithmetic as the general sweep, so the results are bit for bit the
//      same.
//   5. Staged planes (STAGED, shared placement only).  Where shared memory
//      has room beside tot, the first stage_warps warps (the slotted ones,
//      at least half the block) each own a slot of w rows of 32 floats and
//      an mbarrier, and the check sweeps run on them alone.  A warp takes
//      tiles of 32 checks from a counter in shared memory; a tile's w plane
//      rows c2v[t][32 tile .. + 32) are 128-byte lines, each one bulk copy
//      (cp.async.bulk, completion on the warp's mbarrier, armed by lane 0;
//      lane l copies rows l, l + 32, ...): the copies hold no registers.  A
//      lane reads its check's w messages from its slot column and writes
//      their signed phi (or magnitude) back in place, so the second phi loop
//      reads them there and no register array holds them: the 64 registers
//      keep no spill with the copies' bookkeeping.  The warp takes its next
//      tile and copies it once its lanes have read the slot; while its copy
//      flies the SM runs the other warps (a refill four rows at a time
//      during the second loop measured slower: its warp syncs cost more than
//      the wait they hid).  The last tile's lanes past N take check N - 1 and
//      store nothing, so the warp stays whole for its copies and waits.  In
//      the variable sweep a slotted warp's lane copies its variable's w
//      values c2v[t][(j + k_t) mod N] into its own slot column with 4-byte
//      cp.async, all in flight at once, and sums them in plane order: a
//      bulk copy needs a 16-byte aligned source, so it would take the
//      enclosing aligned span, up to 40 floats a row with the wrap, more
//      than the slot's 32.  The other warps take variable tiles from a
//      second counter and read device memory.  The staged instances of the
//      exact buckets (MAXW = 20, 30) take w from MAXW, so every loop over the
//      planes has a known trip count: with the messages in shared memory,
//      the unguarded unrolled loops no longer spill.  Ordering: every thread
//      fences its c2v stores and its slot accesses to the async proxy
//      (fence.proxy.async) before the __syncthreads() that ends its check
//      or variable sweep, and a slotted warp fences again after the barrier,
//      before its first copy; every copy a sweep issues is waited for in
//      that sweep, so no copy is in flight at a barrier or when the block
//      leaves (converged or not).  The host picks the form from N, w, the
//      placement and the device's shared-memory limits (circulant_launch):
//      HQC-128 (all 16 warps at w = 20) and HQC-192 (all 32 at w = 20, 23 at
//      w = 30) staged; HQC-256 (1,772 B left beside its totals) and the
//      device placement not.  A check's or a variable's arithmetic and its
//      order are those of the unstaged form, whichever warp computes it, so
//      the results are bit for bit the same.  Staged, a later iteration of
//      4096 HQC-128 frames took 9.2-9.3 ms on an H100 at 700 W, against
//      12.9 ms unstaged: its ~130 instructions a message (two phi of ~40)
//      issue for some 5.6 ms of it, and its 17.4 GB of planes need 5.2 ms at
//      3.35 TB/s, so instruction issue and bandwidth bound it together now.

#include <cmath>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 60.0f;
constexpr float kMinSumAlpha = 0.75f;
constexpr int kMaxW = 64;
constexpr int kMaxThreads = 1024;
constexpr int kMinBlocks = 1;  // 65,536 registers / (1024 x 1) = 64 registers a thread
constexpr int kBuckets = 6;
constexpr int kForms = 3;                  // tot in device memory, tot in shared memory, and staged planes
constexpr int kRowBytes = 32 * 4;          // a staged plane row: one warp's 32 checks

__host__ __device__ __forceinline__ int pad32(int x) { return (x + 31) & ~31; }

// Bytes of dynamic shared memory of the staged form: the shifts and tot (up
// to a 16-byte line), then a slot of w plane rows and an mbarrier for each of
// `warps` warps, then the two tile counters.
__host__ __device__ __forceinline__ long long staged_smem_bytes(int w, int n, int warps) {
  return 16LL * ((pad32(w) + n + 3) / 4) + static_cast<long long>(warps) * (w * kRowBytes + 8) + 8;
}

__device__ __forceinline__ float phi(float x) {
  x = fminf(fmaxf(x, 1e-9f), kBig);
  return -logf(tanhf(0.5f * x));
}

// |x| with the sign bit set when neg: a message magnitude and its sign in one
// register (phi may return -0.0f, hence the fabsf).
__device__ __forceinline__ float with_sign(float x, bool neg) {
  return __int_as_float(__float_as_int(fabsf(x)) | (neg ? static_cast<int>(0x80000000u) : 0));
}

__device__ __forceinline__ int sign_bit(float x) { return static_cast<int>(__float_as_uint(x) >> 31); }

struct Args {
  const float* prior_c;  // [B, N], or nullptr: every prior is prior_const (FER step)
  const float* prior_i;  // [B, N], or nullptr: likewise
  float prior_const;
  const uint8_t* errors;  // [B, 2N] true errors (FER step) or nullptr
  uint8_t* syn;           // [B, N] syndrome (formed here in the FER step)
  const int* shifts;      // [w] in [0, N)
  int w, n, ld, max_iter, with_id;
  float* c2v;        // [B, w, ld]
  float* tot;        // [B, N] in the device placement; not read in the shared one
  uint8_t* dec_c;    // circulant decisions, row stride e_stride (decode API), or nullptr
  uint8_t* dec_i;    // identity decisions, row stride e_stride (nullptr without the identity)
  int e_stride;
  uint8_t* conv_out;
  uint8_t* ok_out;   // FER step: decisions equal the errors; else nullptr
  int* iters_out;    // or nullptr
  int stage_warps;   // the staged form: warps 0 .. stage_warps - 1 have a slot; else 0
};

// ---- the staged form's copies and their ordering (sm_90)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The whole warp: the w plane rows of one tile, src[t * ld .. + 32) for t <
// w, into the slot's rows, a 128-byte bulk copy each, completing a phase of
// bar.  Lane 0 arms bar with their bytes (its arrival), then lane l copies
// rows l, l + 32, ...  The __syncwarp() also orders every lane's reads of
// the slot before the copies that overwrite it.
__device__ __forceinline__ void copy_tile(float* slot, uint64_t* bar, const float* src, int ld, int w, int lane) {
  const uint32_t b = smem_u32(bar);
  if (lane == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(w * kRowBytes) : "memory");
  }
  __syncwarp();
  for (int t = lane; t < w; t += 32) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(smem_u32(slot + t * 32)), "l"(src + static_cast<size_t>(t) * ld), "r"(kRowBytes), "r"(b)
                 : "memory");
  }
}

// Wait until the phase of bar with this parity completes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(b), "r"(parity)
                 : "memory");
  } while (!done);
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy4_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Orders this thread's generic accesses before, and the async proxy's (the
// bulk copies) after, in both memories.
__device__ __forceinline__ void fence_async() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

// The next warp tile from a block's counter, the same to every lane.
__device__ __forceinline__ int next_tile(int* counter, int lane) {
  int t = 0;
  if (lane == 0) t = atomicAdd(counter, 1);
  return __shfl_sync(0xffffffffu, t, 0);
}

// MAXW: compile-time bound on w, so one check's incoming messages live in
// registers.  MIN_SUM: normalized min-sum, else product-sum.  TOT_SMEM: tot
// in shared memory, else in device memory.  STAGED (with TOT_SMEM only): the
// c2v planes reach the later check sweeps and the variable sweeps through
// the warps' slots in shared memory (design point 5).
template <int MAXW, bool MIN_SUM, bool TOT_SMEM, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) circulant_bp_kernel(const Args a) {
  static_assert(TOT_SMEM || !STAGED, "the staged form keeps tot in shared memory");
  // k_s [pad32(MAXW)] (= pad32(w) for every w of the bucket), then tot [N]
  // in the shared placement; staged, from the next 16-byte line, a slot
  // [w][32] f32 for each of the first stage_warps warps, their mbarriers,
  // and the check and variable sweeps' tile counters
  extern __shared__ __align__(16) int smem[];
  int* k_s = smem;
  // w = 20 and 30 have instances of exactly that MAXW; the staged ones take w
  // from it, so that every loop over the planes has a known trip count (the
  // staged check sweep's first loop is unrolled whole at w = 20, by 10
  // elsewhere: whole at w = 30 it spilled)
  const int w = STAGED && (MAXW == 20 || MAXW == 30) ? MAXW : a.w;
  constexpr int kCheckUnroll = MAXW == 20 ? 20 : 10;
  const int n = a.n;
  const int ld = a.ld;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const size_t fn = static_cast<size_t>(b) * n;
  float* tot;
  if constexpr (TOT_SMEM) {
    tot = reinterpret_cast<float*>(smem + pad32(MAXW));
  } else {
    tot = a.tot + fn;
  }
  float* c2v = a.c2v + static_cast<size_t>(b) * w * ld;
  uint8_t* syn = a.syn + fn;
  const float* pc = a.prior_c ? a.prior_c + fn : nullptr;
  const float* pi = a.prior_i ? a.prior_i + fn : nullptr;
  const uint8_t* err = a.errors ? a.errors + 2 * fn : nullptr;
  uint8_t* dec_i = a.dec_i ? a.dec_i + static_cast<size_t>(b) * a.e_stride : nullptr;
  const bool with_id = a.with_id != 0;
  // the staged form: this warp's slot and mbarrier (slotted warps), the
  // parity of the next phase of the mbarrier to wait for, the tile counters
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles = (n + 31) >> 5;
  const bool slotted = STAGED && warp < a.stage_warps;
  float* slot = nullptr;
  uint64_t* bar = nullptr;
  int* counters = nullptr;
  uint32_t phase = 0;
  if constexpr (STAGED) {
    float* stage = reinterpret_cast<float*>(smem) + ((pad32(MAXW) + n + 3) & ~3);
    uint64_t* bars = reinterpret_cast<uint64_t*>(stage + a.stage_warps * w * 32);
    counters = reinterpret_cast<int*>(bars + a.stage_warps);
    slot = stage + warp * w * 32;
    bar = bars + warp;
    if (slotted && lane == 0) mbar_init(bar);
    if (tid == 0) counters[0] = counters[1] = 0;
  }
  for (int t = tid; t < w; t += nt) k_s[t] = a.shifts[t];
  __syncthreads();

  // Set-up: the FER step forms the syndrome of the true errors; tot starts
  // as the prior, and the identity decisions as its hard decisions.
  for (int i = tid; i < n; i += nt) {
    if (err) {
      int s = err[n + i];
      for (int t = 0; t < w; ++t) {
        int j = i - k_s[t];
        j += (j < 0) ? n : 0;
        s += err[j];
      }
      syn[i] = static_cast<uint8_t>(s & 1);
    }
    tot[i] = pc ? pc[i] : a.prior_const;
    if (with_id) dec_i[i] = (pi ? pi[i] : a.prior_const) < 0.0f;
  }
  // one constant prior (the FER step): the identity plane's message magnitude
  const bool uniform = pc == nullptr;
  const float m_i_const = MIN_SUM ? fabsf(a.prior_const) : phi(fabsf(a.prior_const));
  __syncthreads();

  int it = 0;
  bool conv = false;
  while (it < a.max_iter && !conv) {
    const bool first = (it == 0);

    // ---- check sweep
    if (first && uniform) {
      // Every incoming message is the prior: the extrinsic magnitude as the
      // general sweep forms it from w + 1 equal messages, its sign the
      // syndrome bit, flipped when an odd number of negative circulant
      // messages reach the check.  (Formed here, not live in later sweeps.)
      float first_ext;
      if constexpr (MIN_SUM) {
        first_ext = kMinSumAlpha * fminf(fabsf(a.prior_const), kBig);  // min1, counted w + 1 > 1 times
      } else {
        float acc = 0.0f;
        for (int t = 0; t < w; ++t) acc += m_i_const;
        acc += m_i_const;
        first_ext = phi(fmaxf(acc - fabsf(m_i_const), 1e-9f));
      }
      const int first_flip = (a.prior_const < 0.0f) & w;
      for (int i = tid; i < n; i += nt) {
        const float ext = ((syn[i] ^ first_flip) & 1) ? -first_ext : first_ext;
        for (int t = 0; t < w; ++t) c2v[static_cast<size_t>(t) * ld + i] = ext;
        dec_i[i] = a.prior_const + ext < 0.0f;
      }
    } else if (STAGED) {
      // Warp tiles of 32 checks from the counter, taken by the slotted warps
      // alone (the others wait at the barrier).  After the first iteration a
      // tile's w plane rows arrive in the warp's slot, copied while the warp
      // finished its last tile; each lane reads its check's messages there
      // and writes their phi (or magnitude), signed, back in place, so no
      // register holds them between the two loops.  Lanes past N take check
      // N - 1 and store nothing, so the warp stays whole for its copies.
      if (tid == 0) counters[1] = 0;  // the variable sweep's, for after the barrier
      if (slotted) {
        float* slot_l = slot + lane;
        fence_async();  // the last check sweep's stores and the slot's accesses, before the copies
        int tile = next_tile(counters, lane);
        if (!first && tile < tiles) copy_tile(slot, bar, c2v + tile * 32, ld, w, lane);
        while (tile < tiles) {
          const int i = min(tile * 32 + lane, n - 1);
          const bool own = tile * 32 + lane < n;
          if (!first) mbar_wait(bar, phase);
          float* c2v_i = c2v + i;
          const float p_i = with_id ? (pi ? pi[i] : a.prior_const) : 0.0f;
          const bool neg_i = p_i < 0.0f;
          int parity = syn[i] ^ static_cast<int>(neg_i);
          float acc = 0.0f, min1 = INFINITY, min2 = INFINITY;
          int cnt = 0;
#pragma unroll kCheckUnroll
          for (int t = 0; t < w; ++t) {
            int j = i - k_s[t];
            j += (j < 0) ? n : 0;
            const float v = first ? tot[j] : fminf(fmaxf(tot[j] - slot_l[t * 32], -kBig), kBig);
            const bool ng = v < 0.0f;
            parity ^= static_cast<int>(ng);
            const float mag = fabsf(v);
            if constexpr (MIN_SUM) {
              if (mag < min1) {
                min2 = min1;
                min1 = mag;
                cnt = 1;
              } else if (mag == min1) {
                ++cnt;
              } else {
                min2 = fminf(min2, mag);
              }
              slot_l[t * 32] = with_sign(mag, ng);
            } else {
              const float pm = phi(mag);
              acc += pm;
              slot_l[t * 32] = with_sign(pm, ng);
            }
          }
          phase ^= static_cast<uint32_t>(!first);
          // the identity plane (degree-1 variable: always its prior)
          float m_i = 0.0f;
          if (with_id) {
            m_i = pi ? (MIN_SUM ? fabsf(p_i) : phi(fabsf(p_i))) : m_i_const;
            if constexpr (MIN_SUM) {
              if (m_i < min1) {
                min2 = min1;
                min1 = m_i;
                cnt = 1;
              } else if (m_i == min1) {
                ++cnt;
              } else {
                min2 = fminf(min2, m_i);
              }
            } else {
              acc += m_i;
            }
          }
#pragma unroll
          for (int t = 0; t < MAXW; ++t) {
            if (t < w) {
              const float ms = slot_l[t * 32];
              const float mt = fabsf(ms);
              float ext;
              if constexpr (MIN_SUM) {
                ext = (mt == min1 && cnt == 1) ? min2 : min1;
                ext = kMinSumAlpha * fminf(ext, kBig);
              } else {
                ext = phi(fmaxf(acc - mt, 1e-9f));
              }
              if (own) c2v_i[static_cast<size_t>(t) * ld] = (parity ^ sign_bit(ms)) ? -ext : ext;
            }
          }
          if (with_id && own) {
            float ext_i;
            if constexpr (MIN_SUM) {
              ext_i = (m_i == min1 && cnt == 1) ? min2 : min1;
              ext_i = kMinSumAlpha * fminf(ext_i, kBig);
            } else {
              ext_i = phi(fmaxf(acc - m_i, 1e-9f));
            }
            const float tot_i = p_i + ((parity ^ static_cast<int>(neg_i)) ? -ext_i : ext_i);
            dec_i[i] = tot_i < 0.0f;
          }
          tile = next_tile(counters, lane);
          if (!first && tile < tiles) copy_tile(slot, bar, c2v + tile * 32, ld, w, lane);
        }
      }
    } else {
      for (int i = tid; i < n; i += nt) {
        float m[MAXW];  // signed phi(|v2c|) (product-sum) or signed |v2c| (min-sum)
        const float p_i = with_id ? (pi ? pi[i] : a.prior_const) : 0.0f;
        const bool neg_i = p_i < 0.0f;
        int parity = syn[i] ^ static_cast<int>(neg_i);
        float acc = 0.0f, min1 = INFINITY, min2 = INFINITY;
        int cnt = 0;
        float* c2v_i = c2v + i;
#pragma unroll
        for (int t = 0; t < MAXW; ++t) {
          if (t < w) {
            int j = i - k_s[t];
            j += (j < 0) ? n : 0;
            const float v = first ? tot[j]
                                  : fminf(fmaxf(tot[j] - c2v_i[static_cast<size_t>(t) * ld], -kBig), kBig);
            const bool ng = v < 0.0f;
            parity ^= static_cast<int>(ng);
            const float mag = fabsf(v);
            if constexpr (MIN_SUM) {
              if (mag < min1) {
                min2 = min1;
                min1 = mag;
                cnt = 1;
              } else if (mag == min1) {
                ++cnt;
              } else {
                min2 = fminf(min2, mag);
              }
              m[t] = with_sign(mag, ng);
            } else {
              const float pm = phi(mag);
              acc += pm;
              m[t] = with_sign(pm, ng);
            }
          }
        }
        // the identity plane (degree-1 variable: always its prior)
        float m_i = 0.0f;
        if (with_id) {
          m_i = pi ? (MIN_SUM ? fabsf(p_i) : phi(fabsf(p_i))) : m_i_const;
          if constexpr (MIN_SUM) {
            if (m_i < min1) {
              min2 = min1;
              min1 = m_i;
              cnt = 1;
            } else if (m_i == min1) {
              ++cnt;
            } else {
              min2 = fminf(min2, m_i);
            }
          } else {
            acc += m_i;
          }
        }
#pragma unroll
        for (int t = 0; t < MAXW; ++t) {
          if (t < w) {
            const float mt = fabsf(m[t]);
            float ext;
            if constexpr (MIN_SUM) {
              ext = (mt == min1 && cnt == 1) ? min2 : min1;
              ext = kMinSumAlpha * fminf(ext, kBig);
            } else {
              ext = phi(fmaxf(acc - mt, 1e-9f));
            }
            c2v_i[static_cast<size_t>(t) * ld] = (parity ^ sign_bit(m[t])) ? -ext : ext;
          }
        }
        if (with_id) {
          float ext_i;
          if constexpr (MIN_SUM) {
            ext_i = (m_i == min1 && cnt == 1) ? min2 : min1;
            ext_i = kMinSumAlpha * fminf(ext_i, kBig);
          } else {
            ext_i = phi(fmaxf(acc - m_i, 1e-9f));
          }
          const float tot_i = p_i + ((parity ^ static_cast<int>(neg_i)) ? -ext_i : ext_i);
          dec_i[i] = tot_i < 0.0f;
        }
      }
    }
    if constexpr (STAGED) fence_async();
    __syncthreads();

    // ---- variable sweep (summation order as in the plain version)
    if constexpr (STAGED) {
      // Warp tiles of 32 variables from the counter.  A slotted warp's lane
      // copies its variable's w values into its own slot column, all in
      // flight at once (4-byte cp.async: the spans are not 16-byte aligned).
      if (tid == 0) counters[0] = 0;  // the check sweep's, for after the barrier
      for (int tile = next_tile(counters + 1, lane); tile < tiles; tile = next_tile(counters + 1, lane)) {
        const int j = tile * 32 + lane;
        if (j >= n) continue;
        float s = 0.0f;
        if (slotted) {
          for (int t = 0; t < w; ++t) {
            int i = j + k_s[t];
            i -= (i >= n) ? n : 0;
            copy4(slot + t * 32 + lane, c2v + static_cast<size_t>(t) * ld + i);
          }
          copy4_wait();
          for (int t = 0; t < w; ++t) s += slot[t * 32 + lane];
        } else {
          for (int t = 0; t < w; ++t) {
            int i = j + k_s[t];
            i -= (i >= n) ? n : 0;
            s += c2v[static_cast<size_t>(t) * ld + i];
          }
        }
        tot[j] = (pc ? pc[j] : a.prior_const) + s;
      }
      fence_async();
    } else {
      for (int j = tid; j < n; j += nt) {
        float s = 0.0f;
        for (int t = 0; t < w; ++t) {
          int i = j + k_s[t];
          i -= (i >= n) ? n : 0;
          s += c2v[static_cast<size_t>(t) * ld + i];
        }
        tot[j] = (pc ? pc[j] : a.prior_const) + s;
      }
    }
    __syncthreads();

    // ---- syndrome sweep: the decisions' syndrome against the input syndrome
    int bad = 0;
    for (int i = tid; i < n; i += nt) {
      int s = with_id ? dec_i[i] : 0;
      for (int t = 0; t < w; ++t) {
        int j = i - k_s[t];
        j += (j < 0) ? n : 0;
        s += tot[j] < 0.0f;
      }
      bad |= (s & 1) != syn[i];
    }
    conv = __syncthreads_or(bad) == 0;
    ++it;
  }

  if (tid == 0) {
    a.conv_out[b] = conv;
    if (a.iters_out) a.iters_out[b] = it;
  }
  if (a.dec_c) {
    uint8_t* dec_c = a.dec_c + static_cast<size_t>(b) * a.e_stride;
    for (int j = tid; j < n; j += nt) dec_c[j] = tot[j] < 0.0f;
  }
  if (a.ok_out) {  // FER step: success = decisions equal the true errors
    int bad = 0;
    for (int j = tid; j < n; j += nt) {
      bad |= static_cast<int>(tot[j] < 0.0f) != err[j];
      bad |= dec_i[j] != err[n + j];
    }
    bad = __syncthreads_or(bad);
    if (tid == 0) a.ok_out[b] = !bad;
  }
}

using Kernel = void (*)(Args);

#define CIRCULANT_BUCKETS(MS, SH, ST)                                                                        \
  circulant_bp_kernel<8, MS, SH, ST>, circulant_bp_kernel<16, MS, SH, ST>, circulant_bp_kernel<20, MS, SH, ST>, \
      circulant_bp_kernel<30, MS, SH, ST>, circulant_bp_kernel<32, MS, SH, ST>, circulant_bp_kernel<64, MS, SH, ST>

// Every instance, indexed [min_sum][form: device, shared, staged][bucket].
const Kernel kKernels[2 * kForms * kBuckets] = {
    CIRCULANT_BUCKETS(false, false, false), CIRCULANT_BUCKETS(false, true, false),
    CIRCULANT_BUCKETS(false, true, true),   CIRCULANT_BUCKETS(true, false, false),
    CIRCULANT_BUCKETS(true, true, false),   CIRCULANT_BUCKETS(true, true, true),
};

int bucket_of(int w) {
  if (w == 20) return 2;
  if (w == 30) return 3;
  if (w <= 8) return 0;
  if (w <= 16) return 1;
  if (w <= 32) return 4;
  return 5;
}

int instance_of(int w, bool min_sum, bool shared, bool staged) {
  const int form = staged ? 2 : static_cast<int>(shared);
  return (static_cast<int>(min_sum) * kForms + form) * kBuckets + bucket_of(w);
}

// Raise an instance's dynamic shared-memory cap to `bytes` (the host picks
// the size within the device's limits) when it is above the cap set so far
// on this device.  A cap is never lowered, so no launch is refused for a
// smaller one set in between.
cudaError_t opt_in(int idx, int bytes) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static int cap[kMaxDevices][2 * kForms * kBuckets];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (bytes <= cap[dev][idx]) return cudaSuccess;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kKernels[idx]),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) cap[dev][idx] = bytes;
  return e;
}

// The staged form takes the shared placement and at least half the warps slotted.
bool stage_warps_valid(bool shared, int threads, int stage_warps) {
  return stage_warps == 0 || (shared && stage_warps <= threads / 32 && 2 * stage_warps >= threads / 32);
}

int launch(const Args& a, int method, int batch, int threads, int smem_bytes, void* stream) {
  const bool shared = a.tot == nullptr;
  const bool staged = a.stage_warps != 0;
  const long long need = staged ? staged_smem_bytes(a.w, a.n, a.stage_warps)
                                : 4LL * (pad32(a.w) + (shared ? a.n : 0));
  if (a.w < 1 || a.w > kMaxW || a.n < 1 || batch < 0 || a.max_iter < 0 || (method != 0 && method != 1) ||
      a.ld < a.n || a.ld % 32 != 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      !stage_warps_valid(shared, threads, a.stage_warps) || static_cast<long long>(smem_bytes) < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const int idx = instance_of(a.w, method == 1, shared, staged);
  cudaError_t e = opt_in(idx, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {const_cast<Args*>(&a)};
  cudaLaunchKernel(reinterpret_cast<const void*>(kKernels[idx]), dim3(batch), dim3(threads), args,
                   static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Decode API (replaces circulant_bp_pallas).  method: 0 product-sum, 1 min-sum.
// prior_c, prior_i [B, N] f32 (prior_i not read without the identity);
// syndrome [B, N] 0/1; shifts [w] int32 in [0, N); with_identity 1 for
// [circulant | I], 0 for the circulant alone.  Launch: threads a block and
// smem_bytes of dynamic shared memory (at least 4 (pad32(w) + N) with tot in
// shared memory, 4 pad32(w) in device memory, staged_smem_bytes staged);
// stage_warps 0, or the staged form's slotted warps (shared placement, at
// least half the block's).  Scratch, no initialisation needed: c2v [B, w, ld] f32
// (ld >= N, a multiple of 32); tot [B, N] f32 for the device placement, or
// null for the shared one.  Out: e [B, 2N] 0/1 ([B, N] without the identity),
// conv [B], iters [B] (may be null).  Returns a cudaError_t.
extern "C" int circulant_bp_decode(const float* prior_c, const float* prior_i, uint8_t* syndrome,
                                   const int* shifts, int w, int n, int ld, int batch, int max_iter, int method,
                                   int with_identity, int threads, int smem_bytes, int stage_warps, float* c2v,
                                   float* tot, uint8_t* e_out, uint8_t* conv_out, int* iters_out, void* stream) {
  if (prior_c == nullptr || prior_i == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool id = with_identity != 0;
  const Args a{prior_c, prior_i, 0.0f, nullptr, syndrome, shifts, w, n, ld, max_iter, id ? 1 : 0, c2v, tot,
               e_out, id ? e_out + n : nullptr, id ? 2 * n : n, conv_out, nullptr, iters_out, stage_warps};
  return launch(a, method, batch, threads, smem_bytes, stream);
}

// FER step (replaces circulant_fer_pallas): errors [B, 2N] 0/1 in; the
// syndrome (scratch syn [B, N]) and the identity decisions (scratch e_i
// [B, N]) are formed on the card; out: ok [B] (decisions equal the errors)
// and conv [B], and iters [B] (may be null: each frame's iterations, as
// circulant_bp_decode gives them).  Launch and scratch as for
// circulant_bp_decode.
extern "C" int circulant_fer_step(const uint8_t* errors, float prior, const int* shifts, int w, int n, int ld,
                                  int batch, int max_iter, int method, int threads, int smem_bytes, int stage_warps,
                                  float* c2v, float* tot, uint8_t* syn, uint8_t* e_i, uint8_t* ok_out,
                                  uint8_t* conv_out, int* iters_out, void* stream) {
  if (errors == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{nullptr, nullptr, prior, errors, syn, shifts, w, n, ld, max_iter, 1, c2v, tot,
               nullptr, e_i, n, conv_out, ok_out, iters_out, stage_warps};
  return launch(a, method, batch, threads, smem_bytes, stream);
}

// Blocks of `threads` with smem_bytes of dynamic shared memory each that one
// SM holds of the instance (w, method, placement, stage_warps: staged or not),
// from the occupancy calculator; or minus a cudaError_t.
extern "C" int circulant_bp_occupancy(int w, int method, int shared, int threads, int smem_bytes, int stage_warps) {
  if (w < 1 || w > kMaxW || (method != 0 && method != 1) || !stage_warps_valid(shared != 0, threads, stage_warps)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const int idx = instance_of(w, method == 1, shared != 0, stage_warps != 0);
  cudaError_t e = opt_in(idx, smem_bytes);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, reinterpret_cast<const void*>(kKernels[idx]),
                                                      threads, static_cast<size_t>(smem_bytes));
  }
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}
