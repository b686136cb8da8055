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
// What bounds it on the H100.  Per message (check, plane) and iteration the
// product-sum decode evaluates phi = -log(tanh(x/2)) twice: 4 transcendentals
// on the SFU (16 a clock per SM), about 4 ms for one HQC-128 FER step at
// batch 4096, against 0.04 ms for its bytes in and out.  Precise logf/tanhf
// (no fast-math: it changes phi near its ends) cost some 40 FP32
// instructions per phi, and the c2v planes cost 12 B of device-memory
// traffic per message (check sweep read and write, variable sweep read),
// 14.5 ms for that step at 3.35 TB/s; so the kernel is bound by instruction
// issue and device-memory bandwidth together, and its design keeps every
// other access off device memory and enough warps resident to hide the
// latency of both:
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
//      aligned line (4 sectors; an odd N gave 5).  16-byte vectors per
//      thread would need 4 checks a thread, 4w live magnitudes (120
//      registers at w = 30), against the 64 that 32 warps allow.  The
//      variable sweep at (j + k_t) mod N is unaligned and stays scalar and
//      coalesced.
//   4. Loop-invariant work hoisted: in the FER step every prior is one
//      constant, so phi(|p_i|) is computed once per frame, and so is the
//      first iteration's extrinsic magnitude (every incoming message is the
//      prior then): that check sweep only writes signs, by the same
//      arithmetic as the general sweep, so the results are bit for bit the
//      same.

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

__host__ __device__ __forceinline__ int pad32(int x) { return (x + 31) & ~31; }

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
};

// MAXW: compile-time bound on w, so one check's incoming messages live in
// registers.  MIN_SUM: normalized min-sum, else product-sum.  TOT_SMEM: tot
// in shared memory, else in device memory.
template <int MAXW, bool MIN_SUM, bool TOT_SMEM>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) circulant_bp_kernel(const Args a) {
  // k_s [pad32(MAXW)] (= pad32(w) for every w of the bucket), then tot [N]
  // in the shared placement
  extern __shared__ __align__(16) int smem[];
  int* k_s = smem;
  const int w = a.w;
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
    __syncthreads();

    // ---- variable sweep (summation order as in the plain version)
    for (int j = tid; j < n; j += nt) {
      float s = 0.0f;
      for (int t = 0; t < w; ++t) {
        int i = j + k_s[t];
        i -= (i >= n) ? n : 0;
        s += c2v[static_cast<size_t>(t) * ld + i];
      }
      tot[j] = (pc ? pc[j] : a.prior_const) + s;
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

#define CIRCULANT_BUCKETS(MS, SH)                                                           \
  circulant_bp_kernel<8, MS, SH>, circulant_bp_kernel<16, MS, SH>, circulant_bp_kernel<20, MS, SH>, \
      circulant_bp_kernel<30, MS, SH>, circulant_bp_kernel<32, MS, SH>, circulant_bp_kernel<64, MS, SH>

// Every instance, indexed [min_sum][shared][bucket].
const Kernel kKernels[2 * 2 * kBuckets] = {
    CIRCULANT_BUCKETS(false, false), CIRCULANT_BUCKETS(false, true),
    CIRCULANT_BUCKETS(true, false), CIRCULANT_BUCKETS(true, true),
};

int bucket_of(int w) {
  if (w == 20) return 2;
  if (w == 30) return 3;
  if (w <= 8) return 0;
  if (w <= 16) return 1;
  if (w <= 32) return 4;
  return 5;
}

int instance_of(int w, bool min_sum, bool shared) {
  return (static_cast<int>(min_sum) * 2 + static_cast<int>(shared)) * kBuckets + bucket_of(w);
}

// Raise an instance's dynamic shared-memory cap to `bytes` (the host picks
// the size within the device's limits) when it is above the cap set so far
// on this device.  A cap is never lowered, so no launch is refused for a
// smaller one set in between.
cudaError_t opt_in(int idx, int bytes) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static int cap[kMaxDevices][2 * 2 * kBuckets];
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

int launch(const Args& a, int method, int batch, int threads, int smem_bytes, void* stream) {
  const bool shared = a.tot == nullptr;
  if (a.w < 1 || a.w > kMaxW || a.n < 1 || batch < 0 || a.max_iter < 0 || (method != 0 && method != 1) ||
      a.ld < a.n || a.ld % 32 != 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(smem_bytes) < 4LL * (pad32(a.w) + (shared ? a.n : 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const int idx = instance_of(a.w, method == 1, shared);
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
// shared memory, 4 pad32(w) in device memory).  Scratch, no initialisation
// needed: c2v [B, w, ld] f32 (ld >= N, a multiple of 32); tot [B, N] f32 for
// the device placement, or null for the shared one.  Out: e [B, 2N] 0/1
// ([B, N] without the identity), conv [B], iters [B] (may be null).
// Returns a cudaError_t.
extern "C" int circulant_bp_decode(const float* prior_c, const float* prior_i, uint8_t* syndrome,
                                   const int* shifts, int w, int n, int ld, int batch, int max_iter, int method,
                                   int with_identity, int threads, int smem_bytes, float* c2v, float* tot,
                                   uint8_t* e_out, uint8_t* conv_out, int* iters_out, void* stream) {
  if (prior_c == nullptr || prior_i == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool id = with_identity != 0;
  const Args a{prior_c, prior_i, 0.0f, nullptr, syndrome, shifts, w, n, ld, max_iter, id ? 1 : 0, c2v, tot,
               e_out, id ? e_out + n : nullptr, id ? 2 * n : n, conv_out, nullptr, iters_out};
  return launch(a, method, batch, threads, smem_bytes, stream);
}

// FER step (replaces circulant_fer_pallas): errors [B, 2N] 0/1 in; the
// syndrome (scratch syn [B, N]) and the identity decisions (scratch e_i
// [B, N]) are formed on the card; out: ok [B] (decisions equal the errors)
// and conv [B], and iters [B] (may be null: each frame's iterations, as
// circulant_bp_decode gives them).  Launch and scratch as for
// circulant_bp_decode.
extern "C" int circulant_fer_step(const uint8_t* errors, float prior, const int* shifts, int w, int n, int ld,
                                  int batch, int max_iter, int method, int threads, int smem_bytes, float* c2v,
                                  float* tot, uint8_t* syn, uint8_t* e_i, uint8_t* ok_out, uint8_t* conv_out,
                                  int* iters_out, void* stream) {
  if (errors == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{nullptr, nullptr, prior, errors, syn, shifts, w, n, ld, max_iter, 1, c2v, tot,
               nullptr, e_i, n, conv_out, ok_out, iters_out};
  return launch(a, method, batch, threads, smem_bytes, stream);
}

// Blocks of `threads` with smem_bytes of dynamic shared memory each that one
// SM holds of the instance (w, method, placement), from the occupancy
// calculator; or minus a cudaError_t.
extern "C" int circulant_bp_occupancy(int w, int method, int shared, int threads, int smem_bytes) {
  if (w < 1 || w > kMaxW || (method != 0 && method != 1)) return -static_cast<int>(cudaErrorInvalidValue);
  const int idx = instance_of(w, method == 1, shared != 0);
  cudaError_t e = opt_in(idx, smem_bytes);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, reinterpret_cast<const void*>(kKernels[idx]),
                                                      threads, static_cast<size_t>(smem_bytes));
  }
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}
