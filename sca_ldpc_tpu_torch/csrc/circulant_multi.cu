// Syndrome belief propagation on the masked multi-circulant code
// H = [[C_1]; ...; [C_P]] | I_{P*N} (P circulants of weight w sharing N
// variables, every row with its own identity column), for Hopper (sm_90a):
// K8, the HQC attack's decode.
//
// Replaces the XLA function _multi_circulant_bp of the JAX package
// (sca_ldpc_tpu/ops/circulant_bp.py:126; there is no Pallas kernel for it)
// and computes what it computes: product-sum or normalized min-sum
// (alpha 0.75, the circulant decoder's tie rule: only a unique minimum gets
// the second minimum), messages clipped at +-60 after the first iteration,
// the circulant totals summed in (block, plane) order, each frame's first
// converged estimate kept, and per-frame early exit.  An unmeasured row has
// an identity prior of exactly 0 and is computed like any other.
//
// Placement.  The attack decodes one frame at a time, so a frame is spread
// over many thread blocks, one thread a check or a variable, and each
// iteration is a sequence of launches on the caller's stream (no grid-wide
// synchronisation inside a kernel):
//   check sweep     grid (N / 256, B * P): the w + 1 incoming messages of
//                   check (b, p, i), plane t from variable (i - k_{p,t}) mod N
//                   (v2c = clip(tot - c2v), the unclipped prior in the first
//                   iteration), the identity member from its prior; writes
//                   each extrinsic c2v[b, p, t, i] in place and the identity
//                   decision e_i[b, p, i];
//   variable sweep  grid (N / 256, B): tot[b, j] = prior_c + sum over (p, t)
//                   of c2v[b, p, t, (j + k_{p,t}) mod N], in that order, no
//                   atomics, so every launch gives the same bits;
//   syndrome sweep  grid (N / 256, B * P): the decisions' syndrome against
//                   the input syndrome, one flag a frame;
//   status          one block: a frame whose syndrome held is done, its
//                   iteration count kept; the count of frames still running.
// A frame that is done is skipped by every later sweep, so its tot and e_i
// stay those of the iteration at which it converged: the latched estimate.
// The host loop reads the count of running frames every kCheckEvery
// iterations (one stream synchronisation) and stops at 0; the iterations
// launched after the last frame converged change nothing, so the outputs
// are those of a test every iteration.
//
// State in device memory: c2v [B, P, w, ld] f32 (ld = N rounded up to 32
// floats, 1.41 MB a block at HQC-128, w = 20: in the 50 MB L2 for small P),
// tot [B, N] f32, the identity decisions in the output e_i [B, P, N], and
// three ints a frame.
//
// What bounds it on the H100.  As K2 (circulant_bp.cu): per message (check,
// plane) and iteration the product-sum decode evaluates phi twice, 4
// transcendentals on the SFU, and moves 12 B of f32 planes (check sweep read
// and write, variable sweep read).  At batch 1 the launches themselves (four
// an iteration, a few microseconds each) are a large part of a decode; a
// cooperative or persistent form would remove them and is later work.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 60.0f;
constexpr float kMinSumAlpha = 0.75f;
constexpr int kMaxW = 64;
constexpr int kThreads = 256;
constexpr int kBuckets = 6;
constexpr int kCheckEvery = 4;  // iterations between reads of the running count

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

// Per-frame state: done and bad in the scratch state [2B + 1] with the
// running count after them, the iteration counts in the output.
struct State {
  int* done;   // 1 once the frame's syndrome held
  int* bad;    // this iteration's syndrome differs somewhere
  int* iters;  // iterations the frame ran (output)
  int* active; // [1] frames not done
};

struct Args {
  const float* prior_c;   // [B, N]
  const float* prior_i;   // [B, P, N]
  const uint8_t* syn;     // [B, P, N]
  const int* shifts;      // [P, w] in [0, N)
  int p, w, n, ld;
  float* c2v;             // [B, P, w, ld]
  float* tot;             // [B, N]
  uint8_t* e_i;           // [B, P, N] identity decisions (output)
  State s;
};

__global__ void __launch_bounds__(kThreads) multi_init_kernel(const Args a, int batch) {
  const size_t total = static_cast<size_t>(batch) * a.p * a.n;
  for (size_t x = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; x < total;
       x += static_cast<size_t>(gridDim.x) * blockDim.x) {
    a.e_i[x] = a.prior_i[x] < 0.0f;
    if (x < static_cast<size_t>(batch) * a.n) a.tot[x] = a.prior_c[x];
    if (x < static_cast<size_t>(batch)) {
      a.s.done[x] = 0;
      a.s.bad[x] = 0;
      a.s.iters[x] = 0;
    }
    if (x == 0) *a.s.active = batch;
  }
}

// MAXW: compile-time bound on w, so one check's incoming messages live in
// registers (K2's buckets).  MIN_SUM: normalized min-sum, else product-sum.
template <int MAXW, bool MIN_SUM>
__global__ void __launch_bounds__(kThreads) multi_check_kernel(const Args a, int first) {
  const int bp = blockIdx.y;  // b * P + p
  const int b = bp / a.p;
  const int pb = bp - b * a.p;
  if (a.s.done[b]) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = a.n, w = a.w;
  if (i >= n) return;
  const int* k = a.shifts + static_cast<size_t>(pb) * w;
  const float* tot = a.tot + static_cast<size_t>(b) * n;
  float* c2v_i = a.c2v + static_cast<size_t>(bp) * w * a.ld + i;
  const size_t row = static_cast<size_t>(bp) * n + i;

  float m[MAXW];  // signed phi(|v2c|) (product-sum) or signed |v2c| (min-sum)
  const float p_i = a.prior_i[row];
  const bool neg_i = p_i < 0.0f;
  int parity = a.syn[row] ^ static_cast<int>(neg_i);
  float acc = 0.0f, min1 = INFINITY, min2 = INFINITY;
  int cnt = 0;
#pragma unroll
  for (int t = 0; t < MAXW; ++t) {
    if (t < w) {
      int j = i - __ldg(k + t);
      j += (j < 0) ? n : 0;
      const float v = first ? tot[j] : fminf(fmaxf(tot[j] - c2v_i[static_cast<size_t>(t) * a.ld], -kBig), kBig);
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
  // the identity member (a degree-1 variable: always its prior)
  const float m_i = MIN_SUM ? fabsf(p_i) : phi(fabsf(p_i));
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
      c2v_i[static_cast<size_t>(t) * a.ld] = (parity ^ sign_bit(m[t])) ? -ext : ext;
    }
  }
  float ext_i;
  if constexpr (MIN_SUM) {
    ext_i = (m_i == min1 && cnt == 1) ? min2 : min1;
    ext_i = kMinSumAlpha * fminf(ext_i, kBig);
  } else {
    ext_i = phi(fmaxf(acc - m_i, 1e-9f));
  }
  a.e_i[row] = p_i + ((parity ^ static_cast<int>(neg_i)) ? -ext_i : ext_i) < 0.0f;
}

__global__ void __launch_bounds__(kThreads) multi_var_kernel(const Args a) {
  const int b = blockIdx.y;
  if (a.s.done[b]) return;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = a.n, w = a.w;
  if (j >= n) return;
  const float* c2v = a.c2v + static_cast<size_t>(b) * a.p * w * a.ld;
  float s = 0.0f;
  for (int q = 0; q < a.p * w; ++q) {  // q = p * w + t: (block, plane) order
    int i = j + __ldg(a.shifts + q);
    i -= (i >= n) ? n : 0;
    s += c2v[static_cast<size_t>(q) * a.ld + i];
  }
  const size_t x = static_cast<size_t>(b) * n + j;
  a.tot[x] = a.prior_c[x] + s;
}

__global__ void __launch_bounds__(kThreads) multi_syndrome_kernel(const Args a) {
  const int bp = blockIdx.y;
  const int b = bp / a.p;
  if (a.s.done[b]) return;  // uniform over the block
  const int pb = bp - b * a.p;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = a.n, w = a.w;
  int bad = 0;
  if (i < n) {
    const size_t row = static_cast<size_t>(bp) * n + i;
    const int* k = a.shifts + static_cast<size_t>(pb) * w;
    const float* tot = a.tot + static_cast<size_t>(b) * n;
    int s = a.e_i[row];
    for (int t = 0; t < w; ++t) {
      int j = i - __ldg(k + t);
      j += (j < 0) ? n : 0;
      s += tot[j] < 0.0f;
    }
    bad = (s & 1) != a.syn[row];
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) a.s.bad[b] = 1;  // every writer stores 1
}

__global__ void multi_status_kernel(const Args a, int batch, int it) {
  __shared__ int running;
  if (threadIdx.x == 0) running = 0;
  __syncthreads();
  int mine = 0;
  for (int b = threadIdx.x; b < batch; b += blockDim.x) {
    if (!a.s.done[b]) {
      a.s.iters[b] = it + 1;
      if (a.s.bad[b]) {
        ++mine;
      } else {
        a.s.done[b] = 1;
      }
      a.s.bad[b] = 0;
    }
  }
  if (mine) atomicAdd(&running, mine);
  __syncthreads();
  if (threadIdx.x == 0) *a.s.active = running;
}

__global__ void __launch_bounds__(kThreads) multi_final_kernel(const Args a, int batch, uint8_t* e_c,
                                                               uint8_t* conv) {
  const size_t total = static_cast<size_t>(batch) * a.n;
  for (size_t x = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; x < total;
       x += static_cast<size_t>(gridDim.x) * blockDim.x) {
    e_c[x] = a.tot[x] < 0.0f;
    if (x < static_cast<size_t>(batch)) conv[x] = a.s.done[x] != 0;
  }
}

using CheckKernel = void (*)(Args, int);

#define MULTI_BUCKETS(MS)                                                                    \
  multi_check_kernel<8, MS>, multi_check_kernel<16, MS>, multi_check_kernel<20, MS>,         \
      multi_check_kernel<30, MS>, multi_check_kernel<32, MS>, multi_check_kernel<64, MS>

// Every check-sweep instance, indexed [min_sum][bucket].
const CheckKernel kCheck[2 * kBuckets] = {MULTI_BUCKETS(false), MULTI_BUCKETS(true)};

int bucket_of(int w) {
  if (w == 20) return 2;
  if (w == 30) return 3;
  if (w <= 8) return 0;
  if (w <= 16) return 1;
  if (w <= 32) return 4;
  return 5;
}

int grid_stride_blocks(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 65535 ? (blocks ? blocks : 1) : 65535);
}

}  // namespace

// Decode API (replaces _multi_circulant_bp).  method: 0 product-sum, 1
// min-sum.  prior_c [B, N] f32; prior_i [B, P, N] f32 (0 = an inert row);
// syndrome [B, P, N] 0/1; shifts [P, w] int32 in [0, N).  Scratch, no initialisation needed: c2v [B, P, w, ld]
// f32 (ld >= N, a multiple of 32), tot [B, N] f32, state [2B + 1] int32.
// Out: e_c [B, N] and e_i [B, P, N] 0/1, conv [B], iters [B].  Returns a
// cudaError_t.
extern "C" int multi_circulant_bp_decode(const float* prior_c, const float* prior_i, const uint8_t* syndrome,
                                         const int* shifts, int p, int w, int n, int ld, int batch, int max_iter,
                                         int method, float* c2v, float* tot, int* state,
                                         uint8_t* e_c, uint8_t* e_i, uint8_t* conv, int* iters, void* stream) {
  if (prior_c == nullptr || prior_i == nullptr || syndrome == nullptr || shifts == nullptr || p < 1 || w < 1 ||
      w > kMaxW || n < 1 || ld < n || ld % 32 != 0 || batch < 0 || batch > 65535 || max_iter < 0 ||
      (method != 0 && method != 1) || static_cast<long long>(batch) * p > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{prior_c, prior_i, syndrome, shifts, p, w, n, ld, c2v, tot, e_i,
               State{state, state + batch, iters, state + 2 * batch}};
  const int tiles = (n + kThreads - 1) / kThreads;
  const dim3 rows(tiles, batch * p), vars(tiles, batch);
  const CheckKernel check = kCheck[(method == 1 ? kBuckets : 0) + bucket_of(w)];

  multi_init_kernel<<<grid_stride_blocks(static_cast<size_t>(batch) * p * n), kThreads, 0, st>>>(a, batch);
  cudaError_t e = cudaGetLastError();
  for (int it = 0; it < max_iter && e == cudaSuccess; ++it) {
    check<<<rows, kThreads, 0, st>>>(a, it == 0);
    multi_var_kernel<<<vars, kThreads, 0, st>>>(a);
    multi_syndrome_kernel<<<rows, kThreads, 0, st>>>(a);
    multi_status_kernel<<<1, 1024, 0, st>>>(a, batch, it);
    e = cudaGetLastError();
    if (e == cudaSuccess && (it + 1) % kCheckEvery == 0 && it + 1 < max_iter) {
      int running = 0;
      e = cudaMemcpyAsync(&running, a.s.active, sizeof(int), cudaMemcpyDeviceToHost, st);
      if (e == cudaSuccess) e = cudaStreamSynchronize(st);
      if (e == cudaSuccess && running == 0) break;
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  multi_final_kernel<<<grid_stride_blocks(static_cast<size_t>(batch) * n), kThreads, 0, st>>>(a, batch, e_c, conv);
  return static_cast<int>(cudaGetLastError());
}

// Blocks a launch of each sweep takes for (batch, p, n): check and syndrome
// sweeps, variable sweep (out[0], out[1]); threads a block in out[2].
extern "C" void multi_circulant_bp_blocks(int batch, int p, int n, int* out) {
  const int tiles = (n + kThreads - 1) / kThreads;
  out[0] = tiles * batch * p;
  out[1] = tiles * batch;
  out[2] = kThreads;
}
