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
// over many thread blocks, one thread a check or a variable.  A decode is
// one persistent cooperative launch (cudaLaunchCooperativeKernel: every
// block is resident, so a grid-wide barrier cannot deadlock) whose blocks
// walk the work tiles with a grid stride, kThreads rows of one (frame,
// circulant block) or kThreads variables of one frame a tile.  An iteration
// is three sweeps with a grid barrier after each:
//   check sweep     the w + 1 incoming messages of check (b, p, i), plane t
//                   from variable (i - k_{p,t}) mod N (v2c = clip(tot - c2v),
//                   the unclipped prior in the first iteration), the
//                   identity member from its prior; writes each extrinsic
//                   c2v[b, p, t, i] in place and the identity decision
//                   e_i[b, p, i];
//   variable sweep  tot[b, j] = prior_c + sum over (p, t) of
//                   c2v[b, p, t, (j + k_{p,t}) mod N], in that order, no
//                   atomics, so every launch gives the same bits, and the
//                   decision e_c[b, j] = tot < 0 (a byte, the output);
//   syndrome sweep  the decisions' syndrome (bytes of e_c and e_i) against
//                   the input syndrome: a tile that finds a row wrong sets
//                   its frame's bad flag (an atomic OR nobody waits for).
// The exit is decided on the card.  The bad flags are double-buffered by
// iteration parity: frame b runs iteration it iff it == 0 or its flag of
// iteration it - 1 is set (a frame that is done is skipped, so it never
// sets a flag again).  After the barrier every block reads the same flags
// into a bitmask in its shared memory, which the next iteration's sweeps
// test: all blocks leave the loop after the iteration that set no flag.  A
// buffer is cleared at the start of the iteration after its last reader, so
// clearing costs no barrier.  A skipped frame's tot, e_c and e_i stay those
// of the iteration at which it converged: the latched estimate.  No host
// synchronisation and no copy to the host.
//
// Once a decode, not once an iteration: each block stages the shifts in
// shared memory (the running-frame bitmask after them).  They are [P, w],
// shared by the batch, or [B, P, w], a set a frame (the batched attack's
// round: frame b is instance b, decoded with its own circulants).  Staging
// (Args::stage): 0 the shared [P, w]; 1 all B sets, where they fit in the
// 48 KB a block takes without an opt-in (the wrapper's choice); 2 frame b's
// shifts staged with each tile of frame b, a block barrier before and after
// (a round too large to stage whole).  Each thread
// issues all the gathers of its check (or of one circulant block's planes of
// its variable) before it uses any, so a sweep waits for one round trip to
// L2 a row, not w.
//
// State in device memory: c2v [B, P, w, ld] f32 (ld = N rounded up to 32
// floats, 1.41 MB a block at HQC-128, w = 20: in the 50 MB L2 for small P),
// tot [B, N] f32, the decisions in the outputs e_c [B, N] and e_i
// [B, P, N], and the flags [2B].  The grid barrier orders memory (its
// release and acquire), so what one sweep wrote the next reads with plain
// loads; the flags with __ldcg; the inputs with __ldg.
//
// What bounds it on the H100.  As K2 (circulant_bp.cu): per message (check,
// plane) and iteration the product-sum decode evaluates phi twice, 4
// transcendentals on the SFU, and moves 12 B of f32 planes (check sweep read
// and write, variable sweep read).  At batch 1 (the attack's recovery
// decode, 70 blocks) an iteration takes about 17 us: the three barriers and
// the bitmask about 4, the check sweep about 9 (two warps of precise phi on
// an SM sub-partition, latency-bound), the variable and syndrome sweeps
// about 2 and 1.  At batch 16 and P = 8 the planes outgrow L2 and the check
// sweep's arithmetic and the planes' bytes bind, as in the form before.
//
// tools/k8_variants.py writes timing-only edited copies of this source (the
// barrier floor: the loop and the barriers without sweep work) and the
// stage-2 form, which tools/circulant_forms.py --kernels k8 times beside it.

#include <climits>
#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 60.0f;
constexpr float kMinSumAlpha = 0.75f;
constexpr int kMaxW = 64;
constexpr int kThreads = 256;       // threads a block: rows (or variables) a tile
constexpr int kMaxShifts = 10240;   // P * w shifts of a frame in a block's shared memory (40 KB)
constexpr int kMaxBatch = 65535;    // frames: a bitmask of at most 8 KB beside the shifts
constexpr int kMaxStaged = 12288;   // ints staged a block, shifts and bitmask (48 KB: no opt-in needed)
constexpr int kBuckets = 6;

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
  const float* prior_c;   // [B, N]
  const float* prior_i;   // [B, P, N]
  const uint8_t* syn;     // [B, P, N]
  const int* shifts;      // [P, w] (stage 0) or [B, P, w] (stages 1, 2) in [0, N)
  int stage;              // 0 shared shifts; 1 every frame's staged; 2 a tile's staged with it
  int batch, p, w, n, ld;
  int tiles;              // row tiles of one (frame, block): ceil(N / kThreads)
  int max_iter;
  float* c2v;             // [B, P, w, ld]
  float* tot;             // [B, N]
  int* flags;             // [2, B] bad flags by iteration parity
  uint8_t* e_c;           // [B, N] decisions (output)
  uint8_t* e_i;           // [B, P, N] identity decisions (output)
  uint8_t* conv;          // [B] (output)
  int* iters;             // [B] iterations each frame ran (output)
};

// Frame b's shifts from circulant block pb on, in shared memory: staged once
// a block (stages 0 and 1), or `count` of them staged now (stage 2; every
// thread of the block calls it, for the tile the block is on).
__device__ __forceinline__ const int* frame_shifts(const Args& a, int* ks, int b, int pb, int count) {
  if (a.stage == 0) return ks + pb * a.w;
  const size_t at = (static_cast<size_t>(b) * a.p + pb) * a.w;
  if (a.stage == 1) return ks + at;
  __syncthreads();  // the block's last tile has read the buffer
  for (int q = threadIdx.x; q < count; q += kThreads) ks[q] = __ldg(a.shifts + at + q);
  __syncthreads();
  return ks;
}

// Check (b, pb, i), bp = b * P + pb, with its block's shifts k: the
// extrinsic c2v of its w planes and its identity decision.
template <int MAXW, bool MIN_SUM>
__device__ __forceinline__ void check_row(const Args& a, const int* k, int bp, int b, int i, bool first) {
  const int n = a.n, w = a.w;
  const size_t row = static_cast<size_t>(bp) * n + i;
  const float* prior = a.prior_c + static_cast<size_t>(b) * n;
  const float* tot = a.tot + static_cast<size_t>(b) * n;
  float* c2v_i = a.c2v + static_cast<size_t>(bp) * w * a.ld + i;
  const float p_i = __ldg(a.prior_i + row);
  const bool neg_i = p_i < 0.0f;
  int parity = __ldg(a.syn + row) ^ static_cast<int>(neg_i);

  // the incoming v2c (clip(tot - c2v), the unclipped prior in the first
  // iteration), all gathered before any is used
  float m[MAXW];
  if (first) {
#pragma unroll
    for (int t = 0; t < MAXW; ++t) {
      if (t < w) {
        int j = i - k[t];
        j += (j < 0) ? n : 0;
        m[t] = __ldg(prior + j);
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < MAXW; ++t) {
      if (t < w) {
        int j = i - k[t];
        j += (j < 0) ? n : 0;
        m[t] = fminf(fmaxf(tot[j] - c2v_i[static_cast<size_t>(t) * a.ld], -kBig), kBig);
      }
    }
  }
  // then m[t]: signed phi(|v2c|) (product-sum) or signed |v2c| (min-sum)
  float acc = 0.0f, min1 = INFINITY, min2 = INFINITY;
  int cnt = 0;
#pragma unroll
  for (int t = 0; t < MAXW; ++t) {
    if (t < w) {
      const float v = m[t];
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

// Variable (b, j): prior plus the P * w incoming messages in (block, plane)
// order, a block's w planes gathered before they are summed.
template <int MAXW>
__device__ __forceinline__ void variable(const Args& a, const int* ks, int b, int j) {
  const int n = a.n, w = a.w;
  float s = 0.0f;
  for (int pb = 0; pb < a.p; ++pb) {
    const float* c2v = a.c2v + static_cast<size_t>(b * a.p + pb) * w * a.ld;
    const int* k = ks + pb * w;
    float v[MAXW];
#pragma unroll
    for (int t = 0; t < MAXW; ++t) {
      if (t < w) {
        int i = j + k[t];
        i -= (i >= n) ? n : 0;
        v[t] = c2v[static_cast<size_t>(t) * a.ld + i];
      }
    }
#pragma unroll
    for (int t = 0; t < MAXW; ++t) {
      if (t < w) s += v[t];
    }
  }
  const size_t x = static_cast<size_t>(b) * n + j;
  const float t = __ldg(a.prior_c + x) + s;
  a.tot[x] = t;
  a.e_c[x] = t < 0.0f;
}

// 1 if check (b, pb, i)'s decisions miss its syndrome bit.
template <int MAXW>
__device__ __forceinline__ int syndrome_wrong(const Args& a, const int* k, int bp, int b, int i) {
  const int n = a.n;
  const size_t row = static_cast<size_t>(bp) * n + i;
  const uint8_t* e_c = a.e_c + static_cast<size_t>(b) * n;
  int s = a.e_i[row];
#pragma unroll
  for (int t = 0; t < MAXW; ++t) {
    if (t < a.w) {
      int j = i - k[t];
      j += (j < 0) ? n : 0;
      s += e_c[j];
    }
  }
  return (s & 1) != __ldg(a.syn + row);
}

// MAXW: compile-time bound on w, so one check's incoming messages live in
// registers (K2's buckets).  MIN_SUM: normalized min-sum, else product-sum.
template <int MAXW, bool MIN_SUM>
__global__ void multi_decode_kernel(const Args a) {
  extern __shared__ int ks[];  // the staged shifts, then the running-frame bitmask
  const int staged = (a.stage == 1 ? a.batch : 1) * a.p * a.w;
  if (a.stage != 2) {
    for (int q = threadIdx.x; q < staged; q += kThreads) ks[q] = __ldg(a.shifts + q);
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int n = a.n, tiles = a.tiles;
  const int row_tiles = a.batch * a.p * tiles, var_tiles = a.batch * tiles;
  const int g = blockIdx.x * kThreads + threadIdx.x, stride = gridDim.x * kThreads;

  unsigned* const run = reinterpret_cast<unsigned*>(ks + staged);  // bit b: frame b runs this iteration
  const int words = (a.batch + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int x = threadIdx.x; x < words; x += kThreads) run[x] = ~0u;  // every frame runs iteration 0
  __syncthreads();

  int it = 0;
  while (it < a.max_iter) {
    int* bad = a.flags + (it & 1) * a.batch;
    for (int b = g; b < a.batch; b += stride) {
      if (run[b / 32] >> (b % 32) & 1) a.iters[b] = it + 1;
      bad[b] = 0;  // last read after iteration it - 2
    }

    for (int tile = blockIdx.x; tile < row_tiles; tile += gridDim.x) {
      const int bp = tile / tiles, b = bp / a.p;
      if (!(run[b / 32] >> (b % 32) & 1)) continue;  // the frame is done: uniform over the block
      const int* k = frame_shifts(a, ks, b, bp - b * a.p, a.w);
      const int i = (tile - bp * tiles) * kThreads + threadIdx.x;
      if (i < n) check_row<MAXW, MIN_SUM>(a, k, bp, b, i, it == 0);
    }
    grid.sync();

    for (int tile = blockIdx.x; tile < var_tiles; tile += gridDim.x) {
      const int b = tile / tiles;
      if (!(run[b / 32] >> (b % 32) & 1)) continue;
      const int* k = frame_shifts(a, ks, b, 0, a.p * a.w);
      const int j = (tile - b * tiles) * kThreads + threadIdx.x;
      if (j < n) variable<MAXW>(a, k, b, j);
    }
    grid.sync();

    for (int tile = blockIdx.x; tile < row_tiles; tile += gridDim.x) {
      const int bp = tile / tiles, b = bp / a.p;
      if (!(run[b / 32] >> (b % 32) & 1)) continue;
      const int* k = frame_shifts(a, ks, b, bp - b * a.p, a.w);
      const int i = (tile - bp * tiles) * kThreads + threadIdx.x;
      const int wrong = i < n && syndrome_wrong<MAXW>(a, k, bp, b, i);
      if (__syncthreads_or(wrong) && threadIdx.x == 0) atomicOr(bad + b, 1);
    }
    grid.sync();
    // the frames that run the next iteration: this one's bad flags, the
    // same in every block; a warp a word of the bitmask
    int any = 0;
    for (int x = warp; x < words; x += kThreads / 32) {
      const int b = 32 * x + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, b < a.batch && __ldcg(bad + b));
      run[x] = bits;
      any |= bits != 0;
    }
    const int more = __syncthreads_or(any);
    ++it;
    if (!more) break;
  }

  // it: the iterations run.  e_c is final since the last variable sweep, the
  // bitmask holds the last iteration's bad flags.
  const size_t total_c = static_cast<size_t>(a.batch) * n;
  for (int b = g; b < a.batch; b += stride) {
    a.conv[b] = it && !(run[b / 32] >> (b % 32) & 1);
    if (it == 0) a.iters[b] = 0;
  }
  if (it == 0) {
    for (size_t x = g; x < total_c; x += stride) a.e_c[x] = __ldg(a.prior_c + x) < 0.0f;
    for (size_t x = g; x < total_c * a.p; x += stride) a.e_i[x] = __ldg(a.prior_i + x) < 0.0f;
  }
}

using DecodeKernel = void (*)(Args);

#define MULTI_BUCKETS(MS)                                                                    \
  multi_decode_kernel<8, MS>, multi_decode_kernel<16, MS>, multi_decode_kernel<20, MS>,      \
      multi_decode_kernel<30, MS>, multi_decode_kernel<32, MS>, multi_decode_kernel<64, MS>

// Every instance, indexed [min_sum][bucket].
const DecodeKernel kDecode[2 * kBuckets] = {MULTI_BUCKETS(false), MULTI_BUCKETS(true)};

// Dynamic shared memory a block: the staged shifts and the running-frame
// bitmask.
size_t smem_bytes(int stage, int p, int w, int batch) {
  return sizeof(int) * ((stage == 1 ? static_cast<size_t>(batch) : 1) * p * w + (batch + 31) / 32);
}

// The shapes every instance takes: w and a frame's P * w shifts, the batch,
// the staging and, for stage 1, every shift staged.
bool valid_shape(int stage, int p, int w, int batch) {
  return p >= 1 && w >= 1 && w <= kMaxW && static_cast<long long>(p) * w <= kMaxShifts && batch >= 0 &&
         batch <= kMaxBatch && stage >= 0 && stage <= 2 &&
         (stage != 1 || smem_bytes(stage, p, w, batch) <= sizeof(int) * kMaxStaged);
}

DecodeKernel kernel_for(int w, int method) {
  int bucket = 5;
  if (w == 20) {
    bucket = 2;
  } else if (w == 30) {
    bucket = 3;
  } else if (w <= 8) {
    bucket = 0;
  } else if (w <= 16) {
    bucket = 1;
  } else if (w <= 32) {
    bucket = 4;
  }
  return kDecode[(method == 1 ? kBuckets : 0) + bucket];
}

}  // namespace

// Decode API (replaces _multi_circulant_bp).  method: 0 product-sum, 1
// min-sum.  prior_c [B, N] f32; prior_i [B, P, N] f32 (0 = an inert row);
// syndrome [B, P, N] 0/1; shifts int32 in [0, N), [P, w] shared by the
// batch (stage 0) or [B, P, w], frame b's circulants in shifts[b] (stage 1:
// all staged in a block's shared memory, at most kMaxStaged ints with the
// bitmask; stage 2: staged a tile at a time).  grid: blocks of
// the cooperative launch, at most the co-resident blocks
// (multi_circulant_bp_occupancy; the Python helper multi_circulant_launch
// picks it).  Scratch, no initialisation needed: c2v [B, P, w, ld] f32
// (ld >= N, a multiple of 32), tot [B, N] f32, flags [2B] int32.
// Out: e_c [B, N] and e_i [B, P, N] 0/1, conv [B], iters [B].  One launch
// on the stream, no synchronisation.  Returns a cudaError_t: the launch's
// own when it is refused (cudaErrorCooperativeLaunchTooLarge for a grid
// that cannot be resident, or a card without cooperative launch).
extern "C" int multi_circulant_bp_decode(const float* prior_c, const float* prior_i, const uint8_t* syndrome,
                                         const int* shifts, int stage, int p, int w, int n, int ld, int batch,
                                         int max_iter, int method, int grid, float* c2v, float* tot, int* flags,
                                         uint8_t* e_c, uint8_t* e_i, uint8_t* conv, int* iters, void* stream) {
  const long long tiles = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  if (prior_c == nullptr || prior_i == nullptr || syndrome == nullptr || shifts == nullptr ||
      !valid_shape(stage, p, w, batch) || n < 1 || ld < n || ld % 32 != 0 || max_iter < 0 ||
      (method != 0 && method != 1) || grid < 1 ||
      static_cast<long long>(batch) * p * tiles > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  Args a{prior_c, prior_i, syndrome, shifts, stage, batch, p, w, n, ld, static_cast<int>(tiles), max_iter,
         c2v, tot, flags, e_c, e_i, conv, iters};
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel_for(w, method)), dim3(grid),
                                                    dim3(kThreads), params, smem_bytes(stage, p, w, batch),
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind for the next caller
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The current device's limits for the instance of (w, method) with the
// shifts of P blocks staged as `stage` and a batch's bitmask in shared
// memory: out[0] blocks resident on an SM (occupancy calculator), out[1]
// SMs, out[2] 1 if the device can launch cooperatively, out[3] threads a
// block.  Returns a cudaError_t.
extern "C" int multi_circulant_bp_occupancy(int w, int method, int stage, int p, int batch, int* out) {
  if (!valid_shape(stage, p, w, batch) || batch < 1 || (method != 0 && method != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel_for(w, method), kThreads,
                                                      smem_bytes(stage, p, w, batch));
  }
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out[2], cudaDevAttrCooperativeLaunch, dev);
  out[3] = kThreads;
  return static_cast<int>(e);
}
