// Lean syndrome belief propagation on H = [circulant(N, w) | I_N] with bf16
// message planes, one frame per thread block, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in sca_ldpc_tpu/ops/kernels/circulant_pallas.py:
//   circulant_bp_pallas_lean  (body _make_lean_kernel)      -> circulant_bp_lean_decode()
//   circulant_fer_pallas_lean (body _make_lean_fer_kernel)  -> circulant_fer_lean_step()
// in their default form (shifts as data, one plane per group), and computes
// what they compute, rounding point for rounding point: product-sum only;
// the v2c and c2v messages are rounded to bf16 (to nearest even, as JAX's
// astype) where the TPU kernel stores its planes; the check accumulators (phi
// sum, sign product) are rebuilt from the bf16 messages in plane order; the
// variable totals add the f32 extrinsics in plane order; v2c is clipped at
// +-60 after the first iteration.  The plain PyTorch version is
// circulant_bp_lean_plain in ops/kernels/circulant_cuda.py.
// The TPU kernel's lane padding (m > n) exists only for Mosaic's rolls and
// has no counterpart: a cyclic shift here is index arithmetic on the load.
//
// State of one frame, in device memory (HBM, cached in L2):
//   v2c [w, ld] bf16   the variable-to-check messages, stored at the variable:
//                      v2c[t][j] goes from variable j to check (j + k_t) mod N
//   acc [N]     f32    per check: phi(|prior_i|) + sum_t phi(|v2c[t]|), with
//                      the parity of the negative incoming messages and the
//                      syndrome bit (the sign product) in the float's sign
//                      bit.  The sum is >= 0 or -0.0f (phi(60) is -0.0f), and
//                      a zero of either sign gives the same extrinsic, so the
//                      magnitude stands for the sum.
//   e   [2N]    u8     the decisions (an output, and pass B's view of tot)
// and in the block's shared memory the shifts, a table of phi over the bf16
// magnitudes (below) and the bf16 extrinsics of the variables in hand.
// Per iteration a block makes two sweeps, with __syncthreads() between:
//   pass A over variables j, a chunk at a time: for t in order, the
//     extrinsic of plane t at check c = (j + k_t) mod N from acc[c] and
//     v2c[t][j]; its bf16 form (the TPU kernel's c2v plane) is staged in
//     shared memory and its f32 form added to the total tot[j], which stays
//     in a register.  With tot[j] complete, the next messages overwrite the
//     old in place, v2c[t][j] = bf16(clip(tot[j] - bf16 extrinsic)), and the
//     decision tot[j] < 0 is stored.
//   pass B over checks i: the identity extrinsic and decision, then for t
//     in order, with j = (i - k_t) mod N, the syndrome of the decisions
//     (e[j]) and the next iteration's acc[i] from the messages v2c[t][j]; the
//     convergence test reduces with __syncthreads_or.  It writes no plane.
// The TPU kernel writes the new v2c planes in its second sweep, from the
// rolled totals; here the variable's own thread writes them as soon as its
// total is known, which is the same value of the same operands.  Every slot
// has one writer and every sum runs in plane order: no atomics, and two runs
// give the same bits.  A converged frame stops, and its block frees the SM
// for the next frame.
//
// What the design does for the H100.  The function needs two phi a message
// and iteration (a precise one, -logf(tanhf(x / 2)), costs some 40 FP32
// instructions; no fast-math, which changes phi near its ends).  Measured on
// the card (PERF.md), what bound the sweeps was how the memory system was
// driven: partly written 32-byte sectors, few bytes in flight a thread, and
// gathers that miss L2.
//  - one plane array instead of two, and no totals in memory.  The c2v
//    planes live only as a chunk's extrinsics in shared memory (w x kElemsA
//    x 512 bf16 values; the launch stages as many variables a thread as fit
//    twice on an SM: 4 at w = 20, 3 at w = 30), and pass B reads a decision
//    byte where it would gather a 4-byte total.  A message and iteration
//    moves 6 B of planes (pass A reads and rewrites v2c, pass B reads it)
//    and gathers 4 B of acc and 1 B of decisions; the state is half the size.
//  - every plane store is at the writer's own index, so a warp's store is 64
//    contiguous bytes; the rows start on 64-byte boundaries (ld is N rounded
//    up to 32 values), so the stores fill whole sectors.  The cyclic shift is
//    on pass B's loads, where a partly used sector costs only its fetch.
//  - a thread holds several elements of a sweep at a time, first + e * 512,
//    and starts the loads of one plane for all of them before it uses any:
//    that many times the bytes in flight a thread, at 64 registers and 2
//    blocks of 512 threads an SM.
//  - phi of a bf16 value comes from a table.  A magnitude clamped to
//    [1e-9, 60] has 36 bf16 exponents x 128 mantissas = 4,608 values; each
//    block fills an f32 table of them (18,432 B of shared memory) with the
//    same phi() it calls elsewhere, so a look-up is bit-equal to the call.
//    Pass A's phi(|v2c|) and pass B's are look-ups; one precise phi a
//    message is left (the extrinsic's, of an f32 argument).
//  - there is no set-up sweep over the planes.  Every first message of
//    variable j is bf16(prior_c[j]), so the first pass A reads no plane, and
//    the set-up forms the first accumulators from w look-ups a check
//    (decode) or, under the FER step's one constant prior, from one number a
//    frame: there the first extrinsic has one magnitude and only its sign
//    (the syndrome bit) depends on the data, so the first pass A evaluates
//    no phi at all.
//  - the sign parity rides in the accumulator's sign bit: one 4-byte gather
//    a message in pass A where a separate parity plane would add a second.
// Times on the card, and what bounds the kernel now, are in PERF.md.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 60.0f;
constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxW = 64;
constexpr int kElemsB = 6;     // elements of pass B a thread holds at a time
constexpr int kMaxElemsA = 4;  // pass A's are chosen at the launch, 1 to 4
// The phi table: bf16 magnitudes (the low 15 bits) from 2^-30 = 0x3080, the
// first of the exponent that holds 1e-9, to the last of the exponent that
// holds 60.0 = 0x4270.  phi() clamps, so the entries under 1e-9 hold
// phi(1e-9) and those above 60 hold phi(60); magnitudes outside the table
// take its first or last entry.
constexpr int kTabLo = 0x3080;
constexpr int kTabSize = 36 * 128;

__device__ __forceinline__ float phi(float x) {
  x = fminf(fmaxf(x, 1e-9f), kBig);
  return -logf(tanhf(0.5f * x));
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_value(uint32_t bits) { return __uint_as_float(bits << 16); }

// value < 0: the sign bit and a magnitude other than zero
__device__ __forceinline__ int bf16_negative(uint32_t bits) { return bits > 0x8000u; }

__device__ __forceinline__ int tab_index(uint32_t bits) {
  return min(max(static_cast<int>(bits & 0x7FFFu) - kTabLo, 0), kTabSize - 1);
}

__device__ __forceinline__ void fill_table(float* tab) {
  for (int e = threadIdx.x; e < kTabSize; e += blockDim.x) tab[e] = phi(bf16_value(kTabLo + e));
}

// the accumulator with the sign parity in its sign bit
__device__ __forceinline__ float pack_acc(float ph, int neg) {
  return __uint_as_float((__float_as_uint(ph) & 0x7FFFFFFFu) | (static_cast<uint32_t>(neg) << 31));
}

__device__ __forceinline__ float signed_ext(float mag, int neg) { return neg ? -mag : mag; }

// kElemsA: the elements of pass A a thread holds at a time (the launch
// picks it so that the extrinsics of a chunk fit in shared memory).
template <bool kFer, int kElemsA>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) circulant_lean_kernel(
    const float* __restrict__ prior_c, const float* __restrict__ prior_i, float prior_const,
    const uint8_t* __restrict__ errors,  // [B, 2N] true errors (FER step)
    uint8_t* __restrict__ syn,           // [B, N] syndrome (written here for the FER step)
    const int* __restrict__ shifts, int w, int n, int ld, int max_iter,
    uint16_t* __restrict__ v2c, float* __restrict__ acc,
    uint8_t* __restrict__ e_out,  // [B, 2N] decisions
    uint8_t* __restrict__ conv_out, uint8_t* __restrict__ ok_out, int* __restrict__ iters_out) {
  __shared__ float tab_s[kTabSize];
  __shared__ int k_s[kMaxW];
  extern __shared__ uint16_t ext_s[];  // [w][kElemsA][kThreads] bf16: a chunk's extrinsics in pass A
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t fn = static_cast<size_t>(b) * n;
  for (int t = tid; t < w; t += kThreads) k_s[t] = shifts[t];
  fill_table(tab_s);

  const float* pc_b = kFer ? nullptr : prior_c + fn;
  const float* pi_b = kFer ? nullptr : prior_i + fn;
  uint16_t* v2c_b = v2c + static_cast<size_t>(b) * w * ld;
  float* acc_b = acc + fn;
  uint8_t* syn_b = syn + fn;
  uint8_t* e_b = e_out + 2 * fn;
  const uint8_t* err_b = kFer ? errors + 2 * fn : nullptr;
  __syncthreads();

  // The FER step's constants: every first message is bf16(prior_const), so
  // the first accumulator is one sum (in the order the planes would give
  // it), and the first extrinsics have one magnitude each.
  const int neg_pc = prior_const < 0.0f;
  float phi_pc = 0.0f, acc0 = 0.0f, ext0 = 0.0f, ext_i0 = 0.0f;
  int neg0 = 0, neg_v0 = 0;
  if (kFer) {
    const uint32_t v0 = bf16_bits(prior_const);
    const float ph0 = tab_s[tab_index(v0)];
    neg_v0 = bf16_negative(v0);
    phi_pc = phi(fabsf(prior_const));
    acc0 = phi_pc;
    for (int t = 0; t < w; ++t) acc0 += ph0;
    neg0 = neg_pc ^ (neg_v0 & w & 1);  // without the syndrome bit
    ext0 = phi(fmaxf(acc0 - ph0, 1e-9f));
    ext_i0 = phi(fmaxf(acc0 - phi_pc, 1e-9f));
  }

  // Set-up sweep over checks i.  FER step: the syndrome of the true errors.
  // Decode: the first accumulators from the table, and no plane.  Both: the
  // channel hard decisions as the outputs.
  for (int i = tid; i < n; i += kThreads) {
    if (kFer) {
      int s = err_b[n + i];
      for (int t = 0; t < w; ++t) {
        int j = i - k_s[t];
        j += (j < 0) ? n : 0;
        s += err_b[j];
      }
      syn_b[i] = static_cast<uint8_t>(s & 1);
      e_b[i] = static_cast<uint8_t>(neg_pc);
      e_b[n + i] = static_cast<uint8_t>(neg_pc);
    } else {
      const float p_i = pi_b[i];
      float ph = phi(fabsf(p_i));
      int neg = static_cast<int>(p_i < 0.0f) ^ syn_b[i];
      for (int t = 0; t < w; ++t) {
        int j = i - k_s[t];
        j += (j < 0) ? n : 0;
        const uint32_t v = bf16_bits(pc_b[j]);
        ph += tab_s[tab_index(v)];
        neg ^= bf16_negative(v);
      }
      acc_b[i] = pack_acc(ph, neg);
      e_b[i] = pc_b[i] < 0.0f;
      e_b[n + i] = p_i < 0.0f;
    }
  }
  __syncthreads();

  int it = 0;
  bool conv = false;
  while (it < max_iter && !conv) {
    const bool first = it == 0;
    // ---- pass A over variables j, a chunk of kElemsA * kThreads at a time.
    // An element past n (the last chunk's tail) reads element 0 and stores
    // nothing.  First the extrinsics: plane t's at check (j + k_t), from
    // acc there and the message v2c[t][j]; its bf16 form goes to shared
    // memory and its f32 form into the total.
    for (int first_j = tid; first_j < n; first_j += kElemsA * kThreads) {
      float s[kElemsA];
#pragma unroll
      for (int e = 0; e < kElemsA; ++e) {
        const int j = first_j + e * kThreads;
        s[e] = kFer ? prior_const : pc_b[j < n ? j : 0];
      }
      if (first && kFer) {
        // one magnitude; the sign is the check's parity: no phi, no plane read
        const float ext_pos = signed_ext(ext0, neg0 ^ neg_v0), ext_neg = -ext_pos;
        const uint16_t bits_pos = static_cast<uint16_t>(bf16_bits(ext_pos));
        const uint16_t bits_neg = static_cast<uint16_t>(bf16_bits(ext_neg));
#pragma unroll 2
        for (int t = 0; t < w; ++t) {
          const int k = k_s[t];
          int flip[kElemsA];
#pragma unroll
          for (int e = 0; e < kElemsA; ++e) {
            const int j = first_j + e * kThreads;
            int c = (j < n ? j : 0) + k;
            c -= (c >= n) ? n : 0;
            flip[e] = syn_b[c];
          }
#pragma unroll
          for (int e = 0; e < kElemsA; ++e) {
            ext_s[(t * kElemsA + e) * kThreads + tid] = flip[e] ? bits_neg : bits_pos;
            s[e] += flip[e] ? ext_neg : ext_pos;
          }
        }
      } else if (!kFer && first) {
        // the message of variable j is bf16(prior_c[j]) on every plane: no plane read
        float ph_v[kElemsA];
        int neg_v = 0;
#pragma unroll
        for (int e = 0; e < kElemsA; ++e) {
          const uint32_t v = bf16_bits(s[e]);
          ph_v[e] = tab_s[tab_index(v)];
          neg_v |= bf16_negative(v) << e;
        }
#pragma unroll 2
        for (int t = 0; t < w; ++t) {
          const int k = k_s[t];
          float a[kElemsA];
#pragma unroll
          for (int e = 0; e < kElemsA; ++e) {
            const int j = first_j + e * kThreads;
            int c = (j < n ? j : 0) + k;
            c -= (c >= n) ? n : 0;
            a[e] = acc_b[c];
          }
#pragma unroll
          for (int e = 0; e < kElemsA; ++e) {
            const float ext = signed_ext(phi(fmaxf(fabsf(a[e]) - ph_v[e], 1e-9f)),
                                         (__float_as_uint(a[e]) >> 31) ^ ((neg_v >> e) & 1));
            ext_s[(t * kElemsA + e) * kThreads + tid] = static_cast<uint16_t>(bf16_bits(ext));
            s[e] += ext;
          }
        }
      } else {
#pragma unroll 2
        for (int t = 0; t < w; ++t) {
          const int k = k_s[t];
          const uint16_t* row = v2c_b + static_cast<size_t>(t) * ld;
          uint32_t v[kElemsA];
          float a[kElemsA];
#pragma unroll
          for (int e = 0; e < kElemsA; ++e) {
            const int j = first_j + e * kThreads;
            const int jj = j < n ? j : 0;
            int c = jj + k;
            c -= (c >= n) ? n : 0;
            v[e] = row[jj];
            a[e] = acc_b[c];
          }
#pragma unroll
          for (int e = 0; e < kElemsA; ++e) {
            const float ext = signed_ext(phi(fmaxf(fabsf(a[e]) - tab_s[tab_index(v[e])], 1e-9f)),
                                         (__float_as_uint(a[e]) >> 31) ^ bf16_negative(v[e]));
            ext_s[(t * kElemsA + e) * kThreads + tid] = static_cast<uint16_t>(bf16_bits(ext));
            s[e] += ext;
          }
        }
      }
      // Then, with the totals complete, the next messages in place:
      // v2c[t][j] = bf16(clip(tot[j] - bf16 extrinsic)), and the decisions.
      for (int t = 0; t < w; ++t) {
        uint16_t* row = v2c_b + static_cast<size_t>(t) * ld;
#pragma unroll
        for (int e = 0; e < kElemsA; ++e) {
          const int j = first_j + e * kThreads;
          const float ext = bf16_value(ext_s[(t * kElemsA + e) * kThreads + tid]);
          if (j < n) row[j] = static_cast<uint16_t>(bf16_bits(fminf(fmaxf(s[e] - ext, -kBig), kBig)));
        }
      }
#pragma unroll
      for (int e = 0; e < kElemsA; ++e) {
        const int j = first_j + e * kThreads;
        if (j < n) e_b[j] = s[e] < 0.0f;
      }
    }
    __syncthreads();

    // ---- pass B over checks i: the identity extrinsic and decision, the
    // syndrome of the decisions, and the next accumulators from the messages
    // v2c[t][(i - k_t) mod N] in plane order.  It writes no plane.
    int bad = 0;
    for (int first_i = tid; first_i < n; first_i += kElemsB * kThreads) {
      float ph[kElemsB];
      int bits[kElemsB];  // bit 0: the sign parity, bit 1: the decisions' parity, bit 2: the syndrome
#pragma unroll
      for (int e = 0; e < kElemsB; ++e) {
        const int i = first_i + e * kThreads;
        const int ii = i < n ? i : 0;
        const int s = syn_b[ii];
        const float p_i = kFer ? prior_const : pi_b[ii];
        const float phi_i = kFer ? phi_pc : phi(fabsf(p_i));
        const int neg_pi = p_i < 0.0f;
        float ext_i;
        int neg_acc;
        if (first && kFer) {
          ext_i = ext_i0;
          neg_acc = neg0 ^ s;
        } else {
          const float a = acc_b[ii];
          ext_i = phi(fmaxf(fabsf(a) - phi_i, 1e-9f));
          neg_acc = __float_as_uint(a) >> 31;
        }
        const int e_i = (p_i + signed_ext(ext_i, neg_acc ^ neg_pi)) < 0.0f;
        if (i < n) e_b[n + i] = static_cast<uint8_t>(e_i);
        ph[e] = phi_i;
        bits[e] = (neg_pi ^ s) | (e_i << 1) | (s << 2);
      }
      for (int t = 0; t < w; ++t) {
        const int k = k_s[t];
        const uint16_t* row = v2c_b + static_cast<size_t>(t) * ld;
        uint32_t v[kElemsB];
        int dec[kElemsB];
#pragma unroll
        for (int e = 0; e < kElemsB; ++e) {
          const int i = first_i + e * kThreads;
          int j = (i < n ? i : 0) - k;
          j += (j < 0) ? n : 0;
          v[e] = row[j];
          dec[e] = e_b[j];
        }
#pragma unroll
        for (int e = 0; e < kElemsB; ++e) {
          ph[e] += tab_s[tab_index(v[e])];
          bits[e] ^= bf16_negative(v[e]) | (dec[e] << 1);
        }
      }
#pragma unroll
      for (int e = 0; e < kElemsB; ++e) {
        const int i = first_i + e * kThreads;
        if (i < n) {
          acc_b[i] = pack_acc(ph[e], bits[e] & 1);
          bad |= ((bits[e] >> 1) ^ (bits[e] >> 2)) & 1;
        }
      }
    }
    conv = __syncthreads_or(bad) == 0;
    ++it;
  }

  if (tid == 0) {
    conv_out[b] = conv;
    if (iters_out) iters_out[b] = it;
  }
  if (kFer) {  // success = decisions equal the true errors
    int bad = 0;
    for (int j = tid; j < 2 * n; j += kThreads) bad |= e_b[j] != err_b[j];
    bad = __syncthreads_or(bad);
    if (tid == 0) ok_out[b] = !bad;
  }
}

// Every bf16 bit pattern through the table a block builds, beside the direct
// call: tab_out[v] = table[tab_index(v)], direct_out[v] = phi(|value of v|).
__global__ void __launch_bounds__(kThreads) phi_table_kernel(float* __restrict__ tab_out,
                                                             float* __restrict__ direct_out) {
  __shared__ float tab_s[kTabSize];
  fill_table(tab_s);
  __syncthreads();
  for (uint32_t v = threadIdx.x; v < 65536u; v += blockDim.x) {
    tab_out[v] = tab_s[tab_index(v)];
    direct_out[v] = phi(fabsf(bf16_value(v)));
  }
}

template <bool kFer, int kElemsA>
cudaError_t launch(int batch, int smem_bytes, cudaStream_t stream, const float* prior_c, const float* prior_i,
                   float prior, const uint8_t* errors, uint8_t* syn, const int* shifts, int w, int n, int ld,
                   int max_iter, void* v2c, float* acc, uint8_t* e_out, uint8_t* conv_out, uint8_t* ok_out,
                   int* iters_out) {
  auto kernel = circulant_lean_kernel<kFer, kElemsA>;
  const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc != cudaSuccess) return rc;
  kernel<<<batch, kThreads, smem_bytes, stream>>>(prior_c, prior_i, prior, errors, syn, shifts, w, n, ld, max_iter,
                                                  static_cast<uint16_t*>(v2c), acc, e_out, conv_out, ok_out,
                                                  iters_out);
  return cudaGetLastError();
}

// elems: pass A's elements a thread; smem_bytes: the dynamic shared memory,
// which must hold w * elems * kThreads bf16 extrinsics.
template <bool kFer>
int dispatch(int elems, int smem_bytes, int batch, void* stream_ptr, const float* prior_c, const float* prior_i,
             float prior, const uint8_t* errors, uint8_t* syn, const int* shifts, int w, int n, int ld, int max_iter,
             void* v2c, float* acc, uint8_t* e_out, uint8_t* conv_out, uint8_t* ok_out, int* iters_out) {
  if (w < 1 || w > kMaxW || n < 1 || ld < n || batch < 0 || max_iter < 0 || elems < 1 || elems > kMaxElemsA ||
      smem_bytes < 2 * w * elems * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define LEAN_LAUNCH(E)                                                                                          \
  case E:                                                                                                       \
    return static_cast<int>(launch<kFer, E>(batch, smem_bytes, stream, prior_c, prior_i, prior, errors, syn,   \
                                            shifts, w, n, ld, max_iter, v2c, acc, e_out, conv_out, ok_out,     \
                                            iters_out))
  switch (elems) {
    LEAN_LAUNCH(1);
    LEAN_LAUNCH(2);
    LEAN_LAUNCH(3);
    default:
      LEAN_LAUNCH(4);
  }
#undef LEAN_LAUNCH
}

template <bool kFer>
int occupancy(int elems, int smem_bytes) {
  int blocks = 0;
  cudaError_t rc = cudaErrorInvalidValue;
#define LEAN_OCCUPANCY(E)                                                                                         \
  case E:                                                                                                         \
    rc = cudaFuncSetAttribute(circulant_lean_kernel<kFer, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,       \
                              smem_bytes);                                                                        \
    if (rc == cudaSuccess) {                                                                                      \
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, circulant_lean_kernel<kFer, E>, kThreads,      \
                                                         smem_bytes);                                             \
    }                                                                                                             \
    break
  switch (elems) {
    LEAN_OCCUPANCY(1);
    LEAN_OCCUPANCY(2);
    LEAN_OCCUPANCY(3);
    LEAN_OCCUPANCY(4);
  }
#undef LEAN_OCCUPANCY
  return rc == cudaSuccess ? blocks : -static_cast<int>(rc);
}

}  // namespace

// Decode API (replaces circulant_bp_pallas_lean), product-sum.  prior_c,
// prior_i [B, N] f32; syndrome [B, N] 0/1; shifts [w] int32 in [0, N).
// elems and smem_bytes: the launch configuration (pass A's elements a thread,
// 1 to 4, and the dynamic shared memory for their extrinsics).  Scratch v2c
// [B, w, ld] bf16 (plane rows at the stride ld >= N) and acc [B, N] f32 need
// no initialisation.  Out: e [B, 2N] 0/1, conv [B], iters [B] (may be null).
// Returns a cudaError_t.
extern "C" int circulant_bp_lean_decode(const float* prior_c, const float* prior_i, uint8_t* syndrome,
                                        const int* shifts, int w, int n, int ld, int batch, int max_iter, int elems,
                                        int smem_bytes, void* v2c, float* acc, uint8_t* e_out, uint8_t* conv_out,
                                        int* iters_out, void* stream) {
  if (prior_c == nullptr || prior_i == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(elems, smem_bytes, batch, stream, prior_c, prior_i, 0.0f, nullptr, syndrome, shifts, w, n,
                         ld, max_iter, v2c, acc, e_out, conv_out, nullptr, iters_out);
}

// FER step (replaces circulant_fer_pallas_lean): errors [B, 2N] 0/1 in; the
// syndrome (scratch syn [B, N]) and the decisions (scratch e [B, 2N]) are
// formed on the card; out: ok [B] (decisions equal the errors), conv [B] and
// iters [B] (may be null).
extern "C" int circulant_fer_lean_step(const uint8_t* errors, float prior, const int* shifts, int w, int n,
                                       int ld, int batch, int max_iter, int elems, int smem_bytes, void* v2c,
                                       float* acc, uint8_t* syn, uint8_t* e_scratch, uint8_t* ok_out,
                                       uint8_t* conv_out, int* iters_out, void* stream) {
  if (errors == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(elems, smem_bytes, batch, stream, nullptr, nullptr, prior, errors, syn, shifts, w, n, ld,
                        max_iter, v2c, acc, e_scratch, conv_out, ok_out, iters_out);
}

// tab_out, direct_out [65536] f32, indexed by a bf16's bits: the table's
// entry for it and the direct phi of its magnitude.
extern "C" int circulant_lean_phi_table(float* tab_out, float* direct_out, void* stream) {
  phi_table_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(tab_out, direct_out);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the decode (fer = 0) or FER-step (fer = 1)
// instance for elems elements a thread and smem_bytes of dynamic shared
// memory, from the occupancy calculator; a negative cudaError_t on failure.
extern "C" int circulant_lean_occupancy(int fer, int elems, int smem_bytes) {
  return fer ? occupancy<true>(elems, smem_bytes) : occupancy<false>(elems, smem_bytes);
}
