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
// Design.  The TPU kernel keeps a tile of frames in VMEM for all iterations.
// A Hopper SM has 227 KB of shared memory, and one HQC-128 frame's message
// state is 20 planes x 17,669 x 4 B = 1.4 MB, so in this first form the
// planes stay in device memory (HBM, cached in L2):
//   c2v [B, w, N] f32  check-to-variable messages, updated in place
//   tot [B, N]    f32  variable totals prior + sum of incoming c2v
// v2c is never stored: v2c[t][i] = clip(tot[(i - k_t) mod N] - c2v[t][i]),
// the identity behind circulant_pallas.py:152-157, which halves the state the
// TPU kernel keeps.  The first iteration reads the unclipped prior instead.
// One block walks its frame through the iterations, so a converged frame
// stops on its own and the block frees its SM for the next frame.
//
// Per iteration a block makes three sweeps with __syncthreads() between them:
//   check sweep    over checks i: rebuild the w+1 incoming messages (plane t
//                  from variable (i - k_t) mod N, the identity plane from its
//                  constant prior), write each extrinsic c2v[t][i] in place,
//                  and the identity variable's decision;
//   variable sweep over variables j: tot[j] = prior + sum_t c2v[t][(j + k_t) mod N];
//   check of the syndrome of the decisions against the input syndrome,
//                  reduced with __syncthreads_or.
// Cyclic shifts are index arithmetic on the load; the shifts are runtime data,
// so one build serves every N and w <= 64.
//
// Bound on the H100: device-memory bandwidth.  Per variable and iteration the
// check sweep reads and writes w c2v words and the variable sweep reads them
// again: about (3w + 1) x 4 B, 244 B at w = 20.  The gathers of tot (70 KB a
// frame) mostly hit L1/L2.  Math is f32 with logf/tanhf (no fast-math: it
// changes phi near its ends).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 60.0f;
constexpr float kMinSumAlpha = 0.75f;
constexpr int kThreads = 256;
constexpr int kMaxW = 64;

__device__ __forceinline__ float phi(float x) {
  x = fminf(fmaxf(x, 1e-9f), kBig);
  return -logf(tanhf(0.5f * x));
}

struct Frame {
  const float* prior_c;  // [N] or nullptr: constant prior
  const float* prior_i;  // [N] or nullptr: constant prior
  float prior_const;
  __device__ __forceinline__ float pc(int j) const { return prior_c ? prior_c[j] : prior_const; }
  __device__ __forceinline__ float pi(int i) const { return prior_i ? prior_i[i] : prior_const; }
};

// MAXW: compile-time bound on w, so the per-check message arrays live in
// registers.  MIN_SUM: normalized min-sum, else product-sum.
template <int MAXW, bool MIN_SUM>
__global__ void __launch_bounds__(kThreads) circulant_bp_kernel(
    const float* __restrict__ prior_c, const float* __restrict__ prior_i, float prior_const,
    const uint8_t* __restrict__ errors,  // [B, 2N] true errors (FER step) or nullptr
    uint8_t* __restrict__ syn,           // [B, N] syndrome (written here for the FER step)
    const int* __restrict__ shifts, int w, int n, int max_iter, bool with_id,
    float* __restrict__ c2v, float* __restrict__ tot,
    uint8_t* __restrict__ e_out,  // [B, 2N] decisions ([B, N] without the identity)
    uint8_t* __restrict__ conv_out, uint8_t* __restrict__ ok_out, int* __restrict__ iters_out) {
  __shared__ int k_s[MAXW];
  const int b = blockIdx.x;
  const size_t fn = static_cast<size_t>(b) * n;
  for (int t = threadIdx.x; t < w; t += blockDim.x) k_s[t] = shifts[t];

  Frame f{prior_c ? prior_c + fn : nullptr, prior_i ? prior_i + fn : nullptr, prior_const};
  float* c2v_b = c2v + fn * w;
  float* tot_b = tot + fn;
  uint8_t* syn_b = syn + fn;
  uint8_t* e_b = e_out + (with_id ? 2 : 1) * fn;
  const uint8_t* err_b = errors ? errors + 2 * fn : nullptr;
  __syncthreads();

  // Set-up: the FER step forms the syndrome of the true errors; outputs
  // start as the channel hard decisions.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (err_b) {
      int s = err_b[n + i];
      for (int t = 0; t < w; ++t) {
        int j = i - k_s[t];
        j += (j < 0) ? n : 0;
        s += err_b[j];
      }
      syn_b[i] = static_cast<uint8_t>(s & 1);
    }
    e_b[i] = f.pc(i) < 0.0f;
    if (with_id) e_b[n + i] = f.pi(i) < 0.0f;
  }
  __syncthreads();

  int it = 0;
  bool conv = false;
  while (it < max_iter && !conv) {
    const bool first = (it == 0);

    // ---- check sweep
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float m[MAXW];  // phi(|v2c|) (product-sum) or |v2c| (min-sum)
      unsigned long long neg = 0;  // sign bits of the w incoming messages
      const float p_i = with_id ? f.pi(i) : 0.0f;
      const bool neg_i = with_id && p_i < 0.0f;
      int parity = syn_b[i] ^ static_cast<int>(neg_i);
      const float m_i = MIN_SUM ? fabsf(p_i) : phi(fabsf(p_i));
      float acc = 0.0f, min1 = INFINITY, min2 = INFINITY;
      int cnt = 0;
#pragma unroll
      for (int t = 0; t < MAXW; ++t) {
        if (t < w) {
          int j = i - k_s[t];
          j += (j < 0) ? n : 0;
          const float v = first ? f.pc(j)
                                : fminf(fmaxf(tot_b[j] - c2v_b[static_cast<size_t>(t) * n + i], -kBig), kBig);
          const bool ng = v < 0.0f;
          parity ^= static_cast<int>(ng);
          neg |= static_cast<unsigned long long>(ng) << t;
          const float mag = fabsf(v);
          if (MIN_SUM) {
            m[t] = mag;
            if (mag < min1) {
              min2 = min1;
              min1 = mag;
              cnt = 1;
            } else if (mag == min1) {
              ++cnt;
            } else {
              min2 = fminf(min2, mag);
            }
          } else {
            m[t] = phi(mag);
            acc += m[t];
          }
        }
      }
      // the identity plane (degree-1 variable: always its prior)
      if (with_id && MIN_SUM) {
        if (m_i < min1) {
          min2 = min1;
          min1 = m_i;
          cnt = 1;
        } else if (m_i == min1) {
          ++cnt;
        } else {
          min2 = fminf(min2, m_i);
        }
      } else if (with_id) {
        acc += m_i;
      }
#pragma unroll
      for (int t = 0; t < MAXW; ++t) {
        if (t < w) {
          float ext;
          if (MIN_SUM) {
            ext = (m[t] == min1 && cnt == 1) ? min2 : min1;
            ext = kMinSumAlpha * fminf(ext, kBig);
          } else {
            ext = phi(fmaxf(acc - m[t], 1e-9f));
          }
          const bool ng = parity ^ static_cast<int>((neg >> t) & 1ull);
          c2v_b[static_cast<size_t>(t) * n + i] = ng ? -ext : ext;
        }
      }
      if (with_id) {
        float ext_i;
        if (MIN_SUM) {
          ext_i = (m_i == min1 && cnt == 1) ? min2 : min1;
          ext_i = kMinSumAlpha * fminf(ext_i, kBig);
        } else {
          ext_i = phi(fmaxf(acc - m_i, 1e-9f));
        }
        const float tot_i = p_i + ((parity ^ static_cast<int>(neg_i)) ? -ext_i : ext_i);
        e_b[n + i] = tot_i < 0.0f;
      }
    }
    __syncthreads();

    // ---- variable sweep (summation order as in the plain version)
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float s = 0.0f;
      for (int t = 0; t < w; ++t) {
        int i = j + k_s[t];
        i -= (i >= n) ? n : 0;
        s += c2v_b[static_cast<size_t>(t) * n + i];
      }
      const float tj = f.pc(j) + s;
      tot_b[j] = tj;
      e_b[j] = tj < 0.0f;
    }
    __syncthreads();

    // ---- convergence: syndrome of the decisions against the input syndrome
    int bad = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int s = with_id ? e_b[n + i] : 0;
      for (int t = 0; t < w; ++t) {
        int j = i - k_s[t];
        j += (j < 0) ? n : 0;
        s += tot_b[j] < 0.0f;
      }
      bad |= (s & 1) != syn_b[i];
    }
    conv = __syncthreads_or(bad) == 0;
    ++it;
  }

  if (threadIdx.x == 0) {
    conv_out[b] = conv;
    if (iters_out) iters_out[b] = it;
  }
  if (ok_out) {  // FER step: success = decisions equal the true errors
    int bad = 0;
    for (int j = threadIdx.x; j < 2 * n; j += blockDim.x) bad |= e_b[j] != err_b[j];
    bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) ok_out[b] = !bad;
  }
}

template <int MAXW>
void launch_w(bool min_sum, int batch, cudaStream_t stream, const float* prior_c, const float* prior_i,
              float prior_const, const uint8_t* errors, uint8_t* syn, const int* shifts, int w, int n,
              int max_iter, bool with_id, float* c2v, float* tot, uint8_t* e_out, uint8_t* conv_out,
              uint8_t* ok_out, int* iters_out) {
  if (min_sum) {
    circulant_bp_kernel<MAXW, true><<<batch, kThreads, 0, stream>>>(
        prior_c, prior_i, prior_const, errors, syn, shifts, w, n, max_iter, with_id, c2v, tot, e_out, conv_out,
        ok_out, iters_out);
  } else {
    circulant_bp_kernel<MAXW, false><<<batch, kThreads, 0, stream>>>(
        prior_c, prior_i, prior_const, errors, syn, shifts, w, n, max_iter, with_id, c2v, tot, e_out, conv_out,
        ok_out, iters_out);
  }
}

int launch(int method, int batch, void* stream_ptr, const float* prior_c, const float* prior_i,
           float prior_const, const uint8_t* errors, uint8_t* syn, const int* shifts, int w, int n,
           int max_iter, bool with_id, float* c2v, float* tot, uint8_t* e_out, uint8_t* conv_out,
           uint8_t* ok_out, int* iters_out) {
  if (w < 1 || w > kMaxW || n < 1 || batch < 0 || max_iter < 0 || (method != 0 && method != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const bool ms = method == 1;
  auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (w <= 8) {
    launch_w<8>(ms, batch, stream, prior_c, prior_i, prior_const, errors, syn, shifts, w, n, max_iter,
                with_id, c2v, tot, e_out, conv_out, ok_out, iters_out);
  } else if (w <= 16) {
    launch_w<16>(ms, batch, stream, prior_c, prior_i, prior_const, errors, syn, shifts, w, n, max_iter,
                 with_id, c2v, tot, e_out, conv_out, ok_out, iters_out);
  } else if (w <= 32) {
    launch_w<32>(ms, batch, stream, prior_c, prior_i, prior_const, errors, syn, shifts, w, n, max_iter,
                 with_id, c2v, tot, e_out, conv_out, ok_out, iters_out);
  } else {
    launch_w<64>(ms, batch, stream, prior_c, prior_i, prior_const, errors, syn, shifts, w, n, max_iter,
                 with_id, c2v, tot, e_out, conv_out, ok_out, iters_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Decode API (replaces circulant_bp_pallas).  method: 0 product-sum, 1 min-sum.
// prior_c, prior_i [B, N] f32 (prior_i not read without the identity);
// syndrome [B, N] 0/1; shifts [w] int32 in [0, N); with_identity 1 for
// [circulant | I], 0 for the circulant alone.  Scratch c2v [B, w, N] f32 and
// tot [B, N] f32 need no initialisation.  Out: e [B, 2N] 0/1 ([B, N] without
// the identity), conv [B], iters [B] (may be null).  Returns a cudaError_t.
extern "C" int circulant_bp_decode(const float* prior_c, const float* prior_i, uint8_t* syndrome,
                                   const int* shifts, int w, int n, int batch, int max_iter, int method,
                                   int with_identity, float* c2v, float* tot, uint8_t* e_out, uint8_t* conv_out,
                                   int* iters_out, void* stream) {
  if (prior_c == nullptr || prior_i == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(method, batch, stream, prior_c, prior_i, 0.0f, nullptr, syndrome, shifts, w, n, max_iter,
                with_identity != 0, c2v, tot, e_out, conv_out, nullptr, iters_out);
}

// FER step (replaces circulant_fer_pallas): errors [B, 2N] 0/1 in; the
// syndrome (scratch syn [B, N]) and the decisions (scratch e [B, 2N]) are
// formed on the card; out: ok [B] (decisions equal the errors) and conv [B].
extern "C" int circulant_fer_step(const uint8_t* errors, float prior, const int* shifts, int w, int n, int batch,
                                  int max_iter, int method, float* c2v, float* tot, uint8_t* syn,
                                  uint8_t* e_scratch, uint8_t* ok_out, uint8_t* conv_out, void* stream) {
  if (errors == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(method, batch, stream, nullptr, nullptr, prior, errors, syn, shifts, w, n, max_iter, true, c2v,
                tot, e_scratch, conv_out, ok_out, nullptr);
}
