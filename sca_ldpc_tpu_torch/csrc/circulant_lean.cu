// Lean syndrome belief propagation on H = [circulant(N, w) | I_N] with bf16
// message planes, one frame per thread block, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in sca_ldpc_tpu/ops/kernels/circulant_pallas.py:
//   circulant_bp_pallas_lean  (body _make_lean_kernel)      -> circulant_bp_lean_decode()
//   circulant_fer_pallas_lean (body _make_lean_fer_kernel)  -> circulant_fer_lean_step()
// in their default form (shifts as data, one plane per group), and computes
// what they compute, rounding point for rounding point: product-sum only;
// the v2c and c2v planes are stored in bf16 (round to nearest even, as
// JAX's astype); the check accumulators (phi sum, sign product) are rebuilt
// from the stored bf16 planes; the variable totals add the f32 extrinsics
// in plane order; v2c is clipped at +-60 after the first iteration.  The
// plain PyTorch version is circulant_bp_lean_plain in
// ops/kernels/circulant_cuda.py.
// The TPU kernel's lane padding (m > n) exists only for Mosaic's rolls and
// has no counterpart: a cyclic shift here is index arithmetic on the load.
//
// State of one frame, in device memory (HBM, cached in L2):
//   v2c, c2v [w, N] bf16    variable-to-check and check-to-variable planes,
//                           plane t at check i <-> variable (i - k_t) mod N
//   acc_phi  [N]    f32     per check: phi(|prior_i|) + sum_t phi(|v2c[t]|)
//   acc_neg  [N]    u8      per check: parity of the negative incoming
//                           messages and the syndrome bit (the sign product)
//   tot      [N]    f32     variable totals
// Per iteration a block makes two sweeps, with __syncthreads() between:
//   pass A over variables j: for t in order, the extrinsic of plane t at
//     check c = (j + k_t) mod N from acc_*[c] and v2c[t][c] (a bijection,
//     so no atomics); store c2v[t][c] = bf16(ext) and add the f32 ext to
//     tot[j]; the decision tot[j] < 0.
//   pass B over checks i: the identity extrinsic and decision, then for t
//     in order v2c[t][i] = bf16(clip(tot[(i - k_t) mod N] - c2v[t][i])),
//     the syndrome of the decisions (the sign of the same tot loads) and the
//     next iteration's acc_*[i] from the bf16 values just written; the
//     convergence test reduces with __syncthreads_or.
// A converged frame stops, and its block frees the SM for the next frame.
//
// Bound on the H100: device-memory bandwidth.  Per message and iteration:
// pass A reads v2c and writes c2v (2 + 2 B) and gathers acc_phi and acc_neg
// (4 + 1 B); pass B gathers tot (4 B), reads c2v and writes v2c (2 + 2 B):
// 8 B of planes plus 9 B of gathers, which hit L2 where a frame's 9 B x N
// of accumulators stays resident.  K2 (circulant_bp.cu) moves 12 B of f32
// planes per message plus 8 B of tot gathers (check and syndrome sweeps).
// Pass A evaluates phi twice per message and pass B once (K2: twice).
// 40 registers a thread allow 3 blocks of 512 threads per SM (K2: 2 of 256).
// On an H100 at HQC-256 (N = 57,637, w = 30, batch 2048) an iteration takes
// 34.5 ms against K2's 59.4 ms; the set-up sweep, which writes every plane
// once, 11.0 ms against 3.9 ms (PERF.md).
// Math is f32 with logf/tanhf (no fast-math: it changes phi near its ends).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 60.0f;
constexpr int kThreads = 512;
constexpr int kMaxW = 64;

__device__ __forceinline__ float phi(float x) {
  x = fminf(fmaxf(x, 1e-9f), kBig);
  return -logf(tanhf(0.5f * x));
}

__global__ void __launch_bounds__(kThreads) circulant_lean_kernel(
    const float* __restrict__ prior_c, const float* __restrict__ prior_i, float prior_const,
    const uint8_t* __restrict__ errors,  // [B, 2N] true errors (FER step) or nullptr
    uint8_t* __restrict__ syn,           // [B, N] syndrome (written here for the FER step)
    const int* __restrict__ shifts, int w, int n, int max_iter,
    __nv_bfloat16* __restrict__ v2c, __nv_bfloat16* __restrict__ c2v,
    float* __restrict__ acc_phi, uint8_t* __restrict__ acc_neg, float* __restrict__ tot,
    uint8_t* __restrict__ e_out,  // [B, 2N] decisions
    uint8_t* __restrict__ conv_out, uint8_t* __restrict__ ok_out, int* __restrict__ iters_out) {
  __shared__ int k_s[kMaxW];
  const int b = blockIdx.x;
  const size_t fn = static_cast<size_t>(b) * n;
  for (int t = threadIdx.x; t < w; t += blockDim.x) k_s[t] = shifts[t];

  const float* pc_b = prior_c ? prior_c + fn : nullptr;
  const float* pi_b = prior_i ? prior_i + fn : nullptr;
  __nv_bfloat16* v2c_b = v2c + fn * w;
  __nv_bfloat16* c2v_b = c2v + fn * w;
  float* phi_b = acc_phi + fn;
  uint8_t* neg_b = acc_neg + fn;
  float* tot_b = tot + fn;
  uint8_t* syn_b = syn + fn;
  uint8_t* e_b = e_out + 2 * fn;
  const uint8_t* err_b = errors ? errors + 2 * fn : nullptr;
  __syncthreads();

  // Set-up sweep over checks i: the FER step's syndrome of the true errors,
  // the unclipped rolled prior as the first v2c planes, the first check
  // accumulators, and the channel hard decisions as the outputs.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int s;
    if (err_b) {
      s = err_b[n + i];
      for (int t = 0; t < w; ++t) {
        int j = i - k_s[t];
        j += (j < 0) ? n : 0;
        s += err_b[j];
      }
      s &= 1;
      syn_b[i] = static_cast<uint8_t>(s);
    } else {
      s = syn_b[i];
    }
    const float p_i = pi_b ? pi_b[i] : prior_const;
    float ph = phi(fabsf(p_i));
    int neg = static_cast<int>(p_i < 0.0f) ^ s;
    for (int t = 0; t < w; ++t) {
      int j = i - k_s[t];
      j += (j < 0) ? n : 0;
      const __nv_bfloat16 v = __float2bfloat16_rn(pc_b ? pc_b[j] : prior_const);
      v2c_b[static_cast<size_t>(t) * n + i] = v;
      const float vf = __bfloat162float(v);
      ph += phi(fabsf(vf));
      neg ^= static_cast<int>(vf < 0.0f);
    }
    phi_b[i] = ph;
    neg_b[i] = static_cast<uint8_t>(neg);
    e_b[i] = (pc_b ? pc_b[i] : prior_const) < 0.0f;
    e_b[n + i] = p_i < 0.0f;
  }
  __syncthreads();

  int it = 0;
  bool conv = false;
  while (it < max_iter && !conv) {
    // ---- pass A over variables j
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float s = pc_b ? pc_b[j] : prior_const;
      for (int t = 0; t < w; ++t) {
        int c = j + k_s[t];
        c -= (c >= n) ? n : 0;
        const size_t at = static_cast<size_t>(t) * n + c;
        const float plane = __bfloat162float(v2c_b[at]);
        float ext = phi(fmaxf(phi_b[c] - phi(fabsf(plane)), 1e-9f));
        if (neg_b[c] ^ static_cast<uint8_t>(plane < 0.0f)) ext = -ext;
        c2v_b[at] = __float2bfloat16_rn(ext);
        s += ext;
      }
      tot_b[j] = s;
      e_b[j] = s < 0.0f;
    }
    __syncthreads();

    // ---- pass B over checks i
    int bad = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float p_i = pi_b ? pi_b[i] : prior_const;
      const float phi_i = phi(fabsf(p_i));
      const int neg_pi = p_i < 0.0f;
      float ext_i = phi(fmaxf(phi_b[i] - phi_i, 1e-9f));
      if (neg_b[i] ^ neg_pi) ext_i = -ext_i;
      const int e_i = (p_i + ext_i) < 0.0f;
      e_b[n + i] = static_cast<uint8_t>(e_i);
      const int s = syn_b[i];
      int parity = e_i;
      float ph = phi_i;
      int neg = neg_pi ^ s;
      for (int t = 0; t < w; ++t) {
        int j = i - k_s[t];
        j += (j < 0) ? n : 0;
        const float rolled = tot_b[j];
        const size_t at = static_cast<size_t>(t) * n + i;
        const __nv_bfloat16 v =
            __float2bfloat16_rn(fminf(fmaxf(rolled - __bfloat162float(c2v_b[at]), -kBig), kBig));
        v2c_b[at] = v;
        const float vf = __bfloat162float(v);
        parity ^= static_cast<int>(rolled < 0.0f);
        ph += phi(fabsf(vf));
        neg ^= static_cast<int>(vf < 0.0f);
      }
      phi_b[i] = ph;
      neg_b[i] = static_cast<uint8_t>(neg);
      bad |= parity != s;
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

int launch(int batch, void* stream_ptr, const float* prior_c, const float* prior_i, float prior_const,
           const uint8_t* errors, uint8_t* syn, const int* shifts, int w, int n, int max_iter, void* v2c,
           void* c2v, float* acc_phi, uint8_t* acc_neg, float* tot, uint8_t* e_out, uint8_t* conv_out,
           uint8_t* ok_out, int* iters_out) {
  if (w < 1 || w > kMaxW || n < 1 || batch < 0 || max_iter < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  circulant_lean_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      prior_c, prior_i, prior_const, errors, syn, shifts, w, n, max_iter, static_cast<__nv_bfloat16*>(v2c),
      static_cast<__nv_bfloat16*>(c2v), acc_phi, acc_neg, tot, e_out, conv_out, ok_out, iters_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Decode API (replaces circulant_bp_pallas_lean), product-sum.  prior_c,
// prior_i [B, N] f32; syndrome [B, N] 0/1; shifts [w] int32 in [0, N).
// Scratch v2c, c2v [B, w, N] bf16, acc_phi [B, N] f32, acc_neg [B, N] u8 and
// tot [B, N] f32 need no initialisation.  Out: e [B, 2N] 0/1, conv [B],
// iters [B] (may be null).  Returns a cudaError_t.
extern "C" int circulant_bp_lean_decode(const float* prior_c, const float* prior_i, uint8_t* syndrome,
                                        const int* shifts, int w, int n, int batch, int max_iter, void* v2c,
                                        void* c2v, float* acc_phi, uint8_t* acc_neg, float* tot, uint8_t* e_out,
                                        uint8_t* conv_out, int* iters_out, void* stream) {
  if (prior_c == nullptr || prior_i == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(batch, stream, prior_c, prior_i, 0.0f, nullptr, syndrome, shifts, w, n, max_iter, v2c, c2v,
                acc_phi, acc_neg, tot, e_out, conv_out, nullptr, iters_out);
}

// FER step (replaces circulant_fer_pallas_lean): errors [B, 2N] 0/1 in; the
// syndrome (scratch syn [B, N]) and the decisions (scratch e [B, 2N]) are
// formed on the card; out: ok [B] (decisions equal the errors) and conv [B].
extern "C" int circulant_fer_lean_step(const uint8_t* errors, float prior, const int* shifts, int w, int n,
                                       int batch, int max_iter, void* v2c, void* c2v, float* acc_phi,
                                       uint8_t* acc_neg, float* tot, uint8_t* syn, uint8_t* e_scratch,
                                       uint8_t* ok_out, uint8_t* conv_out, void* stream) {
  if (errors == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(batch, stream, nullptr, nullptr, prior, errors, syn, shifts, w, n, max_iter, v2c, c2v, acc_phi,
                acc_neg, tot, e_scratch, conv_out, ok_out, nullptr);
}
