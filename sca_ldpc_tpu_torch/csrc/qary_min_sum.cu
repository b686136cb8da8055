// Q-ary min-sum decoding over symbols [-B..B] (Q = 2B+1), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in sca_ldpc_tpu/ops/kernels/qary_pallas.py:
//   chain_exclusive_pallas     (K5, body _make_check_kernel)         -> qary_chain_exclusive()
//   qary_min_sum_fused         (K6, body _make_fused_kernel)         -> qary_min_sum_fused()
//   qary_special_min_sum_fused (K7, body _make_fused_special_kernel) -> qary_special_min_sum_fused()
// and computes what the port's plain versions compute: ops/minplus.py
// chain_exclusive, ops/qary.py _qary_min_sum and ops/qary_special.py
// _special_min_sum.
//
// Exactness.  A min-plus convolution output is a min over terms a[i] + b[j],
// each one f32 add; min is exact and order-free, so any evaluation order gives
// the same bits as long as the set of terms is the same.  conv_warp() keeps
// minplus.conv's term set exactly: the same operand swap on the declared half
// supports, the same loop window, BIG for b-indices outside b's support, and
// the final min with BIG; chain_check() keeps chain_exclusive's caps.  K6 sums
// a variable's DV incoming messages in the plain version's order,
// channel + ((c_0 + c_1) + c_2), so its totals and hard decisions are bitwise
// those of the plain version too.
//
// K5 design: the chain of every check is independent, so a block walks groups
// of kW warps x kK checks a warp (consecutive checks), stages the group's v2c
// and extra rows in shared memory with coalesced loads, updates each warp's
// checks and writes the group's outputs back with coalesced stores.  Bound
// on the H100: instruction throughput, the add+min pairs whose indices are
// in range (5,787 a check at the medium decoder [*, 150, 7, 15], 213 at Q = 3,
// 1,646 at Kyber eta 2 with the extra operand); each term is two
// shared-memory loads around its add and min.  K6's devices, on K5's caps
// (s_pre = s_out + se, cap_of with s_mid), answer it:
//   - Lanes.  Step t of the prefix chain and step t of the suffix chain run
//     in one pass, a lane on each (check, chain, output); every slot's
//     combine in passes over (check, slot, output) lanes, the slots by
//     falling term window; with the extra operand every slot's combine output
//     to +-s_pre is kept side by side and every slot's extra conv runs in one
//     pass (25 serial steps for 150 at eta 2).  Where one check's passes
//     leave lanes idle, a warp takes 2 or 4 checks (chain_group<kK>).
//   - No bounds test.  Each chain's partials sit between kBig guards whose
//     width the host derives from the shape (a chain step that walks the
//     operand reads cap(t+1) + B - cap(t) past the partial, the combine
//     s_pre + m - M past the wider one; the operands get guards only where a
//     step walks the partial, s_mid < B), so a term whose index leaves its
//     operand reads the kBig that conv_warp's test stands in.
//   - The table.  Caps, offsets, guards, swaps and the slot order come from
//     the host once per shape (qary_cuda.chain_table), by value; no
//     partial_offset loops.
//   - Resident warps.  Instances of 16, 8 and 4 warps a block x 1, 2 and 4
//     checks a warp, 64 registers; the host's chain_launch() picks one from
//     the card's limits.  A shape whose staged block does not fit (or DC >
//     kChainMaxD) takes the per-warp form, the form before (chain_check, one
//     warp a check, 8 a block), so every shape that fitted before fits.
// Each output is still one min over exactly minplus.conv's terms.  Measured
// on an H100 80GB HBM3 at 700 W (tools/qary_forms.py, against the 73cefcb
// form in one process, batch 4096): medium decoder 3.989 -> 1.927 ms, Q = 3
// 2.126 -> 0.269, Kyber eta 2 10.584 -> 3.808, eta 3 13.898 -> 6.350.  The
// bounds test alone cost the old form 23-34%.
//
// K6 design: one block per frame runs every iteration.  v2c [R, DC, Q] (the
// same buffer holds c2v after the check update, as the TPU kernel's VMEM
// scratch does) and tot [N, Q] stay in dynamic shared memory (90 KB at the
// medium decoder), so device memory sees only the channel and the decisions.
// Per iteration, with __syncthreads() between the sweeps:
//   check sweep     one warp per check (fused_check): the K5 chain without
//                   the extra operand, written in place and reversed as
//                   c2v = min(ext[-d], BIG);
//   variable sweep  over (variable, symbol): tot = channel + sum of the
//                   unsigned c2v, gathered through var_flat;
//   edge sweep      one thread per edge: v2c = signed(tot[var]) - c2v, minus
//                   its own minimum, min BIG; pad slots the delta identity.
// The TPU kernel's one-hot matmuls are index gathers here, GF sign reversal
// and pad masking are selects.  Bound on the H100: instruction throughput,
// the check sweep's add+min pairs whose indices are in range (5,787 a check
// at the medium decoder, 8.7e5 a frame-iteration); each term is two
// shared-memory loads around its add and min.  Three things answer it:
//   - Resident warps.  The frame's state, not the warps' scratch, fills
//     shared memory, so a block runs as many warps as the registers allow
//     (32 at 64 a thread) when it fits: an instance for 32, 16 and 8 warps a
//     block, and the host's fused_launch() takes the one whose blocks hold
//     the most warps an SM, the smallest of those that tie (the form before
//     ran 8 warps a block, 16 an SM at the medium decoder; now one block of
//     32 there, four of 8 at Q = 3).  A 4-warp instance, taken only when no
//     larger block fits, keeps the frames of DC >= 6 that outgrew 8 warps
//     with the guards below.
//   - Idle lanes.  Step t of the prefix chain and step t of the suffix chain
//     run in one pass, a lane on each (chain, output), the chains on
//     alternate lanes and their buffers 16 banks apart; the combine outputs
//     of all DC slots run in passes over (slot, output) lanes, the slots in
//     order of falling term window (1, 15, 29, 43, 29, 15, 1 terms at Q = 15)
//     so that a pass's lanes walk alike windows: 254 serial term steps a
//     check for 345 at Q = 15, 23 for 57 at Q = 3.
//   - No bounds test.  Each chain's partials sit between kBig guards of 2B
//     floats, so a term whose index falls outside its operand reads the kBig
//     that conv_warp's test stands in: the same term, without the test.  The
//     partials' offsets and the slot order come from a table made once a
//     block, not from partial_offset loops in every row.
// Each output is still one min over exactly minplus.conv's terms.  Measured
// on an H100 80GB HBM3 at 700 W (tools/qary_forms.py, against the 8-warp
// form before; batch 4096): medium decoder, 10 iterations, 43.3 -> 19.8 ms;
// Q = 3, 5 iterations, 8.3 -> 2.4 ms.  The guards alone are worth 21%.
//
// K7 design: K6's form for the two-alphabet code [H'|I] (Kyber).  One block
// per frame runs every iteration; v2c/c2v [R, SW, QB] and tot_b [NB, QB] of
// the B-variables live in dynamic shared memory (61,440 + 15,360 B at
// Kyber-768, eta = 2), the sum-variable channel and its signed form
// [R, QS] stay in device memory (each row is read once an iteration, from
// L1/L2).  Per iteration:
//   check sweep     one warp per check (special_check): K5's chain with the
//                   row's signed sum channel as the extra operand, written
//                   in place and reversed as c2v;
//   variable sweep  tot_b = channel + ((u_0 + u_1) + ...), through var_flat;
//   edge sweep      as K6 (skipped in the last iteration: nothing reads it).
// The sum totals of a fixed-iteration decode depend only on the v2c at the
// start of the last iteration, so the last check sweep first forms the full
// conv of the row's SW B-messages to +-BSUM (before the chain overwrites
// them), adds the row's sum channel and writes argmin - BSUM out: no tot_s
// buffer.  Bound: as K6, the check sweep's min-plus terms, 2,230 add+min
// pairs a row at Kyber-768 (1.1e6 a frame-iteration), on output windows of
// 5 symbols that leave most of a warp's lanes idle.  Two things answer it:
//   - Resident warps.  The frame's state, not the warps' scratch, fills
//     shared memory (76,800 B at Kyber-768, eta = 2; 107,520 B at eta = 3,
//     QB = 7, QS = 37), so a block runs as many warps as the registers allow
//     (32 at 64 a thread) when it fits: the kernel has an instance for 32,
//     16 and 8 warps a block and the host's special_fused_launch() takes the
//     largest that fits the card's shared memory (one block of 32 warps an SM
//     at Kyber-768, eta 2 and 3; 8 warps before, 16 and 8 warps an SM).
//   - Idle lanes.  A slot's output window is 2B+1 symbols, but its extra
//     conv's term window is 2BSUM+1: walked slot by slot on 2B+1 lanes these
//     convs were 150 of a row's 222 serial term steps at eta = 2.  The combine
//     outputs of all SW slots are kept side by side and every slot's extra
//     conv runs in one pass, a lane on each (slot, output): 25 steps.  Step t
//     of the prefix chain and step t of the suffix chain have the same shapes
//     and run in one pass too (conv_out(), a lane on each (chain, output)).
// Each output is still one min over exactly minplus.conv's terms.  Measured
// on an H100 80GB HBM3 at 700 W (tools/qary_forms.py, against the 8-warp
// form before; 10 iterations, batch 4096): 124.5 -> 57.8 ms at eta = 2,
// 252.2 -> 85.5 ms at eta = 3.  The prefix, suffix and combine walks take
// most of an iteration now, each term a bounds test and two shared-memory
// loads around its add and min.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

// K5's table for one shape: ops/kernels/qary_cuda.py chain_table() makes it on the host, once per shape, and the
// launch passes it by value; a block copies it to the head of its shared memory.  A check's chain region holds
// its prefix chain buffer, its suffix chain buffer `suf` floats in, and with the extra operand its slots'
// combine outputs; each chain buffer holds the partials of 0 .. d-1 operands between kBig guards.
constexpr int kChainMaxD = 32;
struct ChainTable {
  int d, q, s_mid, s_out, we;  // the shape (we = 0: no extra operand)
  int in_stride, in_guard;     // floats a staged operand takes, and its kBig guards on each side
  int suf;                     // floats from a check's prefix chain buffer to its suffix chain buffer
  int tmp, tmp_stride;         // extra only: the combine outputs' offset in the chain region, and a slot's floats
  int region;                  // floats of a check's chain region
  int wc;                      // combine outputs a slot: 2 (s_out + se) + 1
  int cap[kChainMaxD];         // stored support of the partial of c operands
  int off[kChainMaxD];         // its offset in a chain buffer
  int swap[kChainMaxD];        // chain step t walks the partial (1) or the operand (0), as conv_warp's swap
  int slot[kChainMaxD];        // the combine's slots by falling term window
  int walk[kChainMaxD];        // that slot's walked partial, offset in the chain region
  int terms[kChainMaxD];       // its term window
  int read[kChainMaxD];        // its read partial's offset in the chain region, plus the conv's index offset
};

namespace {

constexpr float kBig = 1e15f;  // ops/minplus.py BIG as f32
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr long long kMaxSmem = 232448;  // dynamic shared memory a block may use

// Stored support of a partial conv of `count` operands (minplus.chain_exclusive cap()).
__host__ __device__ inline int cap_of(int count, int d, int b_sup, int s_pre, int s_mid) {
  int c = count * b_sup;
  const int x = s_pre + (d - 1 - count) * b_sup;
  c = c < x ? c : x;
  return c < s_mid ? c : s_mid;
}

// The partial convs of 0, 1, ... operands are stored back to back: offset of
// the one of `count` operands (count = d: the floats of all d of them).
__host__ __device__ inline int partial_offset(int count, int d, int b_sup, int s_pre, int s_mid) {
  int f = 0;
  for (int c = 0; c < count; ++c) f += 2 * cap_of(c, d, b_sup, s_pre, s_mid) + 1;
  return f;
}

// Warp-cooperative centered min-plus convolution with minplus.conv's term set:
// a [2sa+1], b [2sb+1], declared half supports ha, hb -> out[k * step],
// k in [0, 2 s_out]; step -1 with out at the last element writes reversed.
__device__ void conv_warp(const float* a, int sa, int ha, const float* b, int sb, int hb, int s_out,
                          float* out, int step, int lane) {
  ha = ha < sa ? ha : sa;
  hb = hb < sb ? hb : sb;
  if (hb < ha) {
    const float* t = a;
    a = b;
    b = t;
    int s = sa;
    sa = sb;
    sb = s;
    s = ha;
    ha = hb;
    hb = s;
  }
  const int w_out = 2 * s_out + 1;
  const int off = sa + sb - s_out;
  const int wb = 2 * sb + 1;
  for (int k = lane; k < w_out; k += 32) {
    float acc = INFINITY;
    for (int i = sa - ha; i <= sa + ha; ++i) {
      const int j = off - i + k;
      const float bv = (j >= 0 && j < wb) ? b[j] : kBig;
      acc = fminf(acc, a[i] + bv);
    }
    out[k * step] = fminf(acc, kBig);
  }
}

// chain_exclusive for one check, by one warp.  in: d operands of width q
// (stride q); extra: [2se+1] or nullptr; scratch: 2 * partial_offset(d, d, ...) floats
// (+ 2*s_pre+1 with extra).  Slot j's output goes to dst + j*q_dst (reversed
// when `reverse`, as c2v); dst may alias in.
__device__ void chain_check(const float* in, int d, int q, int s_mid, int s_out, const float* extra, int se,
                            float* scratch, float* dst, int q_dst, bool reverse, int lane) {
  const int b_sup = (q - 1) / 2;
  const int s_pre = s_out + se;
  const int pf = partial_offset(d, d, b_sup, s_pre, s_mid);
  float* pre = scratch;  // prefix[c]: conv of operands 0..c-1
  float* suf = pre + pf;  // suffix by count: conv of the last `count` operands
  float* tmp = suf + pf;  // combine output before the extra conv
  if (lane == 0) {
    pre[0] = 0.0f;
    suf[0] = 0.0f;
  }
  __syncwarp();
  int off_c = 0;  // offset of the partial of c operands
  for (int j = 0; j < d - 1; ++j) {
    const int cj = cap_of(j, d, b_sup, s_pre, s_mid);
    const int off_n = off_c + 2 * cj + 1;
    conv_warp(in + j * q, b_sup, b_sup, pre + off_c, cj, j * b_sup, cap_of(j + 1, d, b_sup, s_pre, s_mid),
              pre + off_n, 1, lane);
    __syncwarp();
    off_c = off_n;
  }
  off_c = 0;
  for (int j = d - 1; j >= 1; --j) {
    const int count = d - j;
    const int cp = cap_of(count - 1, d, b_sup, s_pre, s_mid);
    const int off_n = off_c + 2 * cp + 1;
    conv_warp(in + j * q, b_sup, b_sup, suf + off_c, cp, (count - 1) * b_sup,
              cap_of(count, d, b_sup, s_pre, s_mid), suf + off_n, 1, lane);
    __syncwarp();
    off_c = off_n;
  }
  const int w_out = 2 * s_out + 1;
  for (int j = 0; j < d; ++j) {
    const int cnt_s = d - 1 - j;
    const float* pj = pre + partial_offset(j, d, b_sup, s_pre, s_mid);
    const float* sj = suf + partial_offset(cnt_s, d, b_sup, s_pre, s_mid);
    float* out = dst + j * q_dst + (reverse ? w_out - 1 : 0);
    const int step = reverse ? -1 : 1;
    if (extra == nullptr) {
      conv_warp(pj, cap_of(j, d, b_sup, s_pre, s_mid), j * b_sup, sj, cap_of(cnt_s, d, b_sup, s_pre, s_mid),
                cnt_s * b_sup, s_pre, out, step, lane);
    } else {
      conv_warp(pj, cap_of(j, d, b_sup, s_pre, s_mid), j * b_sup, sj, cap_of(cnt_s, d, b_sup, s_pre, s_mid),
                cnt_s * b_sup, s_pre, tmp, 1, lane);
      __syncwarp();
      conv_warp(extra, se, se, tmp, s_pre, s_pre, s_out, out, step, lane);
      __syncwarp();
    }
  }
  __syncwarp();
}

long long chain_warp_floats(int d, int q, int s_mid, int s_out, int we) {
  const int se = we > 0 ? (we - 1) / 2 : 0;
  const int s_pre = s_out + se;
  long long f = static_cast<long long>(d) * q + 2LL * partial_offset(d, d, (q - 1) / 2, s_pre, s_mid);
  if (we > 0) f += we + 2 * s_pre + 1;
  return f;
}

// K6's caps: cap_of(count, d, b, b, (d - 1) b), the stored support of a
// partial conv of `count` operands when the outputs are +-b.
__host__ __device__ inline int fused_cap(int count, int d, int b) {
  return (count < d - count ? count : d - count) * b;
}

// K6 keeps each of a warp's two chains (prefix, suffix) in one buffer, every
// partial between kBig guards of 2b floats: offset of the partial of `count`
// operands (count = d: the buffer's floats).  A term whose b-index falls
// outside its partial reads a guard, the kBig that conv_warp's bounds test
// stands in, so the term set and each term's bits are minplus.conv's.
__host__ __device__ inline int fused_partial_offset(int count, int d, int b) {
  int f = 2 * b;
  for (int c = 0; c < count; ++c) f += 2 * fused_cap(c, d, b) + 1 + 2 * b;
  return f;
}

// Term window of slot j's combine: 2 min(cap(j), cap(d-1-j)) + 1.
__host__ __device__ inline int fused_window(int j, int d, int b) {
  const int cj = fused_cap(j, d, b);
  const int cs = fused_cap(d - 1 - j, d, b);
  return 2 * (cj < cs ? cj : cs) + 1;
}

// Floats from a warp's prefix chain buffer to its suffix chain buffer: the
// buffer rounded up to 16 modulo 32, so that a prefix lane and a suffix lane
// on the same output read banks 16 apart.
__host__ __device__ inline int fused_suffix_offset(int d, int b) {
  const int pf = fused_partial_offset(d, d, b);
  return pf + (48 - pf % 32) % 32;
}

// A K6 block: v2c [R, DC, Q], tot [N, Q], each warp's two chain buffers,
// then the block's table (DC + 1 partial offsets, the DC slots in combine
// order) as ints.
long long fused_floats(int n, int r, int dc, int q, int warps) {
  const int b_sup = (q - 1) / 2;
  const long long warp_floats = fused_suffix_offset(dc, b_sup) + fused_partial_offset(dc, dc, b_sup);
  return static_cast<long long>(r) * dc * q + static_cast<long long>(n) * q + warps * warp_floats + 2 * dc + 1;
}

// min over i < wa of a[i] + bk[-i], then min with BIG: one output of a
// min-plus conv whose b-operand is padded (every index in range).
__device__ __forceinline__ float min_terms(const float* a, int wa, const float* bk) {
  float acc = INFINITY;
#pragma unroll 4
  for (int i = 0; i < wa; ++i) acc = fminf(acc, a[i] + bk[-i]);
  return fminf(acc, kBig);
}

// K6's check update of one row, by one warp: chain_check without the extra
// operand, with the same term sets, written in place of m [d, q] and
// reversed as c2v.  pre, suf: the warp's chain buffers (fused_partial_offset
// layout, guards kBig, the partial of 0 operands [0]); off: the partials'
// offsets; order: the slots by falling combine window.
__device__ void fused_check(float* m, int d, int b, const int* off, const int* order, float* pre, float* suf,
                            int lane) {
  const int q = 2 * b + 1;
  // Step t of the prefix chain (operand t onto the partial of t operands) and
  // of the suffix chain (operand d-1-t onto the last t) have the same shapes:
  // both in one pass, a lane on each (chain, output), the chains on
  // alternate lanes (with the buffers 16 banks apart, no two lanes of a pass
  // read one bank).  As conv_warp: step 0
  // walks the partial [0] (the smaller declared support, so the operands
  // swap) over the operand; a later step walks the operand's q terms over the
  // partial, at offset b + ct - cn.
  for (int t = 0; t < d - 1; ++t) {
    const int ct = fused_cap(t, d, b);
    const int cn = fused_cap(t + 1, d, b);
    const int w = 2 * cn + 1;
    for (int p = lane; p < 2 * w; p += 32) {
      const bool s = p & 1;
      const int k = p >> 1;
      float* part = s ? suf : pre;
      const float* x = m + (s ? d - 1 - t : t) * q;
      part[off[t + 1] + k] = t ? min_terms(x, q, part + off[t] + b + ct - cn + k)
                               : min_terms(part + off[0], 1, x + b - cn + k);
    }
    __syncwarp();
  }
  // Every slot's combine, conv(prefix j, suffix of d-1-j) to +-b, in passes
  // over (slot, output) lanes, the slots by falling term window so that a
  // pass's lanes walk alike windows; conv_warp's swap walks the partial of
  // the smaller cap, picked by pointer so that a pass mixing swapped and
  // unswapped slots runs one loop.  Written reversed in place: the chains no
  // longer read m.
  for (int p = lane; p < d * q; p += 32) {
    const int rank = p / q;
    const int k = p - rank * q;
    const int j = order[rank];
    const int cj = fused_cap(j, d, b);
    const int cs = fused_cap(d - 1 - j, d, b);
    const bool swap = cs < cj;
    const float* a = swap ? suf + off[d - 1 - j] : pre + off[j];
    const float* bb = swap ? pre + off[j] : suf + off[d - 1 - j];
    m[j * q + q - 1 - k] = min_terms(a, 2 * (swap ? cs : cj) + 1, bb + cj + cs - b + k);
  }
  __syncwarp();
}

// K5's per-warp form (the form before the Hopper redesign, kept for shapes whose staged block does not fit):
// chain_exclusive over n_checks = Bt*R checks, one warp per check, kWarps a block.  v2c [n_checks, d, q];
// extra [n_checks, we] or nullptr; out [n_checks, d, 2 s_out + 1].
__global__ void __launch_bounds__(kThreads)
    chain_exclusive_kernel(const float* __restrict__ v2c, const float* __restrict__ extra, float* __restrict__ out,
                           long long n_checks, int d, int q, int s_mid, int s_out, int we, int warp_floats) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* in = smem + static_cast<size_t>(warp) * warp_floats;
  float* ex = in + d * q;
  float* scratch = ex + (extra ? we : 0);
  const int se = extra ? (we - 1) / 2 : 0;
  const int w_out = 2 * s_out + 1;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (c >= n_checks) return;
  const float* src = v2c + static_cast<size_t>(c) * d * q;
  for (int t = lane; t < d * q; t += 32) in[t] = src[t];
  if (extra) {
    const float* e = extra + static_cast<size_t>(c) * we;
    for (int t = lane; t < we; t += 32) ex[t] = e[t];
  }
  __syncwarp();
  chain_check(in, d, q, s_mid, s_out, extra ? ex : nullptr, se, scratch, out + static_cast<size_t>(c) * d * w_out,
              w_out, false, lane);
}

// K6: the whole decode of one frame per block of kW warps, at most 64
// registers a thread (32 warps an SM as far as registers go).
template <int kW>
__global__ void __launch_bounds__(kW * 32, 32 / kW)
    qary_fused_kernel(const float* __restrict__ channel, const int* __restrict__ chk_var,
                      const int* __restrict__ chk_sign, const int* __restrict__ chk_mask,
                      const int* __restrict__ var_flat, int n, int r, int dc, int dv, int q, int max_iter,
                      int* __restrict__ hard) {
  constexpr int kThreads = kW * 32;
  extern __shared__ float smem[];
  const int b_sup = (q - 1) / 2;
  const int edges = r * dc;
  const int pf = fused_partial_offset(dc, dc, b_sup);
  float* v2c = smem;          // [R*DC, Q]; holds c2v between the check and edge sweeps
  float* tot = v2c + edges * q;  // [N, Q]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ps = fused_suffix_offset(dc, b_sup);
  float* pre = tot + n * q + warp * (ps + pf);  // the warp's prefix chain, then its suffix chain
  float* suf = pre + ps;
  int* off = reinterpret_cast<int*>(tot + n * q + kW * (ps + pf));  // [DC + 1] partial offsets
  int* order = off + dc + 1;                                       // [DC] slots by falling combine window
  const float* ch = channel + static_cast<size_t>(blockIdx.x) * n * q;

  // The block's table, and each warp's guards and partials of 0 operands.
  for (int c = threadIdx.x; c <= dc; c += kThreads) off[c] = fused_partial_offset(c, dc, b_sup);
  for (int j = threadIdx.x; j < dc; j += kThreads) {
    const int wj = fused_window(j, dc, b_sup);
    int rank = 0;
    for (int x = 0; x < dc; ++x) {
      const int wx = fused_window(x, dc, b_sup);
      rank += wx > wj || (wx == wj && x < j);
    }
    order[rank] = j;
  }
  for (int t = lane; t < ps + pf; t += 32) pre[t] = (t == 2 * b_sup || t == ps + 2 * b_sup) ? 0.0f : kBig;

  // Initial v2c: the signed channel on each edge, the delta identity on pads.
  for (int idx = threadIdx.x; idx < edges * q; idx += kThreads) {
    const int e = idx / q;
    const int s = idx - e * q;
    v2c[idx] = chk_mask[e] ? ch[chk_var[e] * q + (chk_sign[e] < 0 ? q - 1 - s : s)]
                           : (s == b_sup ? 0.0f : kBig);
  }
  for (int idx = threadIdx.x; idx < n * q; idx += kThreads) tot[idx] = 0.0f;
  __syncthreads();

  for (int it = 0; it < max_iter; ++it) {
    // ---- check sweep: c2v in place of v2c
    for (int i = warp; i < r; i += kW) fused_check(v2c + i * dc * q, dc, b_sup, off, order, pre, suf, lane);
    __syncthreads();

    // ---- variable sweep: tot = channel + ((u_0 + u_1) + ...), pads add 0
    for (int idx = threadIdx.x; idx < n * q; idx += kThreads) {
      const int v = idx / q;
      const int s = idx - v * q;
      float acc = 0.0f;
      for (int t = 0; t < dv; ++t) {
        const int e = var_flat[v * dv + t];
        float u = 0.0f;
        if (e < edges) u = v2c[e * q + (chk_sign[e] < 0 ? q - 1 - s : s)];
        acc = (t == 0) ? u : acc + u;
      }
      tot[idx] = ch[idx] + acc;
    }
    __syncthreads();

    // ---- edge sweep: extrinsic, normalized v2c
    for (int e = threadIdx.x; e < edges; e += kThreads) {
      float* m = v2c + e * q;
      if (!chk_mask[e]) {
        for (int s = 0; s < q; ++s) m[s] = (s == b_sup) ? 0.0f : kBig;
        continue;
      }
      const float* t = tot + chk_var[e] * q;
      const bool neg = chk_sign[e] < 0;
      float mn = INFINITY;
      for (int s = 0; s < q; ++s) mn = fminf(mn, t[neg ? q - 1 - s : s] - m[s]);
      for (int s = 0; s < q; ++s) m[s] = fminf((t[neg ? q - 1 - s : s] - m[s]) - mn, kBig);
    }
    __syncthreads();
  }

  // Hard decision: first-minimal symbol of the last totals, minus B.
  int* h = hard + static_cast<size_t>(blockIdx.x) * n;
  for (int v = threadIdx.x; v < n; v += kThreads) {
    const float* t = tot + v * q;
    float best = t[0];
    int bi = 0;
    for (int s = 1; s < q; ++s) {
      if (t[s] < best) {
        best = t[s];
        bi = s;
      }
    }
    h[v] = bi - b_sup;
  }
}

// Output k of conv_warp(a, sa, ha, b, sb, hb, s_out): the same terms, by one lane.
__device__ float conv_out(const float* a, int sa, int ha, const float* b, int sb, int hb, int s_out, int k) {
  ha = ha < sa ? ha : sa;
  hb = hb < sb ? hb : sb;
  if (hb < ha) {
    const float* t = a;
    a = b;
    b = t;
    int x = sa;
    sa = sb;
    sb = x;
    x = ha;
    ha = hb;
    hb = x;
  }
  const int off = sa + sb - s_out;
  const int wb = 2 * sb + 1;
  float acc = INFINITY;
  for (int i = sa - ha; i <= sa + ha; ++i) {
    const int j = off - i + k;
    const float bv = (j >= 0 && j < wb) ? b[j] : kBig;
    acc = fminf(acc, a[i] + bv);
  }
  return fminf(acc, kBig);
}

// K7's check update of one row, by one warp: chain_check with the row's
// signed sum channel ex [2 bsum + 1] as the extra operand and the same term
// sets, written in place of m [sw, qb] and reversed as c2v.  scratch:
// special_check_floats(sw, b, bsum) floats.
__device__ void special_check(float* m, int sw, int b, int s_mid, const float* ex, int bsum, float* scratch,
                              int lane) {
  const int qb = 2 * b + 1;
  const int s_pre = b + bsum;
  const int wp = 2 * s_pre + 1;
  const int pf = partial_offset(sw, sw, b, s_pre, s_mid);
  float* pre = scratch;  // prefix[c]: conv of operands 0..c-1
  float* suf = pre + pf;  // suffix by count: conv of the last `count` operands
  float* tmp = suf + pf;  // combine outputs
  if (lane == 0) {
    pre[0] = 0.0f;
    suf[0] = 0.0f;
  }
  __syncwarp();
  // Step t of the prefix chain (operand t onto the partial of t operands) and
  // of the suffix chain (operand sw-1-t onto the last t) have the same
  // shapes: both in one pass, a lane on each (chain, output).
  int off_c = 0;
  for (int t = 0; t < sw - 1; ++t) {
    const int ct = cap_of(t, sw, b, s_pre, s_mid);
    const int cn = cap_of(t + 1, sw, b, s_pre, s_mid);
    const int off_n = off_c + 2 * ct + 1;
    const int w = 2 * cn + 1;
    for (int p = lane; p < 2 * w; p += 32) {
      const bool s = p >= w;
      const int k = s ? p - w : p;
      float* part = s ? suf : pre;
      part[off_n + k] = conv_out(m + (s ? sw - 1 - t : t) * qb, b, b, part + off_c, ct, t * b, cn, k);
    }
    __syncwarp();
    off_c = off_n;
  }
  // every slot's combine output, side by side in tmp [sw][wp]
  for (int j = 0; j < sw; ++j) {
    const int cnt_s = sw - 1 - j;
    conv_warp(pre + partial_offset(j, sw, b, s_pre, s_mid), cap_of(j, sw, b, s_pre, s_mid), j * b,
              suf + partial_offset(cnt_s, sw, b, s_pre, s_mid), cap_of(cnt_s, sw, b, s_pre, s_mid), cnt_s * b, s_pre,
              tmp + j * wp, 1, lane);
  }
  __syncwarp();
  // Every slot's extra conv in one pass, a lane on each (slot, output):
  // conv_warp(ex, bsum, bsum, tmp_j, s_pre, s_pre, b) takes no operand swap
  // (s_pre > bsum), and its output k is the min over i in [0, 2 bsum] of
  // ex[i] + tmp_j[2 bsum + k - i], every index inside tmp_j.
  for (int p = lane; p < sw * qb; p += 32) {
    const int j = p / qb;
    const int k = p - j * qb;
    const float* t = tmp + j * wp + 2 * bsum + k;
    float acc = INFINITY;
    for (int i = 0; i <= 2 * bsum; ++i) acc = fminf(acc, ex[i] + t[-i]);
    m[j * qb + qb - 1 - k] = fminf(acc, kBig);
  }
  __syncwarp();
}

// Floats of special_check's scratch: the prefix and suffix partials and the
// sw combine outputs.
long long special_check_floats(int sw, int b, int bsum) {
  const int s_pre = b + bsum;
  return 2LL * partial_offset(sw, sw, b, s_pre, (2 * sw - 1) * b) + static_cast<long long>(sw) * (2 * s_pre + 1);
}

// Floats of one K7 warp's slice: the row's signed sum channel [qs], then
// scratch for the chain with extra (or for the full conv's two [qs] buffers).
long long special_warp_floats(int sw, int b, int bsum) {
  const int qs = 2 * bsum + 1;
  const long long chain = special_check_floats(sw, b, bsum);
  return qs + (chain > 2LL * qs ? chain : 2LL * qs);
}

long long special_fused_floats(int nb, int r, int sw, int b, int bsum, int warps) {
  const long long qb = 2 * b + 1;
  return static_cast<long long>(r) * sw * qb + nb * qb + warps * special_warp_floats(sw, b, bsum);
}

// The sum variable's decision for one check, by one warp: the full conv of
// the row's sw B-messages m [sw, qb] to +-bsum (minplus.conv's term set,
// from the delta identity), then tot[s] = cs[s] + signed(reversed full)[s]
// and the first-minimal s, minus bsum, into *out.  buf: 2 * qs floats.
__device__ void sum_decision(const float* m, int sw, int b, int bsum, const float* cs, bool neg, float* buf,
                             int* out, int lane) {
  const int qb = 2 * b + 1;
  const int qs = 2 * bsum + 1;
  float* cur = buf;
  float* nxt = buf + qs;
  for (int t = lane; t < qs; t += 32) cur[t] = (t == bsum) ? 0.0f : kBig;
  __syncwarp();
  for (int j = 0; j < sw; ++j) {
    conv_warp(m + j * qb, b, b, cur, bsum, bsum, bsum, nxt, 1, lane);
    __syncwarp();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (lane == 0) {
    // c2v_sum[s] = min(full[qs-1-s], BIG); signed: reversed again where neg
    float best = cs[0] + fminf(cur[neg ? 0 : qs - 1], kBig);
    int bi = 0;
    for (int s = 1; s < qs; ++s) {
      const float v = cs[s] + fminf(cur[neg ? s : qs - 1 - s], kBig);
      if (v < best) {
        best = v;
        bi = s;
      }
    }
    *out = bi - bsum;
  }
  __syncwarp();
}

// K7: the whole two-alphabet decode of one frame per block of kW warps, at
// most 64 registers a thread (32 warps an SM as far as registers go).
template <int kW>
__global__ void __launch_bounds__(kW * 32, 32 / kW)
    qary_special_fused_kernel(const float* __restrict__ channel, const float* __restrict__ chs,
                              const float* __restrict__ vsum, const int* __restrict__ bvar_idx,
                              const int* __restrict__ bvar_sign, const int* __restrict__ bvar_mask,
                              const int* __restrict__ var_flat, const int* __restrict__ sum_sign, int nb, int r,
                              int sw, int dv, int b, int bsum, int max_iter, int warp_floats,
                              int* __restrict__ hard_b, int* __restrict__ hard_s) {
  constexpr int kThreads = kW * 32;
  extern __shared__ float smem[];
  const int qb = 2 * b + 1;
  const int qs = 2 * bsum + 1;
  const int s_mid = (2 * sw - 1) * b;
  const int edges = r * sw;
  float* v2c = smem;              // [R*SW, QB]; holds c2v between the check and edge sweeps
  float* tot = v2c + edges * qb;  // [NB, QB]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ex = tot + nb * qb + warp * warp_floats;  // [QS]: the row's signed sum channel
  float* scratch = ex + qs;
  const size_t f = blockIdx.x;
  const float* ch = channel + f * nb * qb;
  const float* cs = chs + f * r * qs;
  const float* vs = vsum + f * r * qs;
  int* hs = hard_s + f * r;

  // Initial v2c: the signed channel on each edge, the delta identity on pads.
  for (int idx = threadIdx.x; idx < edges * qb; idx += kThreads) {
    const int e = idx / qb;
    const int s = idx - e * qb;
    v2c[idx] = bvar_mask[e] ? ch[bvar_idx[e] * qb + (bvar_sign[e] < 0 ? qb - 1 - s : s)]
                            : (s == b ? 0.0f : kBig);
  }
  for (int idx = threadIdx.x; idx < nb * qb; idx += kThreads) tot[idx] = 0.0f;
  if (max_iter == 0) {
    for (int i = threadIdx.x; i < r; i += kThreads) hs[i] = -bsum;  // argmin of all-zero totals
  }
  __syncthreads();

  for (int it = 0; it < max_iter; ++it) {
    const bool last = it == max_iter - 1;
    // ---- check sweep: c2v in place of v2c (last iteration: sum decisions first)
    for (int i = warp; i < r; i += kW) {
      float* m = v2c + i * sw * qb;
      for (int t = lane; t < qs; t += 32) ex[t] = vs[i * qs + t];
      __syncwarp();
      if (last) sum_decision(m, sw, b, bsum, cs + i * qs, sum_sign[i] < 0, scratch, hs + i, lane);
      special_check(m, sw, b, s_mid, ex, bsum, scratch, lane);
    }
    __syncthreads();

    // ---- variable sweep: tot = channel + ((u_0 + u_1) + ...), pads add 0
    for (int idx = threadIdx.x; idx < nb * qb; idx += kThreads) {
      const int v = idx / qb;
      const int s = idx - v * qb;
      float acc = 0.0f;
      for (int t = 0; t < dv; ++t) {
        const int e = var_flat[v * dv + t];
        float u = 0.0f;
        if (e < edges) u = v2c[e * qb + (bvar_sign[e] < 0 ? qb - 1 - s : s)];
        acc = (t == 0) ? u : acc + u;
      }
      tot[idx] = ch[idx] + acc;
    }
    __syncthreads();
    if (last) break;

    // ---- edge sweep: extrinsic, normalized v2c
    for (int e = threadIdx.x; e < edges; e += kThreads) {
      float* m = v2c + e * qb;
      if (!bvar_mask[e]) {
        for (int s = 0; s < qb; ++s) m[s] = (s == b) ? 0.0f : kBig;
        continue;
      }
      const float* t = tot + bvar_idx[e] * qb;
      const bool neg = bvar_sign[e] < 0;
      float mn = INFINITY;
      for (int s = 0; s < qb; ++s) mn = fminf(mn, t[neg ? qb - 1 - s : s] - m[s]);
      for (int s = 0; s < qb; ++s) m[s] = fminf((t[neg ? qb - 1 - s : s] - m[s]) - mn, kBig);
    }
    __syncthreads();
  }

  // B decisions: first-minimal symbol of the last totals, minus B.
  int* h = hard_b + f * nb;
  for (int v = threadIdx.x; v < nb; v += kThreads) {
    const float* t = tot + v * qb;
    float best = t[0];
    int bi = 0;
    for (int s = 1; s < qb; ++s) {
      if (t[s] < best) {
        best = t[s];
        bi = s;
      }
    }
    h[v] = bi - b;
  }
}

// K5's check update of a warp's kK checks, with chain_check's term sets: step t of the prefix chain and step t
// of the suffix chain in one pass, a lane on each (check, chain, output); every slot's combine in passes over
// (check, slot, output) lanes, the slots by falling term window; with the extra operand every slot's combine
// output to +-s_pre side by side, then every slot's extra conv in one pass over (check, slot, output) lanes.
// Every read of a partial (or of a staged operand) lies inside its kBig guards, so no term tests its index.
// in, ex, reg, ob: the warp's first check's staged operands, extra operand, chain region and outputs.
template <int kK>
__device__ void chain_group(const ChainTable& t, const float* in, const float* ex, float* reg, float* ob, int lane) {
  constexpr int kS = kK == 1 ? 0 : kK == 2 ? 1 : 2;  // log2 kK
  const int d = t.d, q = t.q, b = (q - 1) / 2;
  const int c_in = d * t.in_stride, w_out = 2 * t.s_out + 1, c_out = d * w_out;
  for (int s = 0; s < d - 1; ++s) {
    const int ct = t.cap[s], cn = t.cap[s + 1];
    const bool swap = t.swap[s];
    const int w = swap ? 2 * ct + 1 : q;
    const int k0 = b + ct - cn;  // conv's index offset: the walked and read supports less the output's
    const int o_t = t.off[s], o_n = t.off[s + 1];
    for (int p = lane; p < (2 * cn + 1) << (kS + 1); p += 32) {
      const int g = p & (kK - 1);
      const int c = (p >> kS) & 1;
      const int k = p >> (kS + 1);
      float* part = reg + g * t.region + (c ? t.suf : 0);
      const float* x = in + g * c_in + (c ? d - 1 - s : s) * t.in_stride + t.in_guard;
      const float* a = swap ? part + o_t : x;
      const float* bk = (swap ? x : part + o_t) + k0 + k;
      part[o_n + k] = min_terms(a, w, bk);
    }
    __syncwarp();
  }
  const int wc = t.wc;
  for (int p = lane; p < (d * wc) << kS; p += 32) {
    const int g = p & (kK - 1);
    const int r = p >> kS;
    const int rank = r / wc;
    const int k = r - rank * wc;
    float* rg = reg + g * t.region;
    const float v = min_terms(rg + t.walk[rank], t.terms[rank], rg + t.read[rank] + k);
    const int j = t.slot[rank];
    if (t.we) {
      rg[t.tmp + j * t.tmp_stride + k] = v;
    } else {
      ob[g * c_out + j * w_out + k] = v;
    }
  }
  __syncwarp();
  if (t.we) {
    // conv_warp(extra, se, se, combine_j, s_pre, s_pre, s_out) takes no operand swap (s_pre >= se): output k
    // is the min over i < we of extra[i] + combine_j[2 se + k - i], every index inside combine_j.
    for (int p = lane; p < c_out << kS; p += 32) {
      const int g = p & (kK - 1);
      const int r = p >> kS;
      const int j = r / w_out;
      const int k = r - j * w_out;
      ob[g * c_out + r] = min_terms(ex + g * t.we, t.we, reg + g * t.region + t.tmp + j * t.tmp_stride + t.we - 1 + k);
    }
    __syncwarp();
  }
}

// K5, staged: chain_exclusive over n_checks = Bt*R checks, kK checks a warp, kW warps a block, at most 64
// registers a thread.  Each block walks groups of kW*kK consecutive checks: it stages the group's v2c and
// extra rows into shared memory with coalesced loads, each warp updates its kK checks (chain_group), and the
// block writes the group's outputs with coalesced stores.  v2c [n_checks, d, q]; extra [n_checks, we] or
// nullptr; out [n_checks, d, 2 s_out + 1].
template <int kW, int kK>
__global__ void __launch_bounds__(kW * 32, 32 / kW)
    chain_staged_kernel(const float* __restrict__ v2c, const float* __restrict__ extra, float* __restrict__ out,
                        long long n_checks, const ChainTable table) {
  constexpr int kC = kW * kK, kThreads = kW * 32;
  extern __shared__ float smem[];
  ChainTable& t = *reinterpret_cast<ChainTable*>(smem);
  const int d = table.d, q = table.q, we = table.we, region = table.region;
  const int c_in = d * table.in_stride, c_out = d * (2 * table.s_out + 1);
  float* in = smem + sizeof(ChainTable) / sizeof(float);  // [kC][d][in_stride]
  float* ex = in + kC * c_in;                              // [kC][we]
  float* ob = ex + kC * we;                                // [kC][d][2 s_out + 1]
  float* reg = ob + kC * c_out;                            // [kC][region]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) t = table;
  // the guards, once: the chain steps write only partials, the combine only its outputs
  for (int i = threadIdx.x; i < kC * region; i += kThreads) reg[i] = kBig;
  __syncthreads();
  if (threadIdx.x < kC) {  // the partials of 0 operands
    reg[threadIdx.x * region + table.off[0]] = 0.0f;
    reg[threadIdx.x * region + table.suf + table.off[0]] = 0.0f;
  }
  const long long groups = (n_checks + kC - 1) / kC;
  for (long long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long c0 = grp * kC;
    const int nb = static_cast<int>(n_checks - c0 < kC ? n_checks - c0 : kC);
    const float* src = v2c + c0 * d * q;
    if (table.in_guard == 0) {
      for (int i = threadIdx.x; i < kC * c_in; i += kThreads) in[i] = i < nb * c_in ? src[i] : 0.0f;
    } else {
      for (int i = threadIdx.x; i < kC * c_in; i += kThreads) {
        const int o = i / table.in_stride;
        const int s = i - o * table.in_stride - table.in_guard;
        in[i] = (s < 0 || s >= q) ? kBig : o < nb * d ? src[o * q + s] : 0.0f;
      }
    }
    if (extra) {
      const float* e = extra + c0 * we;
      for (int i = threadIdx.x; i < kC * we; i += kThreads) ex[i] = i < nb * we ? e[i] : 0.0f;
    }
    __syncthreads();
    chain_group<kK>(t, in + warp * kK * c_in, ex + warp * kK * we, reg + warp * kK * region, ob + warp * kK * c_out,
                    lane);
    __syncthreads();
    float* dst = out + c0 * c_out;
    for (int i = threadIdx.x; i < nb * c_out; i += kThreads) dst[i] = ob[i];
  }
}

}  // namespace

// Dynamic shared memory of one K6 block (one frame) of `warps` warps.
extern "C" long long qary_fused_smem_bytes(int n, int r, int dc, int q, int warps) {
  return fused_floats(n, r, dc, q, warps) * static_cast<long long>(sizeof(float));
}

// K6's instances: 32, 16, 8 or 4 warps a block; the host's fused_launch()
// picks one from the card's shared-memory limits.
namespace {

using FusedKernel = void (*)(const float*, const int*, const int*, const int*, const int*, int, int, int, int, int,
                             int, int*);

FusedKernel fused_instance(int warps) {
  switch (warps) {
    case 32: return qary_fused_kernel<32>;
    case 16: return qary_fused_kernel<16>;
    case 8: return qary_fused_kernel<8>;
    case 4: return qary_fused_kernel<4>;
    default: return nullptr;
  }
}

}  // namespace

// K5's instances: checks a warp (1, 2 or 4) and warps a block (16, 8 or 4), staged; checks 0: the per-warp form
// (8 warps a block).  The host's chain_launch() picks one from the card's limits.
namespace {

using ChainKernel = void (*)(const float*, const float*, float*, long long, const ChainTable);

ChainKernel chain_instance(int warps, int checks) {
  switch (warps * 8 + checks) {
    case 16 * 8 + 1: return chain_staged_kernel<16, 1>;
    case 8 * 8 + 1: return chain_staged_kernel<8, 1>;
    case 4 * 8 + 1: return chain_staged_kernel<4, 1>;
    case 16 * 8 + 2: return chain_staged_kernel<16, 2>;
    case 8 * 8 + 2: return chain_staged_kernel<8, 2>;
    case 4 * 8 + 2: return chain_staged_kernel<4, 2>;
    case 16 * 8 + 4: return chain_staged_kernel<16, 4>;
    case 8 * 8 + 4: return chain_staged_kernel<8, 4>;
    case 4 * 8 + 4: return chain_staged_kernel<4, 4>;
    default: return nullptr;
  }
}

}  // namespace

// Bytes of a ChainTable (the host's copy of the struct must match).
extern "C" int qary_chain_table_bytes() { return static_cast<int>(sizeof(ChainTable)); }

// Dynamic shared memory of one K5 block of the instance (warps, checks) for the shape of table t: the table,
// then for each of its warps*checks checks the staged operands, extra operand, outputs and chain region; the
// per-warp form (checks 0): kWarps warps' slices.
extern "C" long long qary_chain_smem_bytes(const ChainTable* t, int warps, int checks) {
  const long long f = sizeof(float);
  if (checks == 0) return kWarps * chain_warp_floats(t->d, t->q, t->s_mid, t->s_out, t->we) * f;
  const long long check = static_cast<long long>(t->d) * (t->in_stride + 2 * t->s_out + 1) + t->we + t->region;
  return static_cast<long long>(sizeof(ChainTable)) + static_cast<long long>(warps) * checks * check * f;
}

// K5 (replaces chain_exclusive_pallas).  v2c [n_checks, d, q] f32, extra [n_checks, we] f32 or nullptr (we = 0),
// out [n_checks, d, 2 s_out + 1] f32; t: the shape's table (chain_table()); the instance (warps, checks);
// max_blocks: the grid's cap (the blocks resident on the card).  Returns a cudaError_t.
extern "C" int qary_chain_exclusive(const float* v2c, const float* extra, float* out, long long n_checks,
                                    const ChainTable* t, int warps, int checks, int max_blocks, void* stream) {
  const int d = t->d, q = t->q, we = t->we;
  const ChainKernel kernel = chain_instance(warps, checks);
  if (d < 1 || q < 1 || q % 2 == 0 || t->s_mid < 0 || t->s_out < 0 || n_checks < 0 || max_blocks < 1 ||
      (extra != nullptr) != (we > 0) || (we > 0 && we % 2 == 0) ||
      (checks == 0 ? warps != kWarps : kernel == nullptr || d > kChainMaxD)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = qary_chain_smem_bytes(t, warps, checks);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  if (n_checks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (checks == 0) {
    const long long blocks = (n_checks + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(chain_exclusive_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int warp_floats = static_cast<int>(chain_warp_floats(d, q, t->s_mid, t->s_out, we));
    chain_exclusive_kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), s>>>(
        v2c, extra, out, n_checks, d, q, t->s_mid, t->s_out, we, warp_floats);
    return static_cast<int>(cudaGetLastError());
  }
  const long long per_block = static_cast<long long>(warps) * checks;
  const long long groups = (n_checks + per_block - 1) / per_block;
  const unsigned blocks = static_cast<unsigned>(groups < max_blocks ? groups : max_blocks);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, warps * 32, static_cast<size_t>(smem), s>>>(v2c, extra, out, n_checks, *t);
  return static_cast<int>(cudaGetLastError());
}

// K6 (replaces qary_min_sum_fused).  channel [batch, n, q] f32 finite
// min-sum LLRs; chk_var/chk_sign/chk_mask [r, dc] int32 and var_flat [n, dv]
// int32 from CodeLayout (pads: chk_mask 0, var_flat r*dc); hard [batch, n]
// int32 in [-B..B]; warps a block 32, 16, 8 or 4.  Returns a cudaError_t.
extern "C" int qary_min_sum_fused(const float* channel, const int* chk_var, const int* chk_sign, const int* chk_mask,
                                  const int* var_flat, int batch, int n, int r, int dc, int dv, int q, int max_iter,
                                  int warps, int* hard, void* stream) {
  const FusedKernel kernel = fused_instance(warps);
  if (batch < 0 || n < 1 || r < 1 || dc < 1 || dv < 1 || q < 1 || q % 2 == 0 || max_iter < 0 || kernel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = qary_fused_smem_bytes(n, r, dc, q, warps);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, warps * 32, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      channel, chk_var, chk_sign, chk_mask, var_flat, n, r, dc, dv, q, max_iter, hard);
  return static_cast<int>(cudaGetLastError());
}

// K7's instances: 32, 16 or 8 warps a block; the host's
// special_fused_launch() picks one from the card's shared-memory limits.
namespace {

using SpecialKernel = void (*)(const float*, const float*, const float*, const int*, const int*, const int*,
                               const int*, const int*, int, int, int, int, int, int, int, int, int*, int*);

SpecialKernel special_instance(int warps) {
  switch (warps) {
    case 32: return qary_special_fused_kernel<32>;
    case 16: return qary_special_fused_kernel<16>;
    case 8: return qary_special_fused_kernel<8>;
    default: return nullptr;
  }
}

}  // namespace

// Dynamic shared memory of one K7 block (one frame) of `warps` warps.
extern "C" long long qary_special_fused_smem_bytes(int nb, int r, int sw, int b, int bsum, int warps) {
  return special_fused_floats(nb, r, sw, b, bsum, warps) * static_cast<long long>(sizeof(float));
}

// Blocks resident on one SM of the `warps` instance of K6 (kernel 6) or K7
// (kernel 7) at `smem` bytes of dynamic shared memory, from the occupancy
// calculator; a negative cudaError_t on failure.
extern "C" int qary_fused_occupancy(int kernel, int warps, int smem) {
  const void* fn = kernel == 6   ? reinterpret_cast<const void*>(fused_instance(warps))
                   : kernel == 7 ? reinterpret_cast<const void*>(special_instance(warps))
                                 : nullptr;
  if (fn == nullptr || smem < 0 || smem > kMaxSmem) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, warps * 32, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// K7 (replaces qary_special_min_sum_fused).  channel [batch, nb, 2b+1] f32
// finite min-sum LLRs of the B-variables; chs [batch, r, 2bsum+1] f32 the
// sum variables' LLRs in row order and vsum the same reversed where
// sum_sign is -1; bvar_idx/bvar_sign/bvar_mask [r, sw] int32 (pads: mask 0),
// var_flat [nb, dv] int32 into [r*sw] (pads: r*sw), sum_sign [r] int32;
// hard_b [batch, nb] int32 in [-b..b], hard_s [batch, r] int32 in
// [-bsum..bsum], row order; warps a block 32, 16 or 8.  Returns a
// cudaError_t.
extern "C" int qary_special_min_sum_fused(const float* channel, const float* chs, const float* vsum,
                                          const int* bvar_idx, const int* bvar_sign, const int* bvar_mask,
                                          const int* var_flat, const int* sum_sign, int batch, int nb, int r, int sw,
                                          int dv, int b, int bsum, int max_iter, int warps, int* hard_b, int* hard_s,
                                          void* stream) {
  const SpecialKernel kernel = special_instance(warps);
  if (batch < 0 || nb < 1 || r < 1 || sw < 1 || dv < 1 || b < 1 || bsum < 1 || max_iter < 0 || kernel == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = qary_special_fused_smem_bytes(nb, r, sw, b, bsum, warps);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warp_floats = static_cast<int>(special_warp_floats(sw, b, bsum));
  kernel<<<batch, warps * 32, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      channel, chs, vsum, bvar_idx, bvar_sign, bvar_mask, var_flat, sum_sign, nb, r, sw, dv, b, bsum, max_iter,
      warp_floats, hard_b, hard_s);
  return static_cast<int>(cudaGetLastError());
}
