"""Edited copies of K8's source (``csrc/circulant_multi.cu``) that
``circulant_forms --kernels k8`` times beside it, each written from the
current source by text edits that must all apply:

- ``floor``, ``floor_check``, ``floor_check_var``, ``floor_all``: timing
  only (their outputs are meaningless).  Every frame runs every iteration
  (the running-frame bitmask forced to all ones, the exit test to "more"),
  and the loop keeps its barriers and the bitmask but does the work of no
  sweep, of the check sweep, of the check and variable sweeps, or of all
  three.  ``floor`` is the time the design sets itself; the differences
  between the four are the sweeps' shares of an iteration.
- ``stage2``: the same decode with iteration it - 1's syndrome test folded
  into iteration it's check sweep (from the same gathers of tot), so two
  grid barriers an iteration and one test sweep at the end.  The identity
  decisions are double-buffered (the second buffer a static device array
  of 4 MiB: B * P * N up to 2^22, enough for the attack's cells), so a
  frame found done keeps the decisions of the iteration it converged in.
  Its outputs equal the plain version's.

    python3 -m sca_ldpc_tpu_torch.tools.k8_variants build/k8_variants

writes them there as ``<name>.cu``.
"""

import sys
from pathlib import Path

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "circulant_multi.cu"
FLOORS = {"floor": 0, "floor_check": 1, "floor_check_var": 2, "floor_all": 3}  # sweeps that keep their work
_SWEEP = "    for (int tile = blockIdx.x; tile < "


def _replace(src, old, new):
    if src.count(old) != 1:
        raise ValueError(f"circulant_multi.cu changed: {old[:80]!r} found {src.count(old)} times")
    return src.replace(old, new)


def floor_copy(src, sweeps):
    """``src`` with every frame forced through every iteration and only the
    first ``sweeps`` of the check, variable and syndrome sweeps doing work."""
    src = _replace(src, "      run[x] = bits;\n", "      run[x] = ~0u;\n")
    src = _replace(src, "const int more = __syncthreads_or(any);", "const int more = __syncthreads_or(any) || true;")
    parts = src.split(_SWEEP)
    if len(parts) != 4:
        raise ValueError(f"circulant_multi.cu changed: {len(parts) - 1} sweep loops, expected 3")
    return parts[0] + "".join((_SWEEP if q < sweeps else _SWEEP.replace("tile < ", "false && tile < ")) + part
                              for q, part in enumerate(parts[1:]))


_STAGE2_LOOP = '''  const size_t total_c = static_cast<size_t>(a.batch) * n;
  uint8_t* const ebuf[2] = {a.e_i, g_ebuf1};
  if (a.max_iter == 0) {
    for (size_t x = g; x < total_c; x += stride) a.e_c[x] = __ldg(a.prior_c + x) < 0.0f;
    for (size_t x = g; x < total_c * a.p; x += stride) a.e_i[x] = __ldg(a.prior_i + x) < 0.0f;
    for (int b = g; b < a.batch; b += stride) a.conv[b] = 0, a.iters[b] = 0;
    return;
  }
  for (int b = g; b < a.batch; b += stride) a.iters[b] = 1;
  // Iteration it: sweep A tests iteration it - 1's syndrome and runs the
  // check update of it for the frames that ran it - 1 (the bitmask); after
  // the barrier the bitmask becomes the frames that run it; sweep B is
  // their variable update.  At it == max_iter sweep A only tests.
  int it = 0;
  for (;; ++it) {
    const bool update = it < a.max_iter;
    int* tested = a.flags + ((it + 1) & 1) * a.batch;  // it - 1's bad flags, set now
    for (int tile = blockIdx.x; tile < row_tiles; tile += gridDim.x) {
      const int bp = tile / tiles, b = bp / a.p;
      if (!(run[b / 32] >> (b % 32) & 1)) continue;
      const int i = (tile - bp * tiles) * kThreads + threadIdx.x;
      int wrong = 0;
      if (i < n) {
        const int* k = ks + (bp - b * a.p) * a.w;
        wrong = update ? check_row<MAXW, MIN_SUM>(a, k, bp, b, i, it == 0, it >= 1, ebuf[(it + 1) & 1],
                                                  ebuf[it & 1])
                       : syndrome_wrong<MAXW>(a, k, bp, b, i, ebuf[(it + 1) & 1]);
      }
      if (it >= 1 && __syncthreads_or(wrong) && threadIdx.x == 0) atomicOr(tested + b, 1);
    }
    grid.sync();
    if (it >= 1) {
      int any = 0;
      for (int x = warp; x < words; x += kThreads / 32) {
        const int b = 32 * x + lane;
        const unsigned bits = __ballot_sync(0xffffffffu, b < a.batch && __ldcg(tested + b));
        run[x] = bits;
        any |= bits != 0;
      }
      if (!__syncthreads_or(any)) break;
      if (update) {
        for (int b = g; b < a.batch; b += stride) {
          if (run[b / 32] >> (b % 32) & 1) a.iters[b] = it + 1;
        }
      }
    }
    if (!update) break;
    int* next = a.flags + (it & 1) * a.batch;  // it's flags, set in the next sweep A
    for (int b = g; b < a.batch; b += stride) next[b] = 0;
    for (int tile = blockIdx.x; tile < var_tiles; tile += gridDim.x) {
      const int b = tile / tiles;
      if (!(run[b / 32] >> (b % 32) & 1)) continue;
      const int j = (tile - b * tiles) * kThreads + threadIdx.x;
      if (j < n) variable<MAXW>(a, ks, b, j);
    }
    grid.sync();
  }

  for (int b = g; b < a.batch; b += stride) a.conv[b] = !(run[b / 32] >> (b % 32) & 1);
  const size_t frame_i = static_cast<size_t>(a.p) * n;
  for (size_t x = g; x < total_c * a.p; x += stride) {
    if (((a.iters[x / frame_i] - 1) & 1) == 1) a.e_i[x] = ebuf[1][x];
  }
}

'''


def stage2_copy(src):
    """``src`` with the syndrome test folded into the next check sweep."""
    r = _replace
    src = r(src, '''template <int MAXW, bool MIN_SUM>
__device__ __forceinline__ void check_row(const Args& a, const int* k, int bp, int b, int i, bool first) {
  const int n = a.n, w = a.w;''', '''template <int MAXW, bool MIN_SUM>
__device__ __forceinline__ int check_row(const Args& a, const int* k, int bp, int b, int i, bool first, bool test,
                                         const uint8_t* e_prev, uint8_t* e_out) {
  const int n = a.n, w = a.w;''')
    src = r(src, '''  int parity = __ldg(a.syn + row) ^ static_cast<int>(neg_i);
''', '''  const int syn = __ldg(a.syn + row);
  int parity = syn ^ static_cast<int>(neg_i);
  int s = test ? e_prev[row] : 0;
''')
    src = r(src, '''        m[t] = fminf(fmaxf(tot[j] - c2v_i[static_cast<size_t>(t) * a.ld], -kBig), kBig);''',
            '''        const float tj = tot[j];
        s += tj < 0.0f;
        m[t] = fminf(fmaxf(tj - c2v_i[static_cast<size_t>(t) * a.ld], -kBig), kBig);''')
    src = r(src, '''  a.e_i[row] = p_i + ((parity ^ static_cast<int>(neg_i)) ? -ext_i : ext_i) < 0.0f;
}''', '''  e_out[row] = p_i + ((parity ^ static_cast<int>(neg_i)) ? -ext_i : ext_i) < 0.0f;
  return test && (s & 1) != syn;
}''')
    src = r(src, '''__device__ __forceinline__ int syndrome_wrong(const Args& a, const int* k, int bp, int b, int i) {
  const int n = a.n;
  const size_t row = static_cast<size_t>(bp) * n + i;
  const uint8_t* e_c = a.e_c + static_cast<size_t>(b) * n;
  int s = a.e_i[row];''', '''__device__ __forceinline__ int syndrome_wrong(const Args& a, const int* k, int bp, int b, int i,
                                              const uint8_t* e) {
  const int n = a.n;
  const size_t row = static_cast<size_t>(bp) * n + i;
  const uint8_t* e_c = a.e_c + static_cast<size_t>(b) * n;
  int s = e[row];''')
    start, end = src.index("  int it = 0;\n  while (it < a.max_iter) {"), src.index("using DecodeKernel = void (*)(Args);")
    src = src[:start] + _STAGE2_LOOP + src[end:]
    src = r(src, "namespace {\n\nconstexpr float kBig", "namespace {\n\n__device__ uint8_t g_ebuf1[1 << 22];  // the "
            "second buffer of identity decisions (B * P * N <= 2^22)\n\nconstexpr float kBig")
    return r(src, "  if (batch == 0) return 0;\n", "  if (batch == 0) return 0;\n  if (static_cast<long long>(batch) "
             "* p * n > (1 << 22)) return static_cast<int>(cudaErrorInvalidValue);\n")


def write(out_dir, src_path=SOURCE):
    """Write every copy of ``src_path`` into ``out_dir``; returns {name: path}."""
    src = Path(src_path).read_text()
    texts = {name: floor_copy(src, sweeps) for name, sweeps in FLOORS.items()}
    texts["stage2"] = stage2_copy(src)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in texts.items():
        paths[name] = out_dir / f"{name}.cu"
        paths[name].write_text(text)
    return paths


if __name__ == "__main__":
    for name, path in write(sys.argv[1] if len(sys.argv) > 1 else "build/k8_variants").items():
        print(name, path)
