// Fused residual epilogue out = LayerNorm(x + dropout(sub)) on [N, H] rows,
// for Hopper (sm_90a): what the forward (fused_residual_fwd.cu) and the
// backward (fused_residual_bwd.cu) share.
//
// Replaces the Pallas pair in paddle_tpu/kernels/pallas/fused_residual.py
// (`_fwd_kernel` :36, `_bwd_kernel` :57). As there: IO in the input type,
// fp32 math; the keep mask is drawn in the kernel and regenerated in the
// backward from the same seed (never in device memory); the forward saves
// only the per-row fp32 (mean, rstd) [2, N], with var = E[h^2] - mean^2
// clamped at 0; the backward recomputes h from (x, sub, seed) and writes
// dx, d(sub) and per-CTA fp32 dweight/dbias partials in one pass, the small
// sum across CTAs left to the caller (fused_residual.py:149 does it in
// XLA). The mask word of element (n, c) is Philox(seed, SALT_FUSED_LN, row
// n, column c) (philox.cuh), where the Pallas kernel seeds per row tile.
//
// Design: one warp per row. Lane l owns the column groups [4l + 128k, +4)
// (one 8- or 16-byte vector and one Philox call each), so every lane keeps
// to its own columns from load to store and a row needs no block barrier:
// two warp reductions (shuffles) per row. Per-warp scratch rows live in
// shared memory. Bound on the H100: bytes (both move a few bytes per fp32
// operation), see each launcher.

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kRowWarps = 4;  // rows (warps) per CTA
constexpr int kRowThreads = kRowWarps * 32;

// h = x + dropout(sub) for the 4 columns at c of row `row`.
template <typename T, bool kDrop>
__device__ __forceinline__ void residual4(const T* x, const T* s, long row,
                                          int c, const DropParams& d,
                                          float h[4]) {
  const Vec4<T> xv = load4(x + c);
  const Vec4<T> sv = load4(s + c);
  uint4 w;
  if constexpr (kDrop)
    w = keep_words(d, (uint32_t)(c >> 2), (uint32_t)row,
                   (uint32_t)(row >> 32), kSaltFusedLn);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float sf = to_f(sv.v[e]);
    if constexpr (kDrop) sf = apply_keep(d, word_of(w, e), sf);
    h[e] = to_f(xv.v[e]) + sf;
  }
}

}  // namespace
