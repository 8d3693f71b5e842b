// Fused residual epilogue, backward: from x, sub, w, the forward's row
// stats, the seed and dy, one pass gives dx, d(sub) and per-CTA partials of
// dweight and dbias.
//
// Replaces: paddle_tpu/kernels/pallas/fused_residual.py `_bwd_kernel`
// (fused_residual.py:57, launched by `_fused_bwd`). fused_residual.cuh
// gives the contract, the mask and the design. Per row, with
// xhat = (h - mean) * rstd recomputed from (x, sub, seed) and the stats:
//   dxhat = dy * w
//   dh    = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//   dx    = dh,   d(sub) = keep ? dh * scale : 0        (input type)
//   dw   += dy * xhat,   db += dy                          (fp32)
// A fixed grid of CTAs walks the rows, 4 warps a CTA, each warp keeping its
// row's xhat and dxhat and its own fp32 dw/db columns in shared memory; at
// the end the CTA adds its 4 warps' columns into row blockIdx.x of the
// partials [2, G, H] (dw, then db). The caller sums the G rows in fp32.
//
// Bound on the H100: bytes, x, sub, dy read once and dx, d(sub) written once
// (w, the stats and the partials are small): BERT-base's [32768, 768] bf16
// is 252 MB, 75 us at 3.35 TB/s.

#include "fused_residual.cuh"

namespace {

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kRowThreads)
    fused_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ s,
                        const T* __restrict__ w, const float* __restrict__ stats,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        T* __restrict__ ds, float* __restrict__ parts, long N,
                        int H, DropParams d) {
  d = resolved(d);  // the seed's words, read once (philox.cuh)
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // per warp: xhat [H], dxhat [H], dw [H], db [H]
  float* xh_s = smem + (long)warp * 4 * H;
  float* dxh_s = xh_s + H;
  float* dw_s = xh_s + 2 * H;
  float* db_s = xh_s + 3 * H;
  for (int c = lane * 4; c < H; c += 128) {
    *reinterpret_cast<float4*>(dw_s + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(db_s + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (long row = (long)blockIdx.x * kRowWarps + warp; row < N;
       row += (long)gridDim.x * kRowWarps) {
    const float mean = stats[row];
    const float rstd = stats[N + row];
    const T* xr = x + row * H;
    const T* sr = s + row * H;
    const T* gr = dy + row * H;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane * 4; c < H; c += 128) {
      float h[4];
      residual4<T, kDrop>(xr, sr, row, c, d, h);
      const Vec4<T> gv = load4(gr + c);
      const Vec4<T> wv = load4(w + c);
      float xh[4], dxh[4];
      float4 dw4 = *reinterpret_cast<float4*>(dw_s + c);
      float4 db4 = *reinterpret_cast<float4*>(db_s + c);
      float* dwp = reinterpret_cast<float*>(&dw4);
      float* dbp = reinterpret_cast<float*>(&db4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float g = to_f(gv.v[e]);
        xh[e] = (h[e] - mean) * rstd;
        dxh[e] = g * to_f(wv.v[e]);
        s1 += dxh[e];
        s2 += dxh[e] * xh[e];
        dwp[e] += g * xh[e];
        dbp[e] += g;
      }
      *reinterpret_cast<float4*>(dw_s + c) = dw4;
      *reinterpret_cast<float4*>(db_s + c) = db4;
      *reinterpret_cast<float4*>(xh_s + c) =
          make_float4(xh[0], xh[1], xh[2], xh[3]);
      *reinterpret_cast<float4*>(dxh_s + c) =
          make_float4(dxh[0], dxh[1], dxh[2], dxh[3]);
    }
    const float m1 = warp_sum(s1) / H;
    const float m2 = warp_sum(s2) / H;
    T* dxr = dx + row * H;
    T* dsr = ds + row * H;
    for (int c = lane * 4; c < H; c += 128) {
      const float4 xh4 = *reinterpret_cast<const float4*>(xh_s + c);
      const float4 dxh4 = *reinterpret_cast<const float4*>(dxh_s + c);
      const float xh[4] = {xh4.x, xh4.y, xh4.z, xh4.w};
      const float dxh[4] = {dxh4.x, dxh4.y, dxh4.z, dxh4.w};
      uint4 wd;
      if constexpr (kDrop)
        wd = keep_words(d, (uint32_t)(c >> 2), (uint32_t)row,
                        (uint32_t)(row >> 32), kSaltFusedLn);
      Vec4<T> dxv, dsv;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dh = rstd * (dxh[e] - m1 - xh[e] * m2);
        dxv.v[e] = from_f<T>(dh);
        float dsub = dh;
        if constexpr (kDrop) dsub = apply_keep(d, word_of(wd, e), dh);
        dsv.v[e] = from_f<T>(dsub);
      }
      store4(dxr + c, dxv);
      store4(dsr + c, dsv);
    }
  }
  __syncthreads();
  // this CTA's partials: the sum of its warps' columns
  for (int c = threadIdx.x; c < H; c += kRowThreads) {
    float dw = 0.0f, db = 0.0f;
#pragma unroll
    for (int k = 0; k < kRowWarps; ++k) {
      dw += smem[(long)k * 4 * H + 2 * H + c];
      db += smem[(long)k * 4 * H + 3 * H + c];
    }
    parts[(long)blockIdx.x * H + c] = dw;
    parts[((long)gridDim.x + blockIdx.x) * H + c] = db;
  }
}

template <typename T, bool kDrop>
cudaError_t launch(const void* x, const void* s, const void* w,
                   const float* stats, const void* dy, void* dx, void* ds,
                   float* parts, int grid, long N, int H, const DropParams& d,
                   cudaStream_t st) {
  auto kernel = fused_ln_bwd_kernel<T, kDrop>;
  const int smem = kRowWarps * 4 * H * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kRowThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(s),
      static_cast<const T*>(w), stats, static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<T*>(ds), parts, N, H, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dropout, const void* x, const void* s,
                     const void* w, const float* stats, const void* dy,
                     void* dx, void* ds, float* parts, int grid, long N,
                     int H, const DropParams& d, cudaStream_t st) {
  return dropout ? launch<T, true>(x, s, w, stats, dy, dx, ds, parts, grid,
                                   N, H, d, st)
                 : launch<T, false>(x, s, w, stats, dy, dx, ds, parts, grid,
                                    N, H, d, st);
}

}  // namespace

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success). The caller has checked: x, sub, dy, dx and d(sub)
// contiguous [N, H] and w [H], of one type (bf16 or fp32) and 16-byte
// aligned; stats [2, N] fp32 from the forward; parts [2, grid, H] fp32; H a
// multiple of 4 with 16 * H floats of shared memory within the card's
// limit. The dropout arguments are the forward's.
extern "C" int fused_add_dropout_ln_bwd(
    const void* x, const void* sub, const void* w, const void* stats,
    const void* dy, void* dx, void* dsub, void* parts, int grid, long N,
    int H, int is_bf16, int dropout, unsigned seed_lo, unsigned seed_hi,
    unsigned threshold, float scale, void* stream) {
  if (N <= 0 || H <= 0 || H % 4 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const DropParams d{seed_lo, seed_hi, threshold, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* stp = static_cast<const float*>(stats);
  float* pp = static_cast<float*>(parts);
  return (int)(is_bf16
                   ? dispatch<__nv_bfloat16>(dropout, x, sub, w, stp, dy, dx,
                                             dsub, pp, grid, N, H, d, st)
                   : dispatch<float>(dropout, x, sub, w, stp, dy, dx, dsub,
                                     pp, grid, N, H, d, st));
}
