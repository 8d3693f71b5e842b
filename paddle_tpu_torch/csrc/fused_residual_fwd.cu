// Fused residual epilogue, forward: out = LayerNorm(x + dropout(sub)).
//
// Replaces: paddle_tpu/kernels/pallas/fused_residual.py `_fwd_kernel`
// (fused_residual.py:36, launched by `_fused_fwd`). fused_residual.cuh gives
// the contract, the mask and the design; here each warp stages its row's h
// in shared memory (4 rows per CTA), sums h and h^2 in one pass, then
// writes (h - mean) * rstd * w + b in the input type and the row's fp32
// (mean, rstd) into stats [2, N].
//
// Bound on the H100: bytes, x and sub read once, out written once, w and b
// and the stats negligible: BERT-base's [32768, 768] bf16 is 151 MB, 45 us
// at 3.35 TB/s (its ~10 fp32 operations an element are 0.25 GFLOP).

#include "fused_residual.cuh"

namespace {

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kRowThreads)
    fused_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ s,
                        const T* __restrict__ w, const T* __restrict__ b,
                        T* __restrict__ out, float* __restrict__ stats,
                        long N, int H, float eps, DropParams d) {
  d = resolved(d);  // the seed's words, read once (philox.cuh)
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kRowWarps + warp;
  if (row >= N) return;  // no block barrier below: whole warps leave
  float* hs = smem + (long)warp * H;
  const T* xr = x + row * H;
  const T* sr = s + row * H;
  float sum = 0.0f, sq = 0.0f;
  for (int c = lane * 4; c < H; c += 128) {
    float h[4];
    residual4<T, kDrop>(xr, sr, row, c, d, h);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sum += h[e];
      sq += h[e] * h[e];
    }
    *reinterpret_cast<float4*>(hs + c) = make_float4(h[0], h[1], h[2], h[3]);
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mean = sum / H;
  const float var = fmaxf(sq / H - mean * mean, 0.0f);
  const float rstd = 1.0f / sqrtf(var + eps);
  T* orow = out + row * H;
  for (int c = lane * 4; c < H; c += 128) {
    const float4 h4 = *reinterpret_cast<const float4*>(hs + c);
    const float h[4] = {h4.x, h4.y, h4.z, h4.w};
    const Vec4<T> wv = load4(w + c);
    const Vec4<T> bv = load4(b + c);
    Vec4<T> o;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o.v[e] = from_f<T>((h[e] - mean) * rstd * to_f(wv.v[e]) +
                         to_f(bv.v[e]));
    store4(orow + c, o);
  }
  if (lane == 0) {
    stats[row] = mean;
    stats[N + row] = rstd;
  }
}

template <typename T, bool kDrop>
cudaError_t launch(const void* x, const void* s, const void* w,
                   const void* b, void* out, float* stats, long N, int H,
                   float eps, const DropParams& d, cudaStream_t st) {
  auto kernel = fused_ln_fwd_kernel<T, kDrop>;
  const int smem = kRowWarps * H * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((N + kRowWarps - 1) / kRowWarps);
  kernel<<<blocks, kRowThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(s),
      static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(out),
      stats, N, H, eps, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dropout, const void* x, const void* s,
                     const void* w, const void* b, void* out, float* stats,
                     long N, int H, float eps, const DropParams& d,
                     cudaStream_t st) {
  return dropout ? launch<T, true>(x, s, w, b, out, stats, N, H, eps, d, st)
                 : launch<T, false>(x, s, w, b, out, stats, N, H, eps, d, st);
}

}  // namespace

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success). The caller has checked: x, sub and out contiguous [N, H]
// and w, b [H], all of one type (bf16 or fp32) and 16-byte aligned; H a
// multiple of 4 with 4 * H floats of shared memory within the card's limit;
// stats [2, N] fp32.
extern "C" int fused_add_dropout_ln_fwd(
    const void* x, const void* sub, const void* w, const void* b, void* out,
    void* stats, long N, int H, float eps, int is_bf16, int dropout,
    unsigned seed_lo, unsigned seed_hi, unsigned threshold, float scale,
    void* stream) {
  if (N <= 0 || H <= 0 || H % 4) return (int)cudaErrorInvalidValue;
  const DropParams d{seed_lo, seed_hi, threshold, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* st_ptr = static_cast<float*>(stats);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(dropout, x, sub, w, b, out,
                                                 st_ptr, N, H, eps, d, st)
                       : dispatch<float>(dropout, x, sub, w, b, out, st_ptr,
                                         N, H, eps, d, st));
}
