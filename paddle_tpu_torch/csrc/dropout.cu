// Dropout on a [rows, cols] view, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/dropout.py `_dropout_kernel`
// (dropout.py:21, launched by `_dropout_2d`). As there, the backward is
// this same kernel applied to the cotangent with the forward's seed: the
// keep mask never exists in device memory in either direction.
//
// out[n, c] = keep(n, c) ? x[n, c] * scale : 0, computed in fp32 and
// rounded to x's type (bf16 or fp32), with keep(n, c) the Philox word of
// (seed, SALT_DROPOUT, row n, column c) against the rate's threshold
// (philox.cuh; kernels/philox.py `row_keep` is the plain version, bit for
// bit). The view is [numel / cols, cols] with cols the tensor's last axis,
// so the mask does not depend on how the caller tiles the rows.
//
// Design: one thread per group of 4 columns of a row (one Philox call, 4
// words), a grid-stride loop over the groups; where cols % 4 == 0 and the
// tensors are aligned the 4 elements move as one 8-byte (bf16) or 16-byte
// (fp32) vector. Bound on the H100: bytes, each element read and written
// once (BERT's embedding output [64, 512, 768] bf16: 100.7 MB, 30 us at
// 3.35 TB/s); the Philox rounds are integer work of about the same order
// (10 rounds of 2 wide multiplies per 4 elements), which a later version
// could halve by drawing 8 columns from one call at rates >= 1/2^16.

#include <cuda_runtime.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

template <typename T, bool kVec>
__global__ void __launch_bounds__(256)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long rows,
                   int cols, DropParams d) {
  d = resolved(d);  // the seed's words, read once (philox.cuh)
  const long groups = (cols + 3) / 4;
  const long total = rows * groups;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long g = (long)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += stride) {
    const long row = g / groups;
    const int c0 = (int)(g - row * groups) * 4;
    const uint4 w = keep_words(d, (uint32_t)(c0 >> 2), (uint32_t)row,
                               (uint32_t)(row >> 32), kSaltDropout);
    const long base = row * cols + c0;
    if constexpr (kVec) {
      Vec4<T> v = load4(x + base);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v.v[e] = from_f<T>(apply_keep(d, word_of(w, e), to_f(v.v[e])));
      store4(out + base, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c0 + e < cols) {
          out[base + e] =
              from_f<T>(apply_keep(d, word_of(w, e), to_f(x[base + e])));
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, long rows, int cols,
                   const DropParams& d, cudaStream_t st) {
  const long total = rows * ((cols + 3) / 4);
  const long want = (total + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132L * 16 ? want : 132L * 16);
  const bool vec = cols % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T))) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T))) == 0;
  if (vec) {
    dropout_kernel<T, true><<<blocks, 256, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), rows, cols, d);
  } else {
    dropout_kernel<T, false><<<blocks, 256, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), rows, cols, d);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success). The caller has checked that x and out are contiguous
// [rows, cols] of one type (bf16 or fp32) and that rows, cols > 0; scale is
// 1 / (1 - rate) in fp32 (1 for downscale_in_infer's training form).
extern "C" int dropout_fwd(const void* x, void* out, long rows, int cols,
                           int is_bf16, unsigned seed_lo, unsigned seed_hi,
                           unsigned threshold, float scale, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const DropParams d{seed_lo, seed_hi, threshold, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, out, rows, cols, d, st)
                       : launch<float>(x, out, rows, cols, d, st));
}
