// Element-type helpers shared by the port's kernels: the kernels read and
// write bf16 or fp32 and compute in fp32.

#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to does
}

// Four consecutive elements as one aligned vector (8 bytes of bf16, 16 of
// fp32): the row kernels' unit of load, store and Philox call.
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename T>
__device__ __forceinline__ Vec4<T> load4(const T* p) {
  return *reinterpret_cast<const Vec4<T>*>(p);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const Vec4<T>& v) {
  *reinterpret_cast<Vec4<T>*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
