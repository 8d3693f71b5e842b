// The flash backwards' ordered dq sum, for Hopper (sm_90a): dq = (the
// partial slabs of dq_parts.cuh added in kv-tile order) * sm_scale, in the
// input type.
//
// Replaces no TPU kernel of its own: it is the last step of every flash
// backward (flash_pair_bwd.cu, flash_attention_bwd.cu), which the Pallas
// kernels do inside their grid, where the kv tiles run one after another
// and dq's scratch sums them in that order
// (paddle_tpu/kernels/pallas/flash_pair.py `_pair_bwd_fused_kernel`,
// flash_attention.py `_flash_bwd_fused_kernel` / `_flash_dq_kernel`). On
// the card the kv tiles run at once, so the bodies store each tile's
// partials apart and this kernel adds them in the reference's order: dq
// is the same bit for bit from launch to launch.
//
// What bounds it: bytes. Each dq element reads its row's slabs (every
// slab without causality or lengths; up to its diagonal's under
// causality) and writes one value: at LLaMA-7B's training shape (B=4,
// L=2048, H=32, D=128, causal, 16 slabs) ~1.1 GB read, 0.34 ms at 3.35
// TB/s. The design: one thread a group of four consecutive elements
// (16-byte loads, neighbouring threads on neighbouring addresses), a
// grid-stride loop, the row's slab count computed once a group
// (dq_parts_of_row); four fp32 sums in registers, added in slab order
// from 0.0f, then scaled once and rounded (round to nearest even, as
// torch's .to does). The plain version (kernels/dq_sum.py) adds the same
// slabs in the same order, so the two agree bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"
#include "dq_parts.cuh"

namespace {

template <typename T>
__global__ void dq_sum_kernel(const float* __restrict__ parts, long slab,
                              T* __restrict__ dq, long dq_row,
                              const int* __restrict__ lens, int Lq, int Lk,
                              int hd, int causal, DqParts g, float scale) {
  const long n4 = slab / 4;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i4 = (long)blockIdx.x * blockDim.x + threadIdx.x; i4 < n4;
       i4 += stride) {
    const long i = 4 * i4;
    const long row = i / hd;  // b * Lq + r
    const int b = (int)(row / Lq), r = (int)(row % Lq);
    const int len = lens ? max(0, min(Lk, lens[b])) : Lk;
    const int n = dq_parts_of_row(r, len, Lq, Lk, causal, g);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < n; ++p) {
      const float4 v =
          *reinterpret_cast<const float4*>(parts + (long)p * slab + i);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    Vec4<T> out;
    out.v[0] = from_f<T>(acc.x * scale);
    out.v[1] = from_f<T>(acc.y * scale);
    out.v[2] = from_f<T>(acc.z * scale);
    out.v[3] = from_f<T>(acc.w * scale);
    store4(dq + row * dq_row + i % hd, out);
  }
}

}  // namespace

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success). The caller has checked shapes, types and alignment:
// parts holds the slabs of a backward, each [B, Lq, hd] fp32 (slab =
// B * Lq * hd floats, hd a multiple of 4, 16-byte aligned); dq is [B, Lq,
// hd] of the input type with rows dq_row elements apart (8-byte aligned
// in bf16); lens ([B] int32) may be null; kv_tile and per_tile are the
// body's part geometry (dq_parts_geometry), causal and the lengths the
// backward's.
extern "C" int dq_ordered_sum(const void* parts, long slab, void* dq,
                              long dq_row, const void* lens, int Lq, int Lk,
                              int hd, int causal, int kv_tile, int per_tile,
                              float scale, int is_bf16, void* stream) {
  if (slab <= 0 || Lq <= 0 || hd <= 0 || hd % 4 || slab % ((long)Lq * hd) ||
      kv_tile <= 0 || per_tile <= 0)
    return (int)cudaErrorInvalidValue;
  const long blocks = (slab / 4 + 255) / 256;
  const unsigned grid =
      (unsigned)(blocks < 132L * 16 ? (blocks > 0 ? blocks : 1) : 132L * 16);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DqParts g{kv_tile, per_tile};
  const float* src = static_cast<const float*>(parts);
  const int* ln = static_cast<const int*>(lens);
  if (is_bf16)
    dq_sum_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        src, slab, static_cast<__nv_bfloat16*>(dq), dq_row, ln, Lq, Lk, hd,
        causal, g, scale);
  else
    dq_sum_kernel<float><<<grid, 256, 0, st>>>(
        src, slab, static_cast<float*>(dq), dq_row, ln, Lq, Lk, hd, causal,
        g, scale);
  return (int)cudaGetLastError();
}
