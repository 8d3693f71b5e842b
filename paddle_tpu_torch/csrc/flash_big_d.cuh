// Flash attention in fp32 for heads above 256 (any multiple of 64: 320,
// 384, 512, ...), forward and backward, on both launchers. Included by
// flash_attention.cuh, whose contracts these kernels compute (the math,
// the rounding points, the masks and the dropout keying are set out
// there); flash_fwd and flash_bwd dispatch every fp32 D > 256 here (bf16
// runs the wgmma kernels of flash_wide_sm90.cuh). The wrappers run any
// other D > 256 on zero-padded heads.
//
// Replaces, at those head sizes in fp32: paddle_tpu/kernels/pallas/
// flash_attention.py `_flash_fwd_kernel`, `_flash_bwd_fused_kernel` and
// `_flash_dq_kernel` + `_flash_dkv_kernel` (the JAX `flash_attention_blhd`
// takes any D), and flash_pair.py `_pair_fwd_kernel` / `_pair_bwd_fused_
// kernel` (the pair gate admits 384, 512, ...).
//
// What bounds them on the H100: the same operations as at smaller heads
// (4*D and 10*D an attended pair), on the SIMT pipes in fp32 (plain FMA:
// TF32 would miss the fp32 reference). The design is the simple one that
// is right: no accumulator of D columns fits in registers, so the
// accumulators live in an fp32 global scratch that the CTA owns
// exclusively (no atomics there), and every tile is walked in chunks of 64
// columns through shared memory.
//
// * Forward: one CTA of 256 threads per (64-row q tile, q head, batch
//   row), four threads a q row, sixteen keys each. Two passes over the kv
//   tiles: the first takes the row max m and the sum l of the undropped
//   exp(s - m) (online), the second recomputes s, forms p = exp(s - m)
//   with the final m (the plain version's exact form), times the keep
//   factor, and adds P.V chunk by chunk to the scratch; then out = acc /
//   max(l, 1e-30), lse = m + log(max(l, 1e-30)).
// * Backward: one CTA per (64-row kv tile, KV head, batch row), dK and dV
//   in the scratch for the whole walk over the group's q heads and the q
//   tiles from the causal diagonal down; per step s and dp over D chunks,
//   p and ds in shared memory, then per chunk dV += P^T dO, dK += dS^T q
//   (unscaled) into the scratch and dQ partial = dS K by fp32 atomics into
//   dq's scratch (unscaled; the conversion scales it). A kv tile past the
//   length writes zero dK, dV.
// * Dropout: a thread's sixteen keys of one q row are four Philox groups,
//   one call each, keyed on absolute positions as every other kernel.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace {
namespace bigd {

constexpr int kT = 64;          // rows of a tile, columns of a chunk
constexpr int kThr = 256;
constexpr int kLd = kT + 1;     // fp32 tile row stride (floats)
constexpr int kTile = kT * kLd;

// rows [r0, r0 + 64) x columns [c0, c0 + 64) of rows `row` elements apart
// into a tile; rows at or past L read as zero; with kScale each value is
// multiplied by `scale`
template <bool kScale>
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int r0, int L, long row, int c0,
                                           float scale) {
  for (int i = threadIdx.x; i < kT * kT; i += kThr) {
    const int r = i / kT, c = i % kT;
    float x = 0.0f;
    if (r0 + r < L) {
      x = src[(long)(r0 + r) * row + c0 + c];
      if (kScale) x = x * scale;
    }
    dst[r * kLd + c] = x;
  }
}

// acc[k] += the sum over the chunk's 64 columns of A[r][:] . B[c + k][:],
// taken apart and then added (short fp32 chains at every D)
__device__ __forceinline__ void dot_rows(float (&acc)[16], const float* A,
                                         const float* Bt, int r, int c) {
  float part[16] = {};
#pragma unroll 4
  for (int d = 0; d < kT; ++d) {
    const float x = A[r * kLd + d];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      part[k] = fmaf(x, Bt[(c + k) * kLd + d], part[k]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] += part[k];
}

// acc[k] = sum over the tile's 64 rows j of A[j][r] . B[j][c + k]
__device__ __forceinline__ void dot_cols(float (&acc)[16], const float* A,
                                         const float* B, int r, int c) {
#pragma unroll 4
  for (int j = 0; j < kT; ++j) {
    const float x = A[j * kLd + r];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = fmaf(x, B[j * kLd + c + k], acc[k]);
  }
}

// the keep factors of keys [key0, key0 + 16) of q row `qrow`
__device__ __forceinline__ void keep16(float (&f)[16], const DropParams& d,
                                       int key0, int qrow, uint32_t bh) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint4 words = keep_words(d, (uint32_t)(key0 + 4 * w) >> 2,
                                   (uint32_t)qrow, bh, kSaltAttention);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[4 * w + e] = keep_factor(d, word_of(words, e));
  }
}

template <bool kDrop, bool kSegs>
__global__ void __launch_bounds__(kThr) flash_fwd_big_kernel(FwdArgs a,
                                                             float* o_acc,
                                                             int D) {
  using T = float;
  extern __shared__ __align__(16) float sm[];
  float* Qc = sm;
  float* Kc = Qc + kTile;
  float* Vc = Kc + kTile;
  float* Ps = Vc + kTile;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const Mask<kSegs> mask = mask_of<kSegs>(a, b);
  const T* qg = static_cast<const T*>(a.q) + (long)b * a.Lq * a.q_row +
                (long)h * D;
  const long kv_base = (long)b * a.Lk * a.kv_row + (long)hk * D;
  const T* kg = static_cast<const T*>(a.k) + kv_base;
  const T* vg = static_cast<const T*>(a.v) + kv_base;
  // the CTA's rows of the scratch and of out, [B, Lq, H, D] rows o_row
  // apart
  const long o_base = (long)b * a.Lq * a.o_row + (long)h * D;
  float* acc_g = o_acc + o_base;
  T* og = static_cast<T*>(a.out) + o_base;
  const int r = threadIdx.x / 4;   // this thread's q row of the tile
  const int cg = (threadIdx.x % 4) * 16;
  const int qrow = q0 + r;
  const int kv_end =
      a.causal ? min(mask.len, max(0, q0 + kT + mask.offset)) : mask.len;

  auto scores = [&](float (&s)[16], int n0) {
#pragma unroll
    for (int k = 0; k < 16; ++k) s[k] = 0.0f;
    for (int c0 = 0; c0 < D; c0 += kT) {
      __syncthreads();
      load_chunk<true>(Qc, qg, q0, a.Lq, a.q_row, c0, a.sm_scale);
      load_chunk<false>(Kc, kg, n0, a.Lk, a.kv_row, c0, 1.0f);
      __syncthreads();
      dot_rows(s, Qc, Kc, r, cg);
    }
  };

  // pass 1: the row max m and the row sum l of the undropped exp(s - m)
  float m = kNegInf, l = 0.0f;
  for (int n0 = 0; n0 < kv_end; n0 += kT) {
    float s[16];
    scores(s, n0);
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (mask(qrow, n0 + cg + k)) mx = fmaxf(mx, s[k]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (mask(qrow, n0 + cg + k)) sum += expf(s[k] - mn);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * expf(m - mn) + sum;
    m = mn;
  }

  // pass 2: acc = (p * keep) . V with p at the final m
  if (qrow < a.Lq)
    for (int c = cg; c < D; c += kT)
#pragma unroll
      for (int k = 0; k < 16; ++k) acc_g[(long)qrow * a.o_row + c + k] = 0.0f;
  for (int n0 = 0; n0 < kv_end; n0 += kT) {
    float s[16];
    scores(s, n0);
    float f[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) f[k] = 1.0f;
    if constexpr (kDrop) keep16(f, a.drop, n0 + cg, qrow, bh);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float p = mask(qrow, n0 + cg + k) ? expf(s[k] - m) : 0.0f;
      Ps[r * kLd + cg + k] = p * f[k];
    }
    for (int c0 = 0; c0 < D; c0 += kT) {
      __syncthreads();  // P written; the previous chunk's V consumed
      load_chunk<false>(Vc, vg, n0, a.Lk, a.kv_row, c0, 1.0f);
      __syncthreads();
      float o[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) o[k] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < kT; ++j) {
        const float p = Ps[r * kLd + j];
#pragma unroll
        for (int k = 0; k < 16; ++k) o[k] = fmaf(p, Vc[j * kLd + cg + k], o[k]);
      }
      if (qrow < a.Lq) {
        float* dst = acc_g + (long)qrow * a.o_row + c0 + cg;
#pragma unroll
        for (int k = 0; k < 16; ++k) dst[k] += o[k];
      }
    }
  }

  // rows with no visible key keep acc = 0, l = 0: output 0
  if (qrow < a.Lq) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    for (int c = cg; c < D; c += kT)
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const long at = (long)qrow * a.o_row + c + k;
        og[at] = acc_g[at] * inv;
      }
    if (threadIdx.x % 4 == 0)
      a.lse[((long)b * a.H + h) * a.Lq + qrow] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <bool kDrop, bool kSegs>
cudaError_t launch_fwd(const FwdArgs& a, float* o_acc, int B, int D,
                       cudaStream_t stream) {
  if (D % kT || o_acc == nullptr) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_big_kernel<kDrop, kSegs>;
  const int bytes = 4 * kTile * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lq + kT - 1) / kT, a.H, B);
  kernel<<<grid, kThr, bytes, stream>>>(a, o_acc, D);
  return cudaGetLastError();
}

template <bool kDrop, bool kSegs>
__global__ void __launch_bounds__(kThr) flash_bwd_big_kernel(BwdArgs a,
                                                             int D) {
  using T = float;
  extern __shared__ __align__(16) float sm[];
  float* Qc = sm;
  float* Kc = Qc + kTile;
  float* Vc = Kc + kTile;
  float* DOc = Vc + kTile;
  float* Ps = DOc + kTile;   // p * keep, [q][kv]
  float* DSs = Ps + kTile;   // ds, [q][kv]
  float* Lse = DSs + kTile;
  float* Delta = Lse + kT;
  const int n0 = blockIdx.x * kT;  // kv tile 0 walks the most q tiles
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.H / a.Hkv;
  const long hd = (long)a.H * D;
  const Mask<kSegs> mask = mask_of<kSegs>(a, b);
  const long kv_base = (long)b * a.Lk * a.kv_row + (long)hk * D;
  const T* kg = static_cast<const T*>(a.k) + kv_base;
  const T* vg = static_cast<const T*>(a.v) + kv_base;
  const long dkv_base = (long)b * a.Lk * a.dkv_row + (long)hk * D;
  T* dk_out = static_cast<T*>(a.dk) + dkv_base;
  T* dv_out = static_cast<T*>(a.dv) + dkv_base;
  // the CTA's rows of the dk and dv scratch, [B, Lk, Hkv, D] each
  const long acc_row = (long)a.Hkv * D;
  const long acc_base = (long)b * a.Lk * acc_row + (long)hk * D;
  float* dk_acc = a.dkv_acc + acc_base;
  float* dv_acc = a.dkv_acc + (long)gridDim.z * a.Lk * acc_row + acc_base;
  const int r = threadIdx.x / 4;  // a row of the tile (q or kv)
  const int cg = (threadIdx.x % 4) * 16;
  const int kvrow = n0 + r;

  if (n0 >= mask.len) {
    // every key of this tile is past the length: zero dk, dv, no dq
    if (kvrow < a.Lk)
      for (int c = cg; c < D; c += kT)
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          dk_out[(long)kvrow * a.dkv_row + c + k] = 0.0f;
          dv_out[(long)kvrow * a.dkv_row + c + k] = 0.0f;
        }
    return;
  }
  if (kvrow < a.Lk)
    for (int c = cg; c < D; c += kT)
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        dk_acc[(long)kvrow * acc_row + c + k] = 0.0f;
        dv_acc[(long)kvrow * acc_row + c + k] = 0.0f;
      }

  const int first = a.causal ? max(0, n0 - mask.offset) : 0;
  const int m_begin = (first / kT) * kT;
  for (int gq = 0; gq < group; ++gq) {
    const int h = hk * group + gq;
    const uint32_t bh = (uint32_t)(b * a.H + h);
    const T* qg = static_cast<const T*>(a.q) + (long)b * a.Lq * a.q_row +
                  (long)h * D;
    const T* dog = static_cast<const T*>(a.dout) + (long)b * a.Lq * hd +
                   (long)h * D;
    float* dqg = a.dq_acc + (long)b * a.Lq * hd + (long)h * D;
    const long pad_row = ((long)b * a.H + h) * a.Lq_pad;
    for (int m0 = m_begin; m0 < a.Lq; m0 += kT) {
      const int qrow = m0 + r;
      // s and dp for q row r, keys [cg, cg + 16) of the tile
      float s[16], dp[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) s[k] = dp[k] = 0.0f;
      for (int c0 = 0; c0 < D; c0 += kT) {
        __syncthreads();
        load_chunk<true>(Qc, qg, m0, a.Lq, a.q_row, c0, a.sm_scale);
        load_chunk<false>(Kc, kg, n0, a.Lk, a.kv_row, c0, 1.0f);
        load_chunk<false>(DOc, dog, m0, a.Lq, hd, c0, 1.0f);
        load_chunk<false>(Vc, vg, n0, a.Lk, a.kv_row, c0, 1.0f);
        if (threadIdx.x < kT) {
          Lse[threadIdx.x] = a.lse_pad[pad_row + m0 + threadIdx.x];
          Delta[threadIdx.x] = a.delta[pad_row + m0 + threadIdx.x];
        }
        __syncthreads();
        dot_rows(s, Qc, Kc, r, cg);
        dot_rows(dp, DOc, Vc, r, cg);
      }
      float f[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) f[k] = 1.0f;
      if constexpr (kDrop) keep16(f, a.drop, n0 + cg, qrow, bh);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float p =
            mask(qrow, n0 + cg + k) ? expf(s[k] - Lse[r]) : 0.0f;
        Ps[r * kLd + cg + k] = p * f[k];
        DSs[r * kLd + cg + k] = p * (dp[k] * f[k] - Delta[r]);
      }
      for (int c0 = 0; c0 < D; c0 += kT) {
        __syncthreads();  // P, dS written; the previous chunk consumed
        load_chunk<false>(Qc, qg, m0, a.Lq, a.q_row, c0, 1.0f);
        load_chunk<false>(DOc, dog, m0, a.Lq, hd, c0, 1.0f);
        load_chunk<false>(Kc, kg, n0, a.Lk, a.kv_row, c0, 1.0f);
        __syncthreads();
        // dV, dK for kv row r, columns c0 + cg + [0, 16)
        float gv[16], gk[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) gv[k] = gk[k] = 0.0f;
        dot_cols(gv, Ps, DOc, r, cg);
        dot_cols(gk, DSs, Qc, r, cg);
        if (kvrow < a.Lk) {
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            dv_acc[(long)kvrow * acc_row + c0 + cg + k] += gv[k];
            dk_acc[(long)kvrow * acc_row + c0 + cg + k] += gk[k];
          }
        }
        // dQ partial for q row r, the same columns
        float gq16[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) gq16[k] = 0.0f;
#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          const float x = DSs[r * kLd + j];
#pragma unroll
          for (int k = 0; k < 16; ++k)
            gq16[k] = fmaf(x, Kc[j * kLd + cg + k], gq16[k]);
        }
        if (qrow < a.Lq) {
#pragma unroll
          for (int k = 0; k < 16; ++k)
            atomicAdd(dqg + (long)qrow * hd + c0 + cg + k, gq16[k]);
        }
      }
    }
  }

  // dk (scaled once) and dv, the group's fp32 sums
  if (kvrow < a.Lk)
    for (int c = cg; c < D; c += kT)
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const long at = (long)kvrow * acc_row + c + k;
        dk_out[(long)kvrow * a.dkv_row + c + k] =
            dk_acc[at] * a.sm_scale;
        dv_out[(long)kvrow * a.dkv_row + c + k] = dv_acc[at];
      }
}

template <bool kDrop, bool kSegs>
cudaError_t launch_bwd(const BwdArgs& a, int B, int D, cudaStream_t stream) {
  if (D % kT || a.dkv_acc == nullptr) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_big_kernel<kDrop, kSegs>;
  const int bytes = (6 * kTile + 2 * kT) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lk + kT - 1) / kT, a.Hkv, B);
  kernel<<<grid, kThr, bytes, stream>>>(a, D);
  return cudaGetLastError();
}

}  // namespace bigd
}  // namespace
