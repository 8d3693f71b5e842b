// Flash-attention backward over the packed qkv layout, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_pair.py `_pair_bwd_fused_kernel`
// (flash_pair.py:298, launched by `_pair_bwd` when kv_pad fits the TPU's
// VMEM budget) and the split pair `_pair_bwd_dq_kernel` (:363) +
// `_pair_bwd_dkv_kernel` (:398) that take over above that budget. All three
// compute one function; this kernel keeps only tile-sized state, so it has
// no length cutoff and does the job of both forms. Dropout rate 0.
//
// What it computes, per head h, from qkv [B, L, 3*H*D] (columns
// [q heads | k heads | v heads]), dO [B, L, H*D], the forward's
// lse [B, H, L] and delta = rowsum(dO * O) [B, H, L] (both fp32):
//   qs = round(q * scale)            s = qs . K^T            (fp32)
//   p  = exp(s - lse), 0 where masked                        (fp32)
//   dp = dO . V^T                    ds = round(p * (dp - delta))
//   dq = ds . K * scale    dk = ds^T . q * scale (q unscaled)
//   dv = round(p)^T . dO
// with "round" the cast to the input type, as `_bwd_tile_core` has it, and
// writes d(qkv) [B, L, 3*H*D] in the packed layout: dq at columns h*D, dk at
// (H+h)*D, dv at (2H+h)*D. No concatenation copy.
//
// Design (FlashAttention-2's backward): one CTA of 4 warps per (64-row kv
// tile, head, batch row). It loads its K and V tiles once, then walks the
// 64-row q tiles from the diagonal down (causal: the tile skip of
// flash_pair.py:346-347 becomes the loop's start), recomputing s and p once
// per (q tile, kv tile) and feeding all three gradients from them, which is
// what makes the form "fused". dk and dv accumulate in fp32 on chip for the
// whole walk (WMMA accumulator fragments in registers for bf16, per-thread
// register arrays for fp32). dq needs a sum over kv tiles that live in other
// CTAs: each CTA adds its fp32 partial with atomicAdd into a [B, L, H*D]
// fp32 scratch that the wrapper zeroes, and a second small launch converts
// the scratch into dq's columns. The atomics make the order of dq's sums
// change from run to run (compare dq with a tolerance, never bit for bit).
// Rows past L read as zero and are never written; rows that receive no
// contribution are written as zeros. bf16 products run on the tensor cores
// through WMMA (16x16x16, fp32 accumulate); fp32 uses plain FMA, because
// TF32 would miss the fp32 reference.
//
// Bound on the H100: operations = 10*D*B*H*(attended pairs), five products
// of 2*D per pair; bytes = qkv, O, dO and lse read once plus d(qkv) written
// once. At the training shape (B=16, L=1024, H=8, D=128, causal, bf16) that
// is 86.0 GFLOP (0.087 ms at 989 TFLOP/s) against 269 MB (0.080 ms at
// 3.35 TB/s): the two bounds are close, and at longer L the operations
// dominate. This first version is simple rather than fast: WMMA from shared
// memory, synchronous global loads, one CTA (4 warps) per SM because of its
// 171 KB of shared memory, scalar fp32 atomics for dq, and the causal kv
// tile 0 walks all q tiles while the last one walks one. The plan for
// speed: wgmma on 64-row warpgroup tiles with the operands in shared memory
// fed by a TMA ring, two consumer warpgroups per CTA, dq accumulated in
// registers and flushed with vector (float4) reductions or a separate dq
// pass when L is short, and a persistent schedule that pairs long and short
// causal walks (the FlashAttention-3 backward).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kBM = 64;            // q rows per step of the walk
constexpr int kBN = 64;            // kv rows per CTA
constexpr int kWarps = 4;          // bf16: each warp owns 16 q rows and 16 kv rows
constexpr int kThreads = kWarps * 32;

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
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Shared-memory geometry. T tiles are padded by 16 bytes a row, which keeps
// every row 16-byte aligned for vector stores and every 16-row WMMA fragment
// 32-byte aligned; every region size is a multiple of 128 bytes.
//   K, V, Q (unscaled), dO : [64][kLdT] T
//   Qs (q * scale, rounded): [64][kLdT] T           (bf16 only)
//   S, dP                  : [64][kLdS] float       (fp32: p and ds in place)
//   P, dS                  : [64][kLdP] T           (bf16 only)
//   dQ/dK/dV staging       : [64][kLdQ] float       (bf16 only)
//   lse, delta             : [64] float
template <typename T, int D>
struct Geom {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kPadT = 16 / sizeof(T);
  static constexpr int kLdT = D + kPadT;
  static constexpr int kLdS = kBN + 4;
  static constexpr int kLdP = kBN + kPadT;
  static constexpr int kLdQ = D + 4;
  static constexpr size_t kTileT = sizeof(T) * 64 * kLdT;
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + kTileT;
  static constexpr size_t kQ = kV + kTileT;
  static constexpr size_t kDO = kQ + kTileT;
  static constexpr size_t kQs = kDO + kTileT;
  static constexpr size_t kS = kQs + (kBf16 ? kTileT : 0);
  static constexpr size_t kDP = kS + sizeof(float) * kBM * kLdS;
  static constexpr size_t kP = kDP + sizeof(float) * kBM * kLdS;
  static constexpr size_t kDS = kP + (kBf16 ? sizeof(T) * kBM * kLdP : 0);
  static constexpr size_t kDQ = kDS + (kBf16 ? sizeof(T) * kBM * kLdP : 0);
  static constexpr size_t kLse = kDQ + (kBf16 ? sizeof(float) * 64 * kLdQ : 0);
  static constexpr size_t kDelta = kLse + sizeof(float) * kBM;
  static constexpr size_t kBytes = kDelta + sizeof(float) * kBM;
};

// Copy rows [r0, r0 + 64) of one head's D columns into a shared tile with
// 16-byte vector loads; rows at or past L are zero-filled. With kScale the
// values are multiplied by sm_scale and rounded back to T.
template <typename T, int D, bool kScale>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int L,
                                          long row_stride, float sm_scale) {
  using G = Geom<T, D>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < 64 * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int cv = i % kVecPerRow;
    const int gr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < L) {
      val = *reinterpret_cast<const uint4*>(src + (long)gr * row_stride +
                                            cv * kVec);
    }
    if (kScale) {
      T* e = reinterpret_cast<T*>(&val);
#pragma unroll
      for (int k = 0; k < kVec; ++k) e[k] = from_f<T>(to_f(e[k]) * sm_scale);
    }
    *reinterpret_cast<uint4*>(dst + r * G::kLdT + cv * kVec) = val;
  }
}

// dK/dV accumulators, fp32, live for the CTA's whole walk.
template <typename T, int D>
struct Acc;
template <int D>
struct Acc<__nv_bfloat16, D> {  // warp w: kv rows [16w, 16w + 16), all D
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      dk[D / 16], dv[D / 16];
};
template <int D>
struct Acc<float, D> {  // thread t: kv row t / 2, columns [(t % 2) * D / 2, +D / 2)
  float dk[D / 2], dv[D / 2];
};

// One (q tile, kv tile) step on the tensor cores (bf16).
template <int D>
__device__ __forceinline__ void step_bf16(
    Acc<__nv_bfloat16, D>& acc, unsigned char* smem, int m0, int n0, int L,
    int causal, float sm_scale, float* dqg, long out_stride, int warp,
    int lane) {
  using namespace nvcuda;
  using T = __nv_bfloat16;
  using G = Geom<T, D>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>;
  using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>;
  using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const T* Ks = reinterpret_cast<const T*>(smem + G::kK);
  const T* Vs = reinterpret_cast<const T*>(smem + G::kV);
  const T* Qs = reinterpret_cast<const T*>(smem + G::kQ);
  const T* DOs = reinterpret_cast<const T*>(smem + G::kDO);
  const T* QSs = reinterpret_cast<const T*>(smem + G::kQs);
  float* Ss = reinterpret_cast<float*>(smem + G::kS);
  float* DPs = reinterpret_cast<float*>(smem + G::kDP);
  T* Ps = reinterpret_cast<T*>(smem + G::kP);
  T* DSs = reinterpret_cast<T*>(smem + G::kDS);
  float* DQs = reinterpret_cast<float*>(smem + G::kDQ);
  const float* Lse = reinterpret_cast<const float*>(smem + G::kLse);
  const float* Delta = reinterpret_cast<const float*>(smem + G::kDelta);

  // S = Qs . K^T, then dP = dO . V^T, for this warp's 16 q rows (two passes
  // keep only four accumulator fragments live beside dK/dV)
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const T* A = pass == 0 ? QSs : DOs;
    const T* Bm = pass == 0 ? Ks : Vs;
    float* out = pass == 0 ? Ss : DPs;
    FragC c[kBN / 16];
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) wmma::fill_fragment(c[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, A + warp * 16 * G::kLdT + kk, G::kLdT);
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {
        // a [n][d] row-major tile is its transpose in column-major order
        FragBt bt;
        wmma::load_matrix_sync(bt, Bm + j * 16 * G::kLdT + kk, G::kLdT);
        wmma::mma_sync(c[j], a, bt, c[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      wmma::store_matrix_sync(out + warp * 16 * G::kLdS + j * 16, c[j],
                              G::kLdS, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // p and ds for this warp's rows: a lane pair per row, 32 columns each
  {
    const int r = warp * 16 + (lane >> 1);
    const int qrow = m0 + r;
    const int c0 = (lane & 1) * (kBN / 2);
    const float l = Lse[r];
    const float dl = Delta[r];
    for (int c = c0; c < c0 + kBN / 2; ++c) {
      const int kc = n0 + c;
      const bool valid = qrow < L && kc < L && (!causal || kc <= qrow);
      const float p = valid ? expf(Ss[r * G::kLdS + c] - l) : 0.0f;
      const float ds = p * (DPs[r * G::kLdS + c] - dl);
      Ps[r * G::kLdP + c] = from_f<T>(p);    // p rounded to dO's type for dV
      DSs[r * G::kLdP + c] = from_f<T>(ds);  // ds rounded to the input type
    }
  }
  __syncthreads();  // dV and dK read every q row's p and ds

  // dV += P^T . dO and dK += dS^T . Q for this warp's 16 kv rows
#pragma unroll
  for (int kk = 0; kk < kBM; kk += 16) {
    FragAt pt, dst;
    wmma::load_matrix_sync(pt, Ps + kk * G::kLdP + warp * 16, G::kLdP);
    wmma::load_matrix_sync(dst, DSs + kk * G::kLdP + warp * 16, G::kLdP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragB bdo, bq;
      wmma::load_matrix_sync(bdo, DOs + kk * G::kLdT + j * 16, G::kLdT);
      wmma::mma_sync(acc.dv[j], pt, bdo, acc.dv[j]);
      wmma::load_matrix_sync(bq, Qs + kk * G::kLdT + j * 16, G::kLdT);
      wmma::mma_sync(acc.dk[j], dst, bq, acc.dk[j]);
    }
  }

  // dQ partial = dS . K for this warp's 16 q rows, staged and added to the
  // fp32 scratch with atomics (scaled per tile, as the Pallas kernel does)
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    FragC c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kBN; kk += 16) {
      FragA a;
      FragB bk;
      wmma::load_matrix_sync(a, DSs + warp * 16 * G::kLdP + kk, G::kLdP);
      wmma::load_matrix_sync(bk, Ks + kk * G::kLdT + j * 16, G::kLdT);
      wmma::mma_sync(c, a, bk, c);
    }
    wmma::store_matrix_sync(DQs + warp * 16 * G::kLdQ + j * 16, c, G::kLdQ,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int rr = i / D;
    const int d = i % D;
    const int gr = m0 + warp * 16 + rr;
    if (gr < L) {
      atomicAdd(dqg + (long)gr * out_stride + d,
                DQs[(warp * 16 + rr) * G::kLdQ + d] * sm_scale);
    }
  }
}

// One (q tile, kv tile) step with plain FMA (fp32).
template <int D>
__device__ __forceinline__ void step_f32(Acc<float, D>& acc,
                                         unsigned char* smem, int m0, int n0,
                                         int L, int causal, float sm_scale,
                                         float* dqg, long out_stride) {
  using T = float;
  using G = Geom<T, D>;
  const T* Ks = reinterpret_cast<const T*>(smem + G::kK);
  const T* Vs = reinterpret_cast<const T*>(smem + G::kV);
  const T* Qs = reinterpret_cast<const T*>(smem + G::kQ);
  const T* DOs = reinterpret_cast<const T*>(smem + G::kDO);
  float* Ps = reinterpret_cast<float*>(smem + G::kS);   // p over s
  float* DSs = reinterpret_cast<float*>(smem + G::kDP); // ds over dp
  const float* Lse = reinterpret_cast<const float*>(smem + G::kLse);
  const float* Delta = reinterpret_cast<const float*>(smem + G::kDelta);
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;

  // s, p, dp and ds for q row r, kv columns [half * 32, +32)
  {
    const int qrow = m0 + r;
    const float l = Lse[r];
    const float dl = Delta[r];
    const T* q = Qs + r * G::kLdT;
    const T* dout = DOs + r * G::kLdT;
    for (int c = half * (kBN / 2); c < (half + 1) * (kBN / 2); ++c) {
      const T* k = Ks + c * G::kLdT;
      const T* v = Vs + c * G::kLdT;
      float s = 0.0f, dp = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(q[d] * sm_scale, k[d], s);
        dp = fmaf(dout[d], v[d], dp);
      }
      const int kc = n0 + c;
      const bool valid = qrow < L && kc < L && (!causal || kc <= qrow);
      const float p = valid ? expf(s - l) : 0.0f;
      Ps[r * G::kLdS + c] = p;
      DSs[r * G::kLdS + c] = p * (dp - dl);
    }
  }
  __syncthreads();  // dV and dK read every q row's p and ds

  // dV += P^T . dO and dK += dS^T . Q for kv row r, this thread's columns
  const int d0 = half * (D / 2);
  for (int c = 0; c < kBM; ++c) {
    const float p = Ps[c * G::kLdS + r];
    const float ds = DSs[c * G::kLdS + r];
    const T* dout = DOs + c * G::kLdT + d0;
    const T* q = Qs + c * G::kLdT + d0;
#pragma unroll
    for (int dd = 0; dd < D / 2; ++dd) {
      acc.dv[dd] = fmaf(p, dout[dd], acc.dv[dd]);
      acc.dk[dd] = fmaf(ds, q[dd], acc.dk[dd]);
    }
  }

  // dQ partial = dS . K for q row r, this thread's columns, 16 at a time
  const int qrow = m0 + r;
#pragma unroll
  for (int j = 0; j < D / 2; j += 16) {
    float part[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) part[e] = 0.0f;
    for (int c = 0; c < kBN; ++c) {
      const float ds = DSs[r * G::kLdS + c];
      const T* k = Ks + c * G::kLdT + d0 + j;
#pragma unroll
      for (int e = 0; e < 16; ++e) part[e] = fmaf(ds, k[e], part[e]);
    }
    if (qrow < L) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        atomicAdd(dqg + (long)qrow * out_stride + d0 + j + e,
                  part[e] * sm_scale);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_pair_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq_acc, T* __restrict__ dqkv,
                          int L, int H, float sm_scale, int causal) {
  using G = Geom<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + G::kK);
  T* Vs = reinterpret_cast<T*>(smem + G::kV);
  T* Qs = reinterpret_cast<T*>(smem + G::kQ);
  T* DOs = reinterpret_cast<T*>(smem + G::kDO);
  T* QSs = reinterpret_cast<T*>(smem + G::kQs);
  float* Lse = reinterpret_cast<float*>(smem + G::kLse);
  float* Delta = reinterpret_cast<float*>(smem + G::kDelta);

  const int n0 = blockIdx.x * kBN;  // kv tile 0 walks the most q tiles
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long row_stride = 3L * H * D;
  const long out_stride = (long)H * D;
  const T* base = qkv + (long)b * L * row_stride;
  const T* qg = base + (long)h * D;
  const T* kg = base + (long)(H + h) * D;
  const T* vg = base + (long)(2 * H + h) * D;
  const T* dog = dout + (long)b * L * out_stride + (long)h * D;
  const float* lseg = lse + ((long)b * H + h) * L;
  const float* deltag = delta + ((long)b * H + h) * L;
  float* dqg = dq_acc + (long)b * L * out_stride + (long)h * D;

  load_tile<T, D, false>(Ks, kg, n0, L, row_stride, 1.0f);
  load_tile<T, D, false>(Vs, vg, n0, L, row_stride, 1.0f);

  Acc<T, D> acc;
  if constexpr (G::kBf16) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      nvcuda::wmma::fill_fragment(acc.dk[j], 0.0f);
      nvcuda::wmma::fill_fragment(acc.dv[j], 0.0f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      acc.dk[j] = 0.0f;
      acc.dv[j] = 0.0f;
    }
  }

  // causal: q tiles above the diagonal see nothing of this kv tile; with
  // kBM == kBN the first q tile that does starts at n0
  for (int m0 = causal ? n0 : 0; m0 < L; m0 += kBM) {
    __syncthreads();  // the previous step is done with Q, dO, P, dS
    load_tile<T, D, false>(Qs, qg, m0, L, row_stride, 1.0f);
    if constexpr (G::kBf16) {
      load_tile<T, D, true>(QSs, qg, m0, L, row_stride, sm_scale);
    }
    load_tile<T, D, false>(DOs, dog, m0, L, out_stride, 1.0f);
    if (threadIdx.x < kBM) {
      const int gr = m0 + threadIdx.x;
      Lse[threadIdx.x] = gr < L ? lseg[gr] : 0.0f;
      Delta[threadIdx.x] = gr < L ? deltag[gr] : 0.0f;
    }
    __syncthreads();
    if constexpr (G::kBf16) {
      step_bf16<D>(acc, smem, m0, n0, L, causal, sm_scale, dqg, out_stride,
                   warp, lane);
    } else {
      step_f32<D>(acc, smem, m0, n0, L, causal, sm_scale, dqg, out_stride);
    }
  }

  // dk (scaled once here rather than per tile) and dv into their columns
  T* dk_out = dqkv + (long)b * L * row_stride + (long)(H + h) * D;
  T* dv_out = dqkv + (long)b * L * row_stride + (long)(2 * H + h) * D;
  if constexpr (G::kBf16) {
    float* stage = reinterpret_cast<float*>(smem + G::kDQ);
    __syncthreads();
#pragma unroll
    for (int part = 0; part < 2; ++part) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        nvcuda::wmma::store_matrix_sync(
            stage + warp * 16 * G::kLdQ + j * 16,
            part == 0 ? acc.dk[j] : acc.dv[j], G::kLdQ,
            nvcuda::wmma::mem_row_major);
      }
      __syncwarp();
      T* dst = part == 0 ? dk_out : dv_out;
      const float mul = part == 0 ? sm_scale : 1.0f;
      for (int i = lane; i < 16 * D; i += 32) {
        const int rr = i / D;
        const int d = i % D;
        const int gr = n0 + warp * 16 + rr;
        if (gr < L) {
          dst[(long)gr * row_stride + d] =
              from_f<T>(stage[(warp * 16 + rr) * G::kLdQ + d] * mul);
        }
      }
      __syncwarp();
    }
  } else {
    const int gr = n0 + (threadIdx.x >> 1);
    const int d0 = (threadIdx.x & 1) * (D / 2);
    if (gr < L) {
#pragma unroll
      for (int dd = 0; dd < D / 2; ++dd) {
        dk_out[(long)gr * row_stride + d0 + dd] = acc.dk[dd] * sm_scale;
        dv_out[(long)gr * row_stride + d0 + dd] = acc.dv[dd];
      }
    }
  }
}

// dq's fp32 scratch [B*L, H*D] -> its columns of d(qkv), in the input type.
template <typename T>
__global__ void dq_store_kernel(const float* __restrict__ dq_acc,
                                T* __restrict__ dqkv, long n, int hd) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long row = i / hd;
    const int col = (int)(i % hd);
    dqkv[row * 3 * hd + col] = from_f<T>(dq_acc[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* dout, const float* lse,
                   const float* delta, float* dq_acc, void* dqkv, int B,
                   int L, int H, float sm_scale, int causal,
                   cudaStream_t stream) {
  using G = Geom<T, D>;
  auto kernel = flash_pair_bwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBN - 1) / kBN, H, B);
  kernel<<<grid, kThreads, G::kBytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), lse, delta,
      dq_acc, static_cast<T*>(dqkv), L, H, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n = (long)B * L * H * D;
  const long blocks = (n + 255) / 256 < 132L * 16 ? (n + 255) / 256 : 132L * 16;
  dq_store_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      dq_acc, static_cast<T*>(dqkv), n, H * D);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Returns the cudaError_t of the launches
// (0 on success). The caller has checked shapes, types and contiguity:
// qkv and dqkv are [B, L, 3*H*D], dout [B, L, H*D] of the input type; lse
// and delta [B, H, L] fp32; dq_acc [B, L, H*D] fp32, zeroed.
extern "C" int flash_pair_bwd(const void* qkv, const void* dout,
                              const void* lse, const void* delta,
                              void* dq_acc, void* dqkv, int B, int L, int H,
                              int D, int is_bf16, int causal, float sm_scale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 64)
      return (int)launch<__nv_bfloat16, 64>(qkv, dout, lse_f, delta_f, acc,
                                            dqkv, B, L, H, sm_scale, causal,
                                            st);
    if (D == 128)
      return (int)launch<__nv_bfloat16, 128>(qkv, dout, lse_f, delta_f, acc,
                                             dqkv, B, L, H, sm_scale, causal,
                                             st);
  } else {
    if (D == 64)
      return (int)launch<float, 64>(qkv, dout, lse_f, delta_f, acc, dqkv, B,
                                    L, H, sm_scale, causal, st);
    if (D == 128)
      return (int)launch<float, 128>(qkv, dout, lse_f, delta_f, acc, dqkv, B,
                                     L, H, sm_scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
