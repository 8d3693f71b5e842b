// Flash-attention forward and backward kernels for Hopper (sm_90a), shared
// by the port's two attention layouts. Each launcher source includes this
// header and exposes one `extern "C"` entry point bound with ctypes:
//   flash_pair_fwd.cu / flash_pair_bwd.cu         GPT's packed qkv
//       [B, L, 3*H*D] (columns [q heads | k heads | v heads]);
//   flash_attention_fwd.cu / flash_attention_bwd.cu   q [B, Lq, H, D]
//       against k, v [B, Lk, Hkv, D] (grouped-query attention).
// Both are the same computation over rows read by stride: a q row of head
// h starts at h*D, a k/v row of KV head hk at hk*D, and consecutive rows
// are `*_row` elements apart (3*H*D in the packed layout). q head h reads
// KV head h / (H / Hkv), as the Pallas `_kv_map` folds them; repeated K/V
// never exists.
//
// What the forward computes, per q head h and row i:
//   out[b, i, h, :] = softmax_j(round(q_i * scale) . k_j) v_j
// over the keys j visible to row i: all of them, or (causal) j <= i + Lk - Lq,
// the bottom-right-aligned diagonal of the Pallas `causal_offset`, and
// lse[b, h, i] (fp32). A row with no visible key outputs 0 and
// lse = -1e30 + log(1e-30). Rounding points match the Pallas bodies: q *
// scale rounded to the input type before Q.K^T, the probabilities rounded
// to v's type before P.V; m, l and the accumulator stay fp32, and the
// output is acc / max(l, 1e-30).
//
// What the backward computes, from q, k, v, dO, lse and delta = rowsum(dO *
// O) (fp32, [B, H, Lq]):
//   qs = round(q * scale)            s = qs . K^T            (fp32)
//   p  = exp(s - lse), 0 where masked                        (fp32)
//   dp = dO . V^T                    ds = round(p * (dp - delta))
//   dq = ds . K * scale
//   dk = sum over the group's q heads of ds^T . q * scale (q unscaled)
//   dv = sum over the group's q heads of round(p)^T . dO
// with "round" the cast to the input type, as the Pallas `_bwd_tile_core`
// and `_flash_*_kernel` bodies have it. The group sums run in fp32 and
// round once; the JAX package rounds each q head's dk/dv to the input type
// before its fp32 group sum (`group` roundings in bf16 against one here).
//
// Forward design: one CTA of 4 warps per (64-row q tile, q head, batch
// row). It keeps the q tile, one k tile, one v tile, the score and
// probability tiles and the fp32 output accumulator in shared memory, and
// walks the kv tiles up to the diagonal (causal tile skip) with the online
// softmax; each warp owns 16 q rows end to end, so only the shared k/v tile
// loads need a CTA barrier. Heavy causal q tiles launch first.
//
// Backward design (FlashAttention-2's, extended over a GQA group): one CTA
// of 4 warps per (64-row kv tile, KV head, batch row). It loads its K and
// V tiles once, then walks every q head of its group and, for each, the
// 64-row q tiles from the diagonal down (causal: the Pallas tile skip
// becomes the loop's start), recomputing s and p once per (q tile, kv tile)
// and feeding all three gradients from them, which is what makes the form
// "fused". dk and dv accumulate in fp32 on chip for the whole walk (WMMA
// accumulator fragments in registers for bf16, per-thread register arrays
// for fp32), so the group sum needs no per-head scratch and no second pass.
// dq needs a sum over kv tiles that live in other CTAs: each CTA adds its
// fp32 partial with atomicAdd into a [B, Lq, H*D] fp32 scratch that the
// wrapper zeroes, and a second small launch converts the scratch into dq's
// rows. The atomics make the order of dq's sums change from run to run
// (compare dq with a tolerance, never bit for bit). State is tile-sized, so
// there is no length cutoff: one kernel does the job of the Pallas fused
// and split backward forms.
//
// Both: rows past a length read as zero and are never written; kv rows that
// no query sees get zero gradients. bf16 products run on the tensor cores
// through WMMA (16x16x16, fp32 accumulate); fp32 uses plain FMA, because
// TF32 would miss the fp32 reference. The block sizes are the kernels' own
// (64 x 64); the Pallas default of 1024 x 1024 is a VMEM choice of the TPU.
//
// What bounds them on the H100, and the plan: both are bound by their
// operations at the shapes the models give them (4*D and 10*D operations a
// attended pair against ~2 bytes a pair of the rows), and both are 20-40x
// that bound in this first version: WMMA from shared memory, synchronous
// global loads, the forward's accumulator in shared memory (2 CTAs per
// SM), the backward's 171 KB of shared memory (one CTA per SM, 255
// registers), scalar fp32 atomics for dq, and causal walks of unequal
// length. The plan for speed: wgmma on 64-row warpgroup tiles with the
// accumulators in registers, TMA loads into a multi-stage ring, exp2-based
// softmax, dq reduced in registers with vector reductions, and a persistent
// schedule that pairs long and short causal walks (the FlashAttention-3
// structure).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kBM = 64;            // q rows per tile
constexpr int kBN = 64;            // kv rows per tile
constexpr int kWarps = 4;          // bf16: each warp owns 16 q (and kv) rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // _NEG_INF of the Pallas kernels

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

// Rows of T tiles in shared memory are padded by 16 bytes, which keeps
// every row 16-byte aligned for vector stores and every 16-row WMMA
// fragment 32-byte aligned.
template <typename T, int D>
constexpr int kLdTile = D + 16 / (int)sizeof(T);

// Copy rows [r0, r0 + 64) of one head's D columns (rows row_stride apart)
// into a shared tile with 16-byte vector loads; rows at or past L are
// zero-filled (a zero v row times a zero probability stays zero, garbage
// could be NaN). With kScale the values are multiplied by sm_scale and
// rounded back to T.
template <typename T, int D, bool kScale>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int L,
                                          long row_stride, float sm_scale) {
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
    *reinterpret_cast<uint4*>(dst + r * kLdTile<T, D> + cv * kVec) = val;
  }
}

// Which (q row, key) pairs are attended.
struct Mask {
  int Lq, Lk, offset, causal;
  __device__ __forceinline__ bool operator()(int qrow, int kc) const {
    return qrow < Lq && kc < Lk && (!causal || kc <= qrow + offset);
  }
};

// ------------------------------------------------------------------ forward

// Operands of one forward launch. q points at head 0 of batch row 0, k and
// v at KV head 0; *_row are the element strides between rows (a batch row
// is L rows). out is [B, Lq, H, D] rows o_row apart, lse [B, H, Lq].
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  long q_row, kv_row, o_row;
  int Lq, Lk, H, Hkv;
  float sm_scale;
  int causal;
};

template <typename T, int D>
struct FwdGeom {
  static constexpr int kLdT = kLdTile<T, D>;  // q/k/v tiles (T)
  static constexpr int kLdS = kBN + 4;        // score tile (float)
  static constexpr int kLdP = kBN + 16 / (int)sizeof(T);  // probabilities
  static constexpr int kLdO = D + 4;          // output accumulator (float)
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(T) * kBM * kLdT;
  static constexpr size_t kV = kK + sizeof(T) * kBN * kLdT;
  static constexpr size_t kS = kV + sizeof(T) * kBN * kLdT;
  static constexpr size_t kP = kS + sizeof(float) * kBM * kLdS;
  static constexpr size_t kO = kP + sizeof(T) * kBM * kLdP;
  static constexpr size_t kM = kO + sizeof(float) * kBM * kLdO;
  static constexpr size_t kL = kM + sizeof(float) * kBM;
  static constexpr size_t kBytes = kL + sizeof(float) * kBM;
};

// S[rows of this warp] = Q . K^T for the current kv tile.
template <typename T, int D>
__device__ __forceinline__ void scores(const T* Qs, const T* Ks, float* Ss,
                                       int warp, int lane) {
  using G = FwdGeom<T, D>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBN / 16];
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + warp * 16 * G::kLdT + kk, G::kLdT);
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {
        // K stored [n][d] row-major is K^T in column-major order
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bk;
        wmma::load_matrix_sync(bk, Ks + j * 16 * G::kLdT + kk, G::kLdT);
        wmma::mma_sync(acc[j], a, bk, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      wmma::store_matrix_sync(Ss + warp * 16 * G::kLdS + j * 16, acc[j],
                              G::kLdS, wmma::mem_row_major);
    }
  } else {
    // lane pair per row, half the tile's columns each
    const int r = warp * 16 + (lane >> 1);
    const int c0 = (lane & 1) * (kBN / 2);
    const T* q = Qs + r * G::kLdT;
    for (int c = c0; c < c0 + kBN / 2; ++c) {
      const T* k = Ks + c * G::kLdT;
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(to_f(q[d]), to_f(k[d]), acc);
      Ss[r * G::kLdS + c] = acc;
    }
  }
}

// O[rows of this warp] += P . V for the current kv tile.
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(const T* Ps, const T* Vs,
                                              float* Os, int warp, int lane) {
  using G = FwdGeom<T, D>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      float* optr = Os + warp * 16 * G::kLdO + j * 16;
      wmma::load_matrix_sync(o, optr, G::kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + warp * 16 * G::kLdP + kk, G::kLdP);
        wmma::load_matrix_sync(bv, Vs + kk * G::kLdT + j * 16, G::kLdT);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(optr, o, G::kLdO, wmma::mem_row_major);
    }
  } else {
    const int r = warp * 16 + (lane >> 1);
    const int d0 = (lane & 1) * (D / 2);
    const T* p = Ps + r * G::kLdP;
    float* o = Os + r * G::kLdO;
    for (int d = d0; d < d0 + D / 2; ++d) {
      float acc = o[d];
      for (int c = 0; c < kBN; ++c)
        acc = fmaf(to_f(p[c]), to_f(Vs[c * G::kLdT + d]), acc);
      o[d] = acc;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdArgs a) {
  using G = FwdGeom<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + G::kQ);
  T* Ks = reinterpret_cast<T*>(smem + G::kK);
  T* Vs = reinterpret_cast<T*>(smem + G::kV);
  float* Ss = reinterpret_cast<float*>(smem + G::kS);
  T* Ps = reinterpret_cast<T*>(smem + G::kP);
  float* Os = reinterpret_cast<float*>(smem + G::kO);
  float* Ms = reinterpret_cast<float*>(smem + G::kM);
  float* Ls = reinterpret_cast<float*>(smem + G::kL);

  // heaviest causal q tiles first: they have the most kv tiles to walk
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);    // this q head's KV head (_kv_map)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const Mask mask{a.Lq, a.Lk, a.Lk - a.Lq, a.causal};
  const T* qg = static_cast<const T*>(a.q) + (long)b * a.Lq * a.q_row +
                (long)h * D;
  const long kv_base = (long)b * a.Lk * a.kv_row + (long)hk * D;
  const T* kg = static_cast<const T*>(a.k) + kv_base;
  const T* vg = static_cast<const T*>(a.v) + kv_base;

  load_tile<T, D, true>(Qs, qg, q0, a.Lq, a.q_row, a.sm_scale);
  for (int i = threadIdx.x; i < kBM * G::kLdO; i += kThreads) Os[i] = 0.0f;
  if (threadIdx.x < kBM) {
    Ms[threadIdx.x] = kNegInf;
    Ls[threadIdx.x] = 0.0f;
  }

  // rows this lane pair owns in the softmax and the fp32 paths
  const int r = warp * 16 + (lane >> 1);
  const int qrow = q0 + r;
  const int half = lane & 1;
  // causal: the tile's last row sees keys up to q0 + 63 + offset
  const int kv_end =
      a.causal ? min(a.Lk, max(0, q0 + kBM + mask.offset)) : a.Lk;

  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    __syncthreads();  // previous tile fully consumed (and Q/O/M/L ready)
    load_tile<T, D, false>(Ks, kg, n0, a.Lk, a.kv_row, 1.0f);
    load_tile<T, D, false>(Vs, vg, n0, a.Lk, a.kv_row, 1.0f);
    __syncthreads();

    scores<T, D>(Qs, Ks, Ss, warp, lane);
    __syncwarp();

    // online softmax over this row's half of the tile
    float* srow = Ss + r * G::kLdS;
    T* prow = Ps + r * G::kLdP;
    const int c0 = half * (kBN / 2);
    float mx = kNegInf;
    for (int c = c0; c < c0 + kBN / 2; ++c) {
      const float s = mask(qrow, n0 + c) ? srow[c] : kNegInf;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = Ms[r];
    const float m_cur = fmaxf(m_prev, mx);
    const float corr = expf(m_prev - m_cur);
    float sum = 0.0f;
    for (int c = c0; c < c0 + kBN / 2; ++c) {
      const float p = mask(qrow, n0 + c) ? expf(srow[c] - m_cur) : 0.0f;
      sum += p;
      prow[c] = from_f<T>(p);  // p rounded to v's type before P.V
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    float* orow = Os + r * G::kLdO;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) orow[d] *= corr;
    const float l_prev = Ls[r];
    __syncwarp();  // both lanes of the pair have read Ms/Ls
    if (half == 0) {
      Ms[r] = m_cur;
      Ls[r] = l_prev * corr + sum;
    }
    __syncwarp();

    accumulate_pv<T, D>(Ps, Vs, Os, warp, lane);
  }
  __syncthreads();

  // rows with no visible key keep acc = 0, l = 0: output 0
  T* og = static_cast<T*>(a.out) + (long)b * a.Lq * a.o_row + (long)h * D;
  for (int i = threadIdx.x; i < kBM * D; i += kThreads) {
    const int rr = i / D;
    const int d = i % D;
    const int gr = q0 + rr;
    if (gr < a.Lq) {
      const float l = fmaxf(Ls[rr], 1e-30f);
      og[(long)gr * a.o_row + d] = from_f<T>(Os[rr * G::kLdO + d] / l);
    }
  }
  if (threadIdx.x < kBM && q0 + threadIdx.x < a.Lq) {
    const int rr = threadIdx.x;
    a.lse[((long)b * a.H + h) * a.Lq + q0 + rr] =
        Ms[rr] + logf(fmaxf(Ls[rr], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
  using G = FwdGeom<T, D>;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lq + kBM - 1) / kBM, a.H, B);
  kernel<<<grid, kThreads, G::kBytes, stream>>>(a);
  return cudaGetLastError();
}

// The forward for input type (bf16 or fp32) and head size (64 or 128);
// returns the cudaError_t of the launch.
inline int flash_fwd(const FwdArgs& a, int B, int D, int is_bf16,
                     cudaStream_t st) {
  if (B <= 0 || a.Lq <= 0 || a.Lk <= 0 || a.H <= 0 || a.Hkv <= 0 ||
      a.H % a.Hkv)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 64) return (int)launch_fwd<__nv_bfloat16, 64>(a, B, st);
    if (D == 128) return (int)launch_fwd<__nv_bfloat16, 128>(a, B, st);
  } else {
    if (D == 64) return (int)launch_fwd<float, 64>(a, B, st);
    if (D == 128) return (int)launch_fwd<float, 128>(a, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------------------------- backward

// Operands of one backward launch. q, k, v as in FwdArgs; dout [B, Lq, H,
// D] contiguous; lse and delta [B, H, Lq] fp32; dq_acc [B, Lq, H*D] fp32,
// zeroed; dq rows dq_row apart (head h at h*D), dk and dv rows dkv_row
// apart (KV head hk at hk*D).
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  float* dq_acc;
  void* dq;
  void* dk;
  void* dv;
  long q_row, kv_row, dq_row, dkv_row;
  int Lq, Lk, H, Hkv;
  float sm_scale;
  int causal;
};

// Shared-memory geometry; every region size is a multiple of 128 bytes.
//   K, V, Q (unscaled), dO : [64][kLdT] T
//   Qs (q * scale, rounded): [64][kLdT] T           (bf16 only)
//   S, dP                  : [64][kLdS] float       (fp32: p and ds in place)
//   P, dS                  : [64][kLdP] T           (bf16 only)
//   dQ/dK/dV staging       : [64][kLdQ] float       (bf16 only)
//   lse, delta             : [64] float
template <typename T, int D>
struct BwdGeom {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kLdT = kLdTile<T, D>;
  static constexpr int kLdS = kBN + 4;
  static constexpr int kLdP = kBN + 16 / (int)sizeof(T);
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

// One (q tile, kv tile) step on the tensor cores (bf16). dqg points at
// this head's dq scratch, whose rows are q_stride apart.
template <int D>
__device__ __forceinline__ void step_bf16(
    Acc<__nv_bfloat16, D>& acc, unsigned char* smem, int m0, int n0,
    Mask mask, float sm_scale, float* dqg, long q_stride, int warp,
    int lane) {
  using namespace nvcuda;
  using T = __nv_bfloat16;
  using G = BwdGeom<T, D>;
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
      FragA fa;
      wmma::load_matrix_sync(fa, A + warp * 16 * G::kLdT + kk, G::kLdT);
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {
        // a [n][d] row-major tile is its transpose in column-major order
        FragBt bt;
        wmma::load_matrix_sync(bt, Bm + j * 16 * G::kLdT + kk, G::kLdT);
        wmma::mma_sync(c[j], fa, bt, c[j]);
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
      const float p = mask(qrow, n0 + c) ? expf(Ss[r * G::kLdS + c] - l)
                                         : 0.0f;
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
  // fp32 scratch with atomics (scaled per tile)
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    FragC c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kBN; kk += 16) {
      FragA fa;
      FragB bk;
      wmma::load_matrix_sync(fa, DSs + warp * 16 * G::kLdP + kk, G::kLdP);
      wmma::load_matrix_sync(bk, Ks + kk * G::kLdT + j * 16, G::kLdT);
      wmma::mma_sync(c, fa, bk, c);
    }
    wmma::store_matrix_sync(DQs + warp * 16 * G::kLdQ + j * 16, c, G::kLdQ,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int rr = i / D;
    const int d = i % D;
    const int gr = m0 + warp * 16 + rr;
    if (gr < mask.Lq) {
      atomicAdd(dqg + (long)gr * q_stride + d,
                DQs[(warp * 16 + rr) * G::kLdQ + d] * sm_scale);
    }
  }
}

// One (q tile, kv tile) step with plain FMA (fp32).
template <int D>
__device__ __forceinline__ void step_f32(Acc<float, D>& acc,
                                         unsigned char* smem, int m0, int n0,
                                         Mask mask, float sm_scale,
                                         float* dqg, long q_stride) {
  using T = float;
  using G = BwdGeom<T, D>;
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
      const float p = mask(qrow, n0 + c) ? expf(s - l) : 0.0f;
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
    if (qrow < mask.Lq) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        atomicAdd(dqg + (long)qrow * q_stride + d0 + j + e,
                  part[e] * sm_scale);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(BwdArgs a) {
  using G = BwdGeom<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + G::kK);
  T* Vs = reinterpret_cast<T*>(smem + G::kV);
  T* Qs = reinterpret_cast<T*>(smem + G::kQ);
  T* DOs = reinterpret_cast<T*>(smem + G::kDO);
  T* QSs = reinterpret_cast<T*>(smem + G::kQs);
  float* Lse = reinterpret_cast<float*>(smem + G::kLse);
  float* Delta = reinterpret_cast<float*>(smem + G::kDelta);

  const int n0 = blockIdx.x * kBN;  // kv tile 0 walks the most q tiles
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.H / a.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long do_row = (long)a.H * D;  // dO and the dq scratch: contiguous
  const Mask mask{a.Lq, a.Lk, a.Lk - a.Lq, a.causal};
  const long kv_base = (long)b * a.Lk * a.kv_row + (long)hk * D;

  load_tile<T, D, false>(Ks, static_cast<const T*>(a.k) + kv_base, n0, a.Lk,
                         a.kv_row, 1.0f);
  load_tile<T, D, false>(Vs, static_cast<const T*>(a.v) + kv_base, n0, a.Lk,
                         a.kv_row, 1.0f);

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

  // causal: the first q row that sees key n0 is n0 - offset; the walk
  // starts at the q tile holding it (tiles are aligned at multiples of 64)
  const int first = a.causal ? max(0, n0 - mask.offset) : 0;
  const int m_begin = (first / kBM) * kBM;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qg = static_cast<const T*>(a.q) + (long)b * a.Lq * a.q_row +
                  (long)h * D;
    const T* dog = static_cast<const T*>(a.dout) + (long)b * a.Lq * do_row +
                   (long)h * D;
    const float* lseg = a.lse + ((long)b * a.H + h) * a.Lq;
    const float* deltag = a.delta + ((long)b * a.H + h) * a.Lq;
    float* dqg = a.dq_acc + (long)b * a.Lq * do_row + (long)h * D;
    for (int m0 = m_begin; m0 < a.Lq; m0 += kBM) {
      __syncthreads();  // the previous step is done with Q, dO, P, dS
      load_tile<T, D, false>(Qs, qg, m0, a.Lq, a.q_row, 1.0f);
      if constexpr (G::kBf16) {
        load_tile<T, D, true>(QSs, qg, m0, a.Lq, a.q_row, a.sm_scale);
      }
      load_tile<T, D, false>(DOs, dog, m0, a.Lq, do_row, 1.0f);
      if (threadIdx.x < kBM) {
        const int gr = m0 + threadIdx.x;
        Lse[threadIdx.x] = gr < a.Lq ? lseg[gr] : 0.0f;
        Delta[threadIdx.x] = gr < a.Lq ? deltag[gr] : 0.0f;
      }
      __syncthreads();
      if constexpr (G::kBf16) {
        step_bf16<D>(acc, smem, m0, n0, mask, a.sm_scale, dqg, do_row, warp,
                     lane);
      } else {
        step_f32<D>(acc, smem, m0, n0, mask, a.sm_scale, dqg, do_row);
      }
    }
  }

  // dk (scaled once here rather than per tile) and dv, the group's fp32
  // sums, rounded once into their rows
  const long dkv_base = (long)b * a.Lk * a.dkv_row + (long)hk * D;
  T* dk_out = static_cast<T*>(a.dk) + dkv_base;
  T* dv_out = static_cast<T*>(a.dv) + dkv_base;
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
      const float mul = part == 0 ? a.sm_scale : 1.0f;
      for (int i = lane; i < 16 * D; i += 32) {
        const int rr = i / D;
        const int d = i % D;
        const int gr = n0 + warp * 16 + rr;
        if (gr < a.Lk) {
          dst[(long)gr * a.dkv_row + d] =
              from_f<T>(stage[(warp * 16 + rr) * G::kLdQ + d] * mul);
        }
      }
      __syncwarp();
    }
  } else {
    const int gr = n0 + (threadIdx.x >> 1);
    const int d0 = (threadIdx.x & 1) * (D / 2);
    if (gr < a.Lk) {
#pragma unroll
      for (int dd = 0; dd < D / 2; ++dd) {
        dk_out[(long)gr * a.dkv_row + d0 + dd] = acc.dk[dd] * a.sm_scale;
        dv_out[(long)gr * a.dkv_row + d0 + dd] = acc.dv[dd];
      }
    }
  }
}

// dq's fp32 scratch [rows, hd] -> dq's rows (dq_row apart), input type.
template <typename T>
__global__ void dq_convert_kernel(const float* __restrict__ dq_acc,
                                  T* __restrict__ dq, long n, int hd,
                                  long dq_row) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    dq[(i / hd) * dq_row + i % hd] = from_f<T>(dq_acc[i]);
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  using G = BwdGeom<T, D>;
  auto kernel = flash_bwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lk + kBN - 1) / kBN, a.Hkv, B);
  kernel<<<grid, kThreads, G::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n = (long)B * a.Lq * a.H * D;
  const long blocks = (n + 255) / 256 < 132L * 16 ? (n + 255) / 256 : 132L * 16;
  dq_convert_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      a.dq_acc, static_cast<T*>(a.dq), n, a.H * D, a.dq_row);
  return cudaGetLastError();
}

// The backward for input type (bf16 or fp32) and head size (64 or 128);
// returns the cudaError_t of the launches.
inline int flash_bwd(const BwdArgs& a, int B, int D, int is_bf16,
                     cudaStream_t st) {
  if (B <= 0 || a.Lq <= 0 || a.Lk <= 0 || a.H <= 0 || a.Hkv <= 0 ||
      a.H % a.Hkv)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 64) return (int)launch_bwd<__nv_bfloat16, 64>(a, B, st);
    if (D == 128) return (int)launch_bwd<__nv_bfloat16, 128>(a, B, st);
  } else {
    if (D == 64) return (int)launch_bwd<float, 64>(a, B, st);
    if (D == 128) return (int)launch_bwd<float, 128>(a, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
