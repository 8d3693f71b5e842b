// Flash-attention forward over the packed qkv layout, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_pair.py `_pair_fwd_kernel`
// (launched by `_pair_fwd`), at dropout rate 0.
//
// What it computes: for qkv [B, L, 3*H*D] with column order
// [q heads | k heads | v heads], one head's context
//   out[b, i, h*D:(h+1)*D] = softmax(round(q_i * scale) . K^T) V
// and lse[b, h, i] = log-sum-exp of that row (fp32), with an optional
// causal mask. Rounding points match the Pallas kernel: q * scale is rounded
// to the input type before Q.K^T, and the probabilities are rounded to v's
// type before P.V; m, l and the accumulator stay fp32.
//
// Design: one CTA of 4 warps per (64-row q tile, head, batch row). The CTA
// reads its q, k and v columns straight out of the packed tensor by column
// offset (no relayout, no padding copy; the ragged L edge is masked here),
// keeps the q tile, one k tile, one v tile, the score tile, the
// probability tile and the fp32 output accumulator in shared memory, and
// walks the kv tiles up to the diagonal (causal tile skip) with the online
// softmax. Each warp owns 16 q rows end to end, so only the shared k/v tile
// loads need a CTA barrier. bf16 products run on the tensor cores through
// WMMA (16x16x16, fp32 accumulate); fp32 inputs use plain FMA, because
// TF32 would miss the fp32 reference.
//
// Bound on the H100: at the GPT-medium shape (B=2, L=1024, H=8, D=128,
// causal, bf16) the work is 2*B*H*D*L*(L+1) ~= 4.3 GFLOP (4.4 us at 989
// TFLOP/s) against 16.8 MB of traffic (qkv read once, out and lse written
// once: 5.0 us at 3.35 TB/s); the two bounds are close, and at longer L
// the operations dominate. This first version is simple rather than fast:
// WMMA from shared memory, synchronous global loads, the accumulator in
// shared memory and 2 CTAs per SM, so one CTA's serial walk over its kv
// tiles sets the kernel's time. The plan for speed: wgmma on 64-row
// warpgroup tiles with the accumulator in registers, TMA loads of k/v into
// a multi-stage ring, exp2-based softmax, and smaller or split causal work
// units so the longest CTA stops dominating (the FlashAttention-3
// structure).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kBM = 64;            // q rows per CTA
constexpr int kBN = 64;            // kv rows per tile
constexpr int kWarps = 4;          // each warp owns 16 q rows
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

// Shared-memory geometry. Rows of T tiles are padded by 16 bytes, which
// keeps every row 16-byte aligned for vector stores and every 16-row WMMA
// fragment 32-byte aligned.
template <typename T, int D>
struct Geom {
  static constexpr int kPadT = 16 / sizeof(T);
  static constexpr int kLdT = D + kPadT;      // q/k/v tiles (T)
  static constexpr int kLdS = kBN + 4;        // score tile (float)
  static constexpr int kLdP = kBN + kPadT;    // probability tile (T)
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

// Copy rows [r0, r0 + 64) of one head's D columns into a shared tile with
// 16-byte vector loads; rows at or past L are zero-filled (a zero v row
// times a zero probability stays zero, garbage could be NaN). With `scale`
// the values are multiplied by sm_scale and rounded back to T.
template <typename T, int D, bool kScale>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int L,
                                          long row_stride, float sm_scale) {
  using G = Geom<T, D>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < kBM * kVecPerRow; i += kThreads) {
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

// S[rows of this warp] = Q . K^T for the current kv tile.
template <typename T, int D>
__device__ __forceinline__ void scores(const T* Qs, const T* Ks, float* Ss,
                                       int warp, int lane) {
  using G = Geom<T, D>;
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
  using G = Geom<T, D>;
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
__global__ void __launch_bounds__(kThreads)
    flash_pair_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                          float* __restrict__ lse, int L, int H,
                          float sm_scale, int causal) {
  using G = Geom<T, D>;
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
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long row_stride = 3L * H * D;
  const T* base = qkv + (long)b * L * row_stride;
  const T* qg = base + (long)h * D;
  const T* kg = base + (long)(H + h) * D;
  const T* vg = base + (long)(2 * H + h) * D;

  load_tile<T, D, true>(Qs, qg, q0, L, row_stride, sm_scale);
  for (int i = threadIdx.x; i < kBM * G::kLdO; i += kThreads) Os[i] = 0.0f;
  if (threadIdx.x < kBM) {
    Ms[threadIdx.x] = kNegInf;
    Ls[threadIdx.x] = 0.0f;
  }

  // rows this lane pair owns in the softmax and the fp32 paths
  const int r = warp * 16 + (lane >> 1);
  const int qrow = q0 + r;
  const int half = lane & 1;
  const int kv_end = causal ? min(L, q0 + kBM) : L;

  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    __syncthreads();  // previous tile fully consumed (and Q/O/M/L ready)
    load_tile<T, D, false>(Ks, kg, n0, L, row_stride, 1.0f);
    load_tile<T, D, false>(Vs, vg, n0, L, row_stride, 1.0f);
    __syncthreads();

    scores<T, D>(Qs, Ks, Ss, warp, lane);
    __syncwarp();

    // online softmax over this row's half of the tile
    float* srow = Ss + r * G::kLdS;
    T* prow = Ps + r * G::kLdP;
    const int c0 = half * (kBN / 2);
    float mx = kNegInf;
    for (int c = c0; c < c0 + kBN / 2; ++c) {
      const int kc = n0 + c;
      const bool valid = kc < L && (!causal || kc <= qrow);
      const float s = valid ? srow[c] : kNegInf;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = Ms[r];
    const float m_cur = fmaxf(m_prev, mx);
    const float corr = expf(m_prev - m_cur);
    float sum = 0.0f;
    for (int c = c0; c < c0 + kBN / 2; ++c) {
      const int kc = n0 + c;
      const bool valid = kc < L && (!causal || kc <= qrow);
      const float p = valid ? expf(srow[c] - m_cur) : 0.0f;
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

  const long out_stride = (long)H * D;
  for (int i = threadIdx.x; i < kBM * D; i += kThreads) {
    const int rr = i / D;
    const int d = i % D;
    const int gr = q0 + rr;
    if (gr < L) {
      const float l = fmaxf(Ls[rr], 1e-30f);
      out[((long)b * L + gr) * out_stride + (long)h * D + d] =
          from_f<T>(Os[rr * G::kLdO + d] / l);
    }
  }
  if (threadIdx.x < kBM && q0 + threadIdx.x < L) {
    const int rr = threadIdx.x;
    lse[((long)b * H + h) * L + q0 + rr] =
        Ms[rr] + logf(fmaxf(Ls[rr], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, void* out, float* lse, int B, int L,
                   int H, float sm_scale, int causal, cudaStream_t stream) {
  using G = Geom<T, D>;
  auto kernel = flash_pair_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBM - 1) / kBM, H, B);
  kernel<<<grid, kThreads, G::kBytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, L, H, sm_scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success). The caller has checked shapes, types and contiguity;
// `out` is [B, L, H*D] of the input type and `lse` is [B, H, L] fp32.
extern "C" int flash_pair_fwd(const void* qkv, void* out, void* lse, int B,
                              int L, int H, int D, int is_bf16, int causal,
                              float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 64)
      return (int)launch<__nv_bfloat16, 64>(qkv, out, lse_f, B, L, H,
                                            sm_scale, causal, st);
    if (D == 128)
      return (int)launch<__nv_bfloat16, 128>(qkv, out, lse_f, B, L, H,
                                             sm_scale, causal, st);
  } else {
    if (D == 64)
      return (int)launch<float, 64>(qkv, out, lse_f, B, L, H, sm_scale,
                                    causal, st);
    if (D == 128)
      return (int)launch<float, 128>(qkv, out, lse_f, B, L, H, sm_scale,
                                     causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
