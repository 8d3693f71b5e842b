// Flash-attention forward and backward for Hopper (sm_90a), shared by the
// port's two attention layouts: the operands, the masks, the shared
// helpers, the fp32 and WMMA bodies and the dispatch. Each launcher source
// includes this header and exposes one `extern "C"` entry point bound with
// ctypes:
//   flash_pair_fwd.cu / flash_pair_bwd.cu         GPT's packed qkv
//       [B, L, 3*H*D] (columns [q heads | k heads | v heads]), also the
//       packed-qkv flat API for heads of 128;
//   flash_attention_fwd.cu / flash_attention_bwd.cu   q [B, Lq, H, D]
//       against k, v [B, Lk, Hkv, D] (grouped-query attention), with
//       per-sequence key lengths and segment ids.
// Both are the same computation over rows read by stride: a q row of head
// h starts at h*D, a k/v row of KV head hk at hk*D, and consecutive rows
// are `*_row` elements apart (3*H*D in the packed layout). q head h reads
// KV head h / (H / Hkv), as the Pallas `_kv_map` folds them; repeated K/V
// never exists.
//
// What the forward computes, per q head h and row i:
//   out[b, i, h, :] = softmax_j(round(q_i * scale) . k_j) v_j
// over the keys j visible to row i: all of them, or (causal) j <= i + Lk - Lq,
// the bottom-right-aligned diagonal of the Pallas `causal_offset`; with
// lengths only j < lens[b] (rows at or past lens[b] still attend the valid
// keys: an additive padding mask's semantics), and with segment ids only j
// of row i's segment, as the Pallas `_valid_mask` has it; and
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
// Which body runs (flash_fwd and flash_bwd dispatch on the input type and
// the head size D):
//
//   forward   bf16, D = 64, 80, 96, 128, 256   sm90::flash_fwd_sm90_kernel
//                                              (flash_fwd_sm90.cuh: TMA,
//                                              wgmma, S, P, O in registers)
//             bf16, D > 256 with D % 64 == 0   wide::flash_fwd_wide_kernel
//                                              (flash_wide_sm90.cuh: TMA,
//                                              wgmma, O in 128-column
//                                              slices, S over D in chunks)
//             fp32, D <= 256                   flash_fwd_f32_kernel (below,
//                                              SIMT: TF32 would miss the
//                                              fp32 reference)
//             fp32, D > 256 with D % 64 == 0   f32w::flash_fwd_f32_wide_kernel
//                                              (flash_f32_wide.cuh: FFMA
//                                              register micro-tiles, O in
//                                              shared memory, one pass)
//   backward  bf16, D = 64, 128                sm90::flash_bwd_sm90_kernel
//                                              (flash_bwd_sm90.cuh: TMA,
//                                              wgmma, dK/dV in registers,
//                                              bulk dq reductions)
//             bf16, D = 80, 96                 flash_bwd_kernel<bf16>
//                                              (below: WMMA from shared
//                                              memory)
//             bf16, D = 256, and D > 256 with  wide::flash_bwd_wide_kernel
//             D % 64 == 0                      (flash_wide_sm90.cuh: dK/dV
//                                              in 128-column slices, S^T
//                                              and dP^T over D in chunks)
//             fp32, D = 64, 80, 96, 128, 256   flash_bwd_kernel<float>
//                                              (below, SIMT)
//             fp32, D > 256 with D % 64 == 0   f32w::flash_bwd_f32_wide_kernel
//                                              (flash_f32_wide.cuh: FFMA
//                                              register micro-tiles, dK and
//                                              dV in shared memory)
//
// The [B, L, H, D] launchers take every one of those sizes; the pair
// launchers 64, 128, 256 and the multiples of 128 above 256 (the pair
// gate's whole 128-column blocks). The wrappers run any other D on
// zero-padded heads.
//
// Every backward is three launches on the stream: bwd_prepass_kernel
// (delta = rowsum(dO * O) in fp32 and a copy of lse, both at rows padded
// to a multiple of 64 so the bf16 body loads them with one bulk copy a q
// tile, and the fp32 dq scratch zeroed), the body, and dq_convert_kernel
// (dq = scratch * sm_scale in the input type: the bodies add unscaled
// partials). The scratch and the padded rows live in one fp32 workspace
// the wrapper allocates (bwd_work_floats), with, where a body needs it,
// the scaled copy of q (wide::, bf16 D >= 256: written by its scale_q_kernel
// launch, the body's fourth).
//
// The WMMA and SIMT backward (FlashAttention-2's, extended over a GQA
// group): one CTA of 4 warps per (64-row kv tile, KV head, batch row; 32
// rows at D = 256, fp32, so the tiles fit). It loads its K and V tiles once, then
// walks every q head of its group and, for each, the 64-row q tiles from
// the diagonal down (causal: the Pallas tile skip becomes the loop's
// start), recomputing s and p once per (q tile, kv tile) and feeding all
// three gradients from them. dk and dv accumulate in fp32 on chip for the
// whole walk (WMMA accumulator fragments for bf16, per-thread register
// arrays for fp32), so the group sum needs no scratch; dq's partials go
// into the fp32 scratch by scalar atomicAdd. The atomics (and the bf16
// body's bulk reductions) make the order of dq's sums change from run to
// run (compare dq with a tolerance, never bit for bit). State is
// tile-sized, so there is no length cutoff: one kernel does the job of the
// Pallas fused and split backward forms.
//
// Dropout on the attention probabilities (every launcher), as the Pallas
// kernels have it
// (flash_pair.py:126-135, :163-177, `_bwd_tile_core` :282-295): the
// forward sums l over the undropped p, then feeds round(p * keep_factor) to
// P.V; the backward uses p * keep_factor for dV and dp * keep_factor in ds =
// p * (dp - delta), with keep_factor = 1 / (1 - rate) where the element is
// kept and 0 where it is dropped. The keep decision comes from philox.cuh,
// keyed on (b, q head h, q row, key column) with absolute positions, so the
// forward's q tiles and the backward's kv tiles drop the same elements, and
// the flat and packed layouts drop the same ones for the same sequence.
// Rate 0 compiles without any of it (the kDrop template flag): a rate-0
// launch is the kernel as it was.
//
// Lengths and segment ids (the flat launchers; the Pallas `_valid_mask` and
// `_tile_liveness`). A length is one scalar a CTA, len = min(Lk,
// lens[b]) (Lk without lengths): the mask tests key < len where it tested
// key < Lk, the forward's kv walk stops at ceil(len / 64) tiles, and a
// backward CTA whose kv tile starts at or past len writes zero dk/dv and
// exits before any load or dq atomic. Segment ids are the kSegs template
// flag: the mask then also compares q_seg[b, i] with k_seg[b, j], read
// only inside [0, Lq) x [0, len), and nothing is skipped for them. A row
// whose segment owns no key of a tile keeps m at -1e30 (finite), so the
// online softmax never forms -inf - -inf. Without either, the mask's
// decisions are those of the kernel before them.
//
// Both: rows past a length read as zero and are never written; kv rows that
// no query sees get zero gradients.
//
// What bounds them on the H100: every body is bound by its operations at
// the shapes the models give it (4*D and 10*D operations an attended pair
// against ~2 bytes a pair of the rows); each header says what its design
// does about that.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>
#include <type_traits>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kBM = 64;            // q rows per tile (SIMT forward, backward)
constexpr int kWarps = 4;          // each warp owns 16 q rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // _NEG_INF of the Pallas kernels

// Rows of T tiles in shared memory are padded by 16 bytes, which keeps
// every row 16-byte aligned for vector stores and every 16-row WMMA
// fragment 32-byte aligned.
template <typename T, int D>
constexpr int kLdTile = D + 16 / (int)sizeof(T);

// Copy rows [r0, r0 + rows) of one head's D columns (rows row_stride
// apart) into a shared tile with 16-byte vector loads; rows at or past L
// are zero-filled (a zero v row times a zero probability stays zero,
// garbage could be NaN). With kScale the values are multiplied by sm_scale
// and rounded back to T.
template <typename T, int D, bool kScale>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int rows, int L, long row_stride,
                                          float sm_scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += kThreads) {
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

// Which (q row, key) pairs of one batch row are attended: keys below len,
// the causal band and, with kSegs, the pairs of one segment (qs and ks are
// this batch row's segment ids). The tests run in this order, so a segment
// id is read only for a row below Lq and a key below len.
template <bool kSegs>
struct Mask {
  int Lq, len, offset, causal;
  const int* qs;
  const int* ks;
  __device__ __forceinline__ bool operator()(int qrow, int kc) const {
    bool ok = qrow < Lq && kc < len && (!causal || kc <= qrow + offset);
    if constexpr (kSegs) ok = ok && qs[qrow] == ks[kc];
    return ok;
  }
};

// The mask of batch row b: len = min(Lk, lens[b]) (clamped at 0), Lk
// without lengths; the segment ids' rows with kSegs.
template <bool kSegs, typename Args>
__device__ __forceinline__ Mask<kSegs> mask_of(const Args& a, int b) {
  const int len = a.lens ? max(0, min(a.Lk, a.lens[b])) : a.Lk;
  const int* qs = kSegs ? a.q_seg + (long)b * a.Lq : nullptr;
  const int* ks = kSegs ? a.k_seg + (long)b * a.Lk : nullptr;
  return Mask<kSegs>{a.Lq, len, a.Lk - a.Lq, a.causal, qs, ks};
}

// ------------------------------------------------------------------ forward

// Operands of one forward launch. q points at head 0 of batch row 0, k and
// v at KV head 0; *_row are the element strides between rows (a batch row
// is L rows). out is [B, Lq, H, D] rows o_row apart, lse [B, H, Lq].
// drop is read only by the kDrop instantiations (zero from a launcher that
// leaves it out); lens ([B] int32) and q_seg, k_seg ([B, Lq], [B, Lk]
// int32, read only by the kSegs instantiations) may be null.
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
  DropParams drop;
  const int* lens;
  const int* q_seg;
  const int* k_seg;
};

// Operands of one backward launch. q, k, v as in FwdArgs; out and dout
// [B, Lq, H*D] contiguous; lse [B, H, Lq] fp32, the forward's; lse_pad,
// delta [B*H, Lq_pad] and dq_acc [B, Lq, H*D] fp32, written by the
// pre-pass;
// dq rows dq_row apart (head h at h*D), dk and dv rows dkv_row apart (KV
// head hk at hk*D). drop, lens, q_seg and k_seg as in FwdArgs.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* lse_pad;
  float* delta;
  float* dq_acc;
  void* dq;
  void* dk;
  void* dv;
  long q_row, kv_row, dq_row, dkv_row;
  int Lq, Lk, H, Hkv, Lq_pad;
  float sm_scale;
  int causal;
  DropParams drop;
  const int* lens;
  const int* q_seg;
  const int* k_seg;
};

// The backward's fp32 workspace, in floats: dq_acc, lse_pad, delta and,
// in bf16 at D >= 256, the scaled copy of q (the wide body's, bf16 [B, Lq,
// H*D]). kernels/flash_pair.py `bwd_work_floats` sizes it the same way.
inline long bwd_work_floats(int B, int Lq, int H, int D, int is_bf16) {
  const long lq_pad = (Lq + 63) / 64 * 64;
  const long base = (long)B * Lq * H * D + 2L * B * H * lq_pad;
  return base + (is_bf16 && D >= 256 ? (long)B * Lq * H * D / 2 : 0L);
}

// Points a's scratch into `work` (bwd_work_floats(...) floats).
inline void bwd_set_work(BwdArgs& a, float* work, int B, int D) {
  a.Lq_pad = (a.Lq + 63) / 64 * 64;
  a.dq_acc = work;
  a.lse_pad = work + (long)B * a.Lq * a.H * D;
  a.delta = a.lse_pad + (long)B * a.H * a.Lq_pad;
}

// Blocks of 256 threads for a grid-stride pass over n items: one an item,
// at most 16 a streaming multiprocessor of the H100's 132.
static inline unsigned grid_for(long n) {
  const long blocks = (n + 255) / 256;
  return (unsigned)(blocks < 132L * 16 ? (blocks > 0 ? blocks : 1) : 132L * 16);
}

// The wide bf16 body's scaled copy of q: the workspace's region after
// delta (bwd_work_floats).
inline __nv_bfloat16* bwd_qs(const BwdArgs& a, int B) {
  return reinterpret_cast<__nv_bfloat16*>(a.delta +
                                          (long)B * a.H * a.Lq_pad);
}

}  // namespace

#include "flash_fwd_sm90.cuh"   // the bf16 forward at D <= 256
#include "flash_bwd_sm90.cuh"   // the bf16 backward at D = 64, 128
#include "flash_wide_sm90.cuh"  // bf16 D > 256 both ways, D = 256 backward
#include "flash_f32_wide.cuh"   // fp32 D > 256, both directions

namespace {

// The fp32 forward (plain FMA: TF32 would miss the fp32 reference) keeps
// the first slices' SIMT design: one CTA of 4 warps per (64-row q tile, q
// head, batch row), the q tile, one k and one v tile of BN rows, the score
// and probability tiles and the output accumulator in shared memory, a lane
// pair per q row. BN is 64, or 32 at D = 256 so the tiles fit.
template <int D>
constexpr int kFwdF32BN = D == 256 ? 32 : 64;

template <int D, int BN>
struct FwdGeom {
  static constexpr int kLdT = kLdTile<float, D>;  // q/k/v tiles
  static constexpr int kLdS = BN + 4;             // scores, probabilities
  static constexpr int kLdO = D + 4;              // output accumulator
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(float) * kBM * kLdT;
  static constexpr size_t kV = kK + sizeof(float) * BN * kLdT;
  static constexpr size_t kS = kV + sizeof(float) * BN * kLdT;
  static constexpr size_t kP = kS + sizeof(float) * kBM * kLdS;
  static constexpr size_t kO = kP + sizeof(float) * kBM * kLdS;
  static constexpr size_t kM = kO + sizeof(float) * kBM * kLdO;
  static constexpr size_t kL = kM + sizeof(float) * kBM;
  static constexpr size_t kBytes = kL + sizeof(float) * kBM;
};

// S[this lane pair's row, its half of the columns] = Q . K^T.
template <int D, int BN>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       float* Ss, int r, int half) {
  using G = FwdGeom<D, BN>;
  const int c0 = half * (BN / 2);
  const float* q = Qs + r * G::kLdT;
  for (int c = c0; c < c0 + BN / 2; ++c) {
    const float* k = Ks + c * G::kLdT;
    float acc = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(q[d], k[d], acc);
    Ss[r * G::kLdS + c] = acc;
  }
}

// O[this lane pair's row, its half of the columns] += P . V.
template <int D, int BN>
__device__ __forceinline__ void accumulate_pv(const float* Ps,
                                              const float* Vs, float* Os,
                                              int r, int half) {
  using G = FwdGeom<D, BN>;
  const float* p = Ps + r * G::kLdS;
  float* o = Os + r * G::kLdO;
  for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) {
    float acc = o[d];
    for (int c = 0; c < BN; ++c) acc = fmaf(p[c], Vs[c * G::kLdT + d], acc);
    o[d] = acc;
  }
}

template <int D, int BN, bool kDrop, bool kSegs>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(FwdArgs a) {
  using T = float;
  using G = FwdGeom<D, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + G::kQ);
  T* Ks = reinterpret_cast<T*>(smem + G::kK);
  T* Vs = reinterpret_cast<T*>(smem + G::kV);
  float* Ss = reinterpret_cast<float*>(smem + G::kS);
  float* Ps = reinterpret_cast<float*>(smem + G::kP);
  float* Os = reinterpret_cast<float*>(smem + G::kO);
  float* Ms = reinterpret_cast<float*>(smem + G::kM);
  float* Ls = reinterpret_cast<float*>(smem + G::kL);

  // heaviest causal q tiles first: they have the most kv tiles to walk
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);    // this q head's KV head (_kv_map)
  const uint32_t bh = (uint32_t)(b * a.H + h);  // dropout's row word 1
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const Mask<kSegs> mask = mask_of<kSegs>(a, b);
  const T* qg = static_cast<const T*>(a.q) + (long)b * a.Lq * a.q_row +
                (long)h * D;
  const long kv_base = (long)b * a.Lk * a.kv_row + (long)hk * D;
  const T* kg = static_cast<const T*>(a.k) + kv_base;
  const T* vg = static_cast<const T*>(a.v) + kv_base;

  load_tile<T, D, true>(Qs, qg, q0, kBM, a.Lq, a.q_row, a.sm_scale);
  for (int i = threadIdx.x; i < kBM * G::kLdO; i += kThreads) Os[i] = 0.0f;
  if (threadIdx.x < kBM) {
    Ms[threadIdx.x] = kNegInf;
    Ls[threadIdx.x] = 0.0f;
  }

  // the row this lane pair owns, and which half of the columns
  const int r = warp * 16 + (lane >> 1);
  const int qrow = q0 + r;
  const int half = lane & 1;
  // keys below len; causal: the tile's last row sees keys up to q0 + 63 +
  // offset
  const int kv_end =
      a.causal ? min(mask.len, max(0, q0 + kBM + mask.offset)) : mask.len;

  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    __syncthreads();  // previous tile fully consumed (and Q/O/M/L ready)
    load_tile<T, D, false>(Ks, kg, n0, BN, a.Lk, a.kv_row, 1.0f);
    load_tile<T, D, false>(Vs, vg, n0, BN, a.Lk, a.kv_row, 1.0f);
    __syncthreads();

    scores<D, BN>(Qs, Ks, Ss, r, half);
    __syncwarp();

    // online softmax over this row's half of the tile
    float* srow = Ss + r * G::kLdS;
    float* prow = Ps + r * G::kLdS;
    const int c0 = half * (BN / 2);
    float mx = kNegInf;
    for (int c = c0; c < c0 + BN / 2; ++c) {
      const float s = mask(qrow, n0 + c) ? srow[c] : kNegInf;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = Ms[r];
    const float m_cur = fmaxf(m_prev, mx);
    const float corr = expf(m_prev - m_cur);
    float sum = 0.0f;
    for (int c = c0; c < c0 + BN / 2; c += 4) {
      uint4 w;
      if constexpr (kDrop)
        w = keep_words(a.drop, (uint32_t)(n0 + c) >> 2, (uint32_t)qrow, bh,
                       kSaltAttention);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            mask(qrow, n0 + c + e) ? expf(srow[c + e] - m_cur) : 0.0f;
        sum += p;  // l from the undropped p
        float pv = p;
        if constexpr (kDrop) pv = p * keep_factor(a.drop, word_of(w, e));
        prow[c + e] = pv;
      }
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

    accumulate_pv<D, BN>(Ps, Vs, Os, r, half);
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
      og[(long)gr * a.o_row + d] = Os[rr * G::kLdO + d] / l;
    }
  }
  if (threadIdx.x < kBM && q0 + threadIdx.x < a.Lq) {
    const int rr = threadIdx.x;
    a.lse[((long)b * a.H + h) * a.Lq + q0 + rr] =
        Ms[rr] + logf(fmaxf(Ls[rr], 1e-30f));
  }
}

template <int D, bool kDrop, bool kSegs>
cudaError_t launch_fwd_f32(const FwdArgs& a, int B, cudaStream_t stream) {
  constexpr int BN = kFwdF32BN<D>;
  using G = FwdGeom<D, BN>;
  auto kernel = flash_fwd_f32_kernel<D, BN, kDrop, kSegs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lq + kBM - 1) / kBM, a.H, B);
  kernel<<<grid, kThreads, G::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool kDrop, bool kSegs>
cudaError_t launch_fwd(const FwdArgs& a, int B, int is_bf16,
                       cudaStream_t st) {
  return is_bf16 ? sm90::launch<D, kDrop, kSegs>(a, B, st)
                 : launch_fwd_f32<D, kDrop, kSegs>(a, B, st);
}

// The head sizes up to 256 the launchers are built for: every size of the
// [B, L, H, D] layout, and the pair layout's (whole 128-column blocks of
// heads); above 256 every multiple of 64 runs the wide:: (bf16) and
// f32w:: (fp32) kernels. The wrappers pad any other head size up to the
// next of them with zero columns.
template <int... Ds>
struct HeadDims {};
using FlatHeadDims = HeadDims<64, 80, 96, 128, 256>;
using PairHeadDims = HeadDims<64, 128, 256>;

// The forward for input type (bf16: the wgmma kernels; fp32: the FFMA
// kernels) and head size D (one of Ds, or a multiple of 64 above 256),
// with dropout (kDrop, a.drop) or without, with segment ids (kSegs, a.q_seg
// and a.k_seg) or without; returns the cudaError_t of the launch
// (cudaErrorInvalidValue also when a TMA descriptor cannot be encoded).
// `work` is read only in bf16 at D > 256: the wide kernel's scaled copy of
// q (bf16 [B, Lq, H*D], written by its scale_q_kernel launch).
template <bool kDrop, bool kSegs, int... Ds>
int flash_fwd(HeadDims<Ds...>, const FwdArgs& a, float* work, int B, int D,
              int is_bf16, cudaStream_t st) {
  if (B <= 0 || a.Lq <= 0 || a.Lk <= 0 || a.H <= 0 || a.Hkv <= 0 ||
      a.H % a.Hkv || (kSegs && (!a.q_seg || !a.k_seg)))
    return (int)cudaErrorInvalidValue;
  if (D > 256)
    return (int)(is_bf16
                     ? wide::launch_fwd<kDrop, kSegs>(
                           a, reinterpret_cast<__nv_bfloat16*>(work), B, D,
                           st)
                     : f32w::launch_fwd<kDrop, kSegs>(a, B, D, st));
  int rc = (int)cudaErrorInvalidValue;
  ((D == Ds ? (rc = (int)launch_fwd<Ds, kDrop, kSegs>(a, B, is_bf16, st))
            : 0),
   ...);
  return rc;
}

// ----------------------------------------------------------------- backward

// kv rows of a backward CTA (the WMMA and SIMT bodies): 64, or 32 at D =
// 256 (fp32) so the tiles fit in shared memory and dK/dV in registers.
template <int D>
constexpr int kBwdBN = D == 256 ? 32 : 64;

// Shared-memory geometry; every region size is a multiple of 128 bytes.
//   K, V                   : [BN][kLdT] T
//   Q (unscaled), dO       : [64][kLdT] T
//   Qs (q * scale, rounded): [64][kLdT] T           (bf16 only)
//   S, dP                  : [64][kLdS] float       (fp32: p and ds in place)
//   P, dS                  : [64][kLdP] T           (bf16 only)
//   dQ/dK/dV staging       : [64][kLdQ] float       (bf16 only)
//   lse, delta             : [64] float
template <typename T, int D, int BN>
struct BwdGeom {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kLdT = kLdTile<T, D>;
  static constexpr int kLdS = BN + 4;
  static constexpr int kLdP = BN + 16 / (int)sizeof(T);
  static constexpr int kLdQ = D + 4;
  static constexpr size_t kTileQ = sizeof(T) * kBM * kLdT;
  static constexpr size_t kTileKV = sizeof(T) * BN * kLdT;
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + kTileKV;
  static constexpr size_t kQ = kV + kTileKV;
  static constexpr size_t kDO = kQ + kTileQ;
  static constexpr size_t kQs = kDO + kTileQ;
  static constexpr size_t kS = kQs + (kBf16 ? kTileQ : 0);
  static constexpr size_t kDP = kS + sizeof(float) * kBM * kLdS;
  static constexpr size_t kP = kDP + sizeof(float) * kBM * kLdS;
  static constexpr size_t kDS = kP + (kBf16 ? sizeof(T) * kBM * kLdP : 0);
  static constexpr size_t kDQ = kDS + (kBf16 ? sizeof(T) * kBM * kLdP : 0);
  static constexpr size_t kLse = kDQ + (kBf16 ? sizeof(float) * kBM * kLdQ : 0);
  static constexpr size_t kDelta = kLse + sizeof(float) * kBM;
  static constexpr size_t kBytes = kDelta + sizeof(float) * kBM;
  // bf16: warp w owns kv rows [16 * (w % kRowBlocks), +16) and columns
  // [(w / kRowBlocks) * kCols, +kCols) of dK and dV
  static constexpr int kRowBlocks = BN / 16;
  static constexpr int kCols = D / (kWarps / kRowBlocks);
  __device__ static int row0(int warp) {
    return (kRowBlocks == kWarps ? warp : warp % kRowBlocks) * 16;
  }
  __device__ static int col0(int warp) {  // 0 when a warp owns all of D
    return kRowBlocks == kWarps ? 0 : (warp / kRowBlocks) * kCols;
  }
  // fp32: thread t owns kv row t / kTpr, columns [(t % kTpr) * D / kTpr,
  // +D / kTpr)
  static constexpr int kTpr = kThreads / BN;
  static_assert(kBytes <= 232448, "backward tiles exceed shared memory");
};

// dK/dV accumulators, fp32, live for the CTA's whole walk.
template <typename T, int D, int BN>
struct Acc;
template <int D, int BN>
struct Acc<__nv_bfloat16, D, BN> {
  static constexpr int kFrags = BwdGeom<__nv_bfloat16, D, BN>::kCols / 16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      dk[kFrags], dv[kFrags];
};
template <int D, int BN>
struct Acc<float, D, BN> {
  static constexpr int kN = D / BwdGeom<float, D, BN>::kTpr;
  float dk[kN], dv[kN];
};

// One (q tile, kv tile) step on the tensor cores (bf16, the WMMA body).
// dqg points at this head's dq scratch, whose rows are q_stride apart; bh =
// b * H + h keys the dropout words.
template <int D, int BN, bool kDrop, class M>
__device__ __forceinline__ void step_bf16(
    Acc<__nv_bfloat16, D, BN>& acc, unsigned char* smem, int m0, int n0,
    M mask, float* dqg, long q_stride, int warp, int lane,
    const DropParams& drop, uint32_t bh) {
  using namespace nvcuda;
  using T = __nv_bfloat16;
  using G = BwdGeom<T, D, BN>;
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
  // keep only BN / 16 accumulator fragments live beside dK/dV)
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const T* A = pass == 0 ? QSs : DOs;
    const T* Bm = pass == 0 ? Ks : Vs;
    float* out = pass == 0 ? Ss : DPs;
    FragC c[BN / 16];
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(c[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, A + warp * 16 * G::kLdT + kk, G::kLdT);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        // a [n][d] row-major tile is its transpose in column-major order
        FragBt bt;
        wmma::load_matrix_sync(bt, Bm + j * 16 * G::kLdT + kk, G::kLdT);
        wmma::mma_sync(c[j], fa, bt, c[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wmma::store_matrix_sync(out + warp * 16 * G::kLdS + j * 16, c[j],
                              G::kLdS, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // p and ds for this warp's rows: a lane pair per row, BN / 2 columns each
  {
    const int r = warp * 16 + (lane >> 1);
    const int qrow = m0 + r;
    const int c0 = (lane & 1) * (BN / 2);
    const float l = Lse[r];
    const float dl = Delta[r];
    for (int c = c0; c < c0 + BN / 2; c += 4) {
      uint4 w;
      if constexpr (kDrop)
        w = keep_words(drop, (uint32_t)(n0 + c) >> 2, (uint32_t)qrow, bh,
                       kSaltAttention);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = c + e;
        const float p = mask(qrow, n0 + cc)
                            ? expf(Ss[r * G::kLdS + cc] - l) : 0.0f;
        float dp = DPs[r * G::kLdS + cc];
        float p_dv = p;
        if constexpr (kDrop) {
          const float f = keep_factor(drop, word_of(w, e));
          p_dv = p * f;
          dp = dp * f;
        }
        const float ds = p * (dp - dl);
        Ps[r * G::kLdP + cc] = from_f<T>(p_dv);  // rounded to dO's type
        DSs[r * G::kLdP + cc] = from_f<T>(ds);   // rounded to the input type
      }
    }
  }
  __syncthreads();  // dV and dK read every q row's p and ds

  // dV += P^T . dO and dK += dS^T . Q for this warp's kv rows and columns
  const int rb = G::row0(warp);
  const int cb = G::col0(warp);
#pragma unroll
  for (int kk = 0; kk < kBM; kk += 16) {
    FragAt pt, dst;
    wmma::load_matrix_sync(pt, Ps + kk * G::kLdP + rb, G::kLdP);
    wmma::load_matrix_sync(dst, DSs + kk * G::kLdP + rb, G::kLdP);
#pragma unroll
    for (int j = 0; j < G::kCols / 16; ++j) {
      FragB bdo, bq;
      wmma::load_matrix_sync(bdo, DOs + kk * G::kLdT + cb + j * 16, G::kLdT);
      wmma::mma_sync(acc.dv[j], pt, bdo, acc.dv[j]);
      wmma::load_matrix_sync(bq, Qs + kk * G::kLdT + cb + j * 16, G::kLdT);
      wmma::mma_sync(acc.dk[j], dst, bq, acc.dk[j]);
    }
  }

  // dQ partial = dS . K for this warp's 16 q rows, staged and added to the
  // fp32 scratch with atomics (unscaled: the conversion scales)
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    FragC c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
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
                DQs[(warp * 16 + rr) * G::kLdQ + d]);
    }
  }
}

// One (q tile, kv tile) step with plain FMA (fp32).
template <int D, int BN, bool kDrop, class M>
__device__ __forceinline__ void step_f32(Acc<float, D, BN>& acc,
                                         unsigned char* smem, int m0, int n0,
                                         M mask, float sm_scale,
                                         float* dqg, long q_stride,
                                         const DropParams& drop,
                                         uint32_t bh) {
  using T = float;
  using G = BwdGeom<T, D, BN>;
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

  // s, p, dp and ds for q row r, kv columns [half * BN / 2, +BN / 2)
  {
    const int qrow = m0 + r;
    const float l = Lse[r];
    const float dl = Delta[r];
    const T* q = Qs + r * G::kLdT;
    const T* dout = DOs + r * G::kLdT;
    for (int c4 = half * (BN / 2); c4 < (half + 1) * (BN / 2); c4 += 4) {
      uint4 w;
      if constexpr (kDrop)
        w = keep_words(drop, (uint32_t)(n0 + c4) >> 2, (uint32_t)qrow, bh,
                       kSaltAttention);
      for (int e = 0; e < 4; ++e) {
        const int c = c4 + e;
        const T* k = Ks + c * G::kLdT;
        const T* v = Vs + c * G::kLdT;
        float s = 0.0f, dp = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s = fmaf(q[d] * sm_scale, k[d], s);
          dp = fmaf(dout[d], v[d], dp);
        }
        const float p = mask(qrow, n0 + c) ? expf(s - l) : 0.0f;
        float p_dv = p;
        if constexpr (kDrop) {
          const float f = keep_factor(drop, word_of(w, e));
          p_dv = p * f;
          dp = dp * f;
        }
        Ps[r * G::kLdS + c] = p_dv;
        DSs[r * G::kLdS + c] = p * (dp - dl);
      }
    }
  }
  __syncthreads();  // dV and dK read every q row's p and ds

  // dV += P^T . dO and dK += dS^T . Q for this thread's kv row and columns
  {
    const int kr = threadIdx.x / G::kTpr;
    const int d0 = (threadIdx.x % G::kTpr) * Acc<float, D, BN>::kN;
    for (int c = 0; c < kBM; ++c) {
      const float p = Ps[c * G::kLdS + kr];
      const float ds = DSs[c * G::kLdS + kr];
      const T* dout = DOs + c * G::kLdT + d0;
      const T* q = Qs + c * G::kLdT + d0;
#pragma unroll
      for (int dd = 0; dd < Acc<float, D, BN>::kN; ++dd) {
        acc.dv[dd] = fmaf(p, dout[dd], acc.dv[dd]);
        acc.dk[dd] = fmaf(ds, q[dd], acc.dk[dd]);
      }
    }
  }

  // dQ partial = dS . K for q row r, this thread's half of the columns, a
  // chunk at a time
  constexpr int kChunk = (D / 2) % 16 == 0 ? 16 : 8;
  const int d0 = half * (D / 2);
  const int qrow = m0 + r;
#pragma unroll
  for (int j = 0; j < D / 2; j += kChunk) {
    float part[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e) part[e] = 0.0f;
    for (int c = 0; c < BN; ++c) {
      const float ds = DSs[r * G::kLdS + c];
      const T* k = Ks + c * G::kLdT + d0 + j;
#pragma unroll
      for (int e = 0; e < kChunk; ++e) part[e] = fmaf(ds, k[e], part[e]);
    }
    if (qrow < mask.Lq) {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        atomicAdd(dqg + (long)qrow * q_stride + d0 + j + e, part[e]);
      }
    }
  }
}

template <typename T, int D, int BN, bool kDrop, bool kSegs>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(BwdArgs a) {
  using G = BwdGeom<T, D, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + G::kK);
  T* Vs = reinterpret_cast<T*>(smem + G::kV);
  T* Qs = reinterpret_cast<T*>(smem + G::kQ);
  T* DOs = reinterpret_cast<T*>(smem + G::kDO);
  T* QSs = reinterpret_cast<T*>(smem + G::kQs);
  float* Lse = reinterpret_cast<float*>(smem + G::kLse);
  float* Delta = reinterpret_cast<float*>(smem + G::kDelta);

  const int n0 = blockIdx.x * BN;  // kv tile 0 walks the most q tiles
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.H / a.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long do_row = (long)a.H * D;  // dO and the dq scratch: contiguous
  const Mask<kSegs> mask = mask_of<kSegs>(a, b);
  const long kv_base = (long)b * a.Lk * a.kv_row + (long)hk * D;

  if (n0 >= mask.len) {
    // every key of this tile is past the length: no query sees it, so its
    // dk and dv are zero, and it adds nothing to dq
    const long base = (long)b * a.Lk * a.dkv_row + (long)hk * D;
    for (int i = threadIdx.x; i < BN * D; i += kThreads) {
      const int gr = n0 + i / D;
      if (gr < a.Lk) {
        const long at = base + (long)gr * a.dkv_row + i % D;
        static_cast<T*>(a.dk)[at] = from_f<T>(0.0f);
        static_cast<T*>(a.dv)[at] = from_f<T>(0.0f);
      }
    }
    return;
  }

  load_tile<T, D, false>(Ks, static_cast<const T*>(a.k) + kv_base, n0, BN,
                         a.Lk, a.kv_row, 1.0f);
  load_tile<T, D, false>(Vs, static_cast<const T*>(a.v) + kv_base, n0, BN,
                         a.Lk, a.kv_row, 1.0f);

  Acc<T, D, BN> acc;
  if constexpr (G::kBf16) {
#pragma unroll
    for (int j = 0; j < Acc<T, D, BN>::kFrags; ++j) {
      nvcuda::wmma::fill_fragment(acc.dk[j], 0.0f);
      nvcuda::wmma::fill_fragment(acc.dv[j], 0.0f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < Acc<T, D, BN>::kN; ++j) {
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
    const float* lseg = a.lse_pad + ((long)b * a.H + h) * a.Lq_pad;
    const float* deltag = a.delta + ((long)b * a.H + h) * a.Lq_pad;
    float* dqg = a.dq_acc + (long)b * a.Lq * do_row + (long)h * D;
    for (int m0 = m_begin; m0 < a.Lq; m0 += kBM) {
      __syncthreads();  // the previous step is done with Q, dO, P, dS
      load_tile<T, D, false>(Qs, qg, m0, kBM, a.Lq, a.q_row, 1.0f);
      if constexpr (G::kBf16) {
        load_tile<T, D, true>(QSs, qg, m0, kBM, a.Lq, a.q_row, a.sm_scale);
      }
      load_tile<T, D, false>(DOs, dog, m0, kBM, a.Lq, do_row, 1.0f);
      if (threadIdx.x < kBM) {
        const int gr = m0 + threadIdx.x;
        Lse[threadIdx.x] = gr < a.Lq ? lseg[gr] : 0.0f;
        Delta[threadIdx.x] = gr < a.Lq ? deltag[gr] : 0.0f;
      }
      __syncthreads();
      const uint32_t bh = (uint32_t)(b * a.H + h);
      if constexpr (G::kBf16) {
        step_bf16<D, BN, kDrop>(acc, smem, m0, n0, mask, dqg, do_row, warp,
                                lane, a.drop, bh);
      } else {
        step_f32<D, BN, kDrop>(acc, smem, m0, n0, mask, a.sm_scale, dqg,
                               do_row, a.drop, bh);
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
    const int rb = G::row0(warp);
    const int cb = G::col0(warp);
    __syncthreads();
#pragma unroll
    for (int part = 0; part < 2; ++part) {
#pragma unroll
      for (int j = 0; j < Acc<T, D, BN>::kFrags; ++j) {
        nvcuda::wmma::store_matrix_sync(
            stage + rb * G::kLdQ + cb + j * 16,
            part == 0 ? acc.dk[j] : acc.dv[j], G::kLdQ,
            nvcuda::wmma::mem_row_major);
      }
      __syncwarp();
      T* dst = part == 0 ? dk_out : dv_out;
      const float mul = part == 0 ? a.sm_scale : 1.0f;
      for (int i = lane; i < 16 * G::kCols; i += 32) {
        const int rr = i / G::kCols;
        const int d = cb + i % G::kCols;
        const int gr = n0 + rb + rr;
        if (gr < a.Lk) {
          dst[(long)gr * a.dkv_row + d] =
              from_f<T>(stage[(rb + rr) * G::kLdQ + d] * mul);
        }
      }
      __syncwarp();
    }
  } else {
    constexpr int kN = Acc<T, D, BN>::kN;
    const int gr = n0 + threadIdx.x / G::kTpr;
    const int d0 = (threadIdx.x % G::kTpr) * kN;
    if (gr < a.Lk) {
#pragma unroll
      for (int dd = 0; dd < kN; ++dd) {
        dk_out[(long)gr * a.dkv_row + d0 + dd] = acc.dk[dd] * a.sm_scale;
        dv_out[(long)gr * a.dkv_row + d0 + dd] = acc.dv[dd];
      }
    }
  }
}

// delta = rowsum(dO * O) in fp32 and the forward's lse, both into rows
// padded to Lq_pad (0 past Lq), and the dq scratch zeroed: a thread per
// (b, h, q row), then a grid-stride pass over the scratch.
template <typename T>
__global__ void bwd_prepass_kernel(BwdArgs a, int B, int D) {
  const long hd = (long)a.H * D;
  const long stride = (long)gridDim.x * blockDim.x;
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long rows = (long)B * a.H * a.Lq_pad;
  constexpr int kVec = 16 / sizeof(T);
  for (long i = tid; i < rows; i += stride) {
    const long bh = i / a.Lq_pad;
    const int r = (int)(i % a.Lq_pad);
    float l = 0.0f, dl = 0.0f;
    if (r < a.Lq) {
      const long b = bh / a.H, h = bh % a.H;
      l = a.lse[bh * a.Lq + r];
      const long at = (b * a.Lq + r) * hd + h * D;
      const T* o = static_cast<const T*>(a.out) + at;
      const T* g = static_cast<const T*>(a.dout) + at;
      // blocked: kVec running sums over a 32-column block, then the
      // blocks' totals (short fp32 chains at every D)
      for (int c0 = 0; c0 < D; c0 += 32) {
        float part[kVec] = {};
        for (int c = c0; c < min(D, c0 + 32); c += kVec) {
          const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
          const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
          const T* oe = reinterpret_cast<const T*>(&ov);
          const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            part[e] = fmaf(to_f(oe[e]), to_f(ge[e]), part[e]);
        }
        float blk = 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) blk += part[e];
        dl += blk;
      }
    }
    a.lse_pad[i] = l;
    a.delta[i] = dl;
  }
  const long n4 = (long)B * a.Lq * hd / 4;
  for (long i = tid; i < n4; i += stride)
    reinterpret_cast<float4*>(a.dq_acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dq's fp32 scratch [rows, hd] times `scale` -> dq's rows (dq_row apart),
// input type.
template <typename T>
__global__ void dq_convert_kernel(const float* __restrict__ dq_acc,
                                  T* __restrict__ dq, long n, int hd,
                                  long dq_row, float scale) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    dq[(i / hd) * dq_row + i % hd] = from_f<T>(dq_acc[i] * scale);
  }
}

// The backward body at head size D (D <= 256): in bf16 the Hopper body
// (64, 128), the wide body (256) or the WMMA body (80, 96); in fp32 the
// SIMT body.
template <typename T, int D, bool kDrop, bool kSegs>
cudaError_t launch_bwd_body(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (kBf16 && sm90::bwd_sm90_takes(D)) {
    return sm90::launch_bwd<D, kDrop, kSegs>(a, B, stream);
  } else if constexpr (kBf16 && wide::bwd_takes(D)) {
    return wide::launch_bwd<kDrop, kSegs>(a, bwd_qs(a, B), B, D, stream);
  } else {
    constexpr int BN = kBwdBN<D>;
    using G = BwdGeom<T, D, BN>;
    auto kernel = flash_bwd_kernel<T, D, BN, kDrop, kSegs>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Lk + BN - 1) / BN, a.Hkv, B);
    kernel<<<grid, kThreads, G::kBytes, stream>>>(a);
    return cudaGetLastError();
  }
}

// The launches of one backward in input type T: the pre-pass, the body (D >
// 256: wide:: in bf16, f32w:: in fp32; else one of Ds), the dq conversion.
template <typename T, bool kDrop, bool kSegs, int... Ds>
cudaError_t launch_bwd_all(HeadDims<Ds...>, const BwdArgs& a, int B, int D,
                           cudaStream_t st) {
  const long rows = (long)B * a.H * a.Lq_pad;
  const long n = (long)B * a.Lq * a.H * D;
  bwd_prepass_kernel<T><<<grid_for(rows > n / 4 ? rows : n / 4), 256, 0,
                          st>>>(a, B, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaErrorInvalidValue;
  if (D > 256) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      err = wide::launch_bwd<kDrop, kSegs>(a, bwd_qs(a, B), B, D, st);
    else
      err = f32w::launch_bwd<kDrop, kSegs>(a, B, D, st);
  } else {
    ((D == Ds ? (err = launch_bwd_body<T, Ds, kDrop, kSegs>(a, B, st)) : err),
     ...);
  }
  if (err != cudaSuccess) return err;
  dq_convert_kernel<T><<<grid_for(n), 256, 0, st>>>(
      a.dq_acc, static_cast<T*>(a.dq), n, a.H * D, a.dq_row, a.sm_scale);
  return cudaGetLastError();
}

// The backward for input type (bf16 or fp32) and head size D (one of Ds,
// or a multiple of 64 above 256), with dropout (kDrop, a.drop) or
// without, with segment ids (kSegs) or without; `work` is the fp32
// workspace of bwd_work_floats. Returns the cudaError_t of the launches.
template <bool kDrop, bool kSegs, int... Ds>
int flash_bwd(HeadDims<Ds...> dims, BwdArgs a, float* work, int B, int D,
              int is_bf16, cudaStream_t st) {
  if (B <= 0 || a.Lq <= 0 || a.Lk <= 0 || a.H <= 0 || a.Hkv <= 0 ||
      a.H % a.Hkv || (kSegs && (!a.q_seg || !a.k_seg)) ||
      (D > 256 && D % 64) || work == nullptr)
    return (int)cudaErrorInvalidValue;
  bwd_set_work(a, work, B, D);
  return (int)(is_bf16
                   ? launch_bwd_all<__nv_bfloat16, kDrop, kSegs>(dims, a, B,
                                                                 D, st)
                   : launch_bwd_all<float, kDrop, kSegs>(dims, a, B, D, st));
}

}  // namespace
