// Flash-attention forward and backward for Hopper (sm_90a), shared by the
// port's two attention layouts: the operands, the masks, the shared
// helpers, the backward's pre-pass and workspace, and the dispatch to
// the bodies of the headers included below. Each launcher source
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
//             fp32, D = 64, 80, 96, 128, 256   f32w::flash_fwd_f32_small_kernel
//                                              (flash_f32_wide.cuh: FFMA
//                                              register micro-tiles, Q in
//                                              shared memory, O in
//                                              registers; TF32 would miss
//                                              the fp32 reference)
//             fp32, D > 256 with D % 64 == 0   f32w::flash_fwd_f32_wide_kernel
//                                              (flash_f32_wide.cuh: FFMA
//                                              register micro-tiles, O in
//                                              shared memory, one pass)
//   backward  bf16, D = 64, 80, 96, 128        sm90::flash_bwd_sm90_kernel
//                                              (flash_bwd_sm90.cuh: TMA,
//                                              wgmma, dK/dV in registers,
//                                              bulk dq stores; 80 and 96
//                                              on 32-byte swizzle blocks)
//             bf16, D = 256, and D > 256 with  wide::flash_bwd_wide_kernel
//             D % 64 == 0                      (flash_wide_sm90.cuh: dK/dV
//                                              in 128-column slices, S^T
//                                              and dP^T over D in chunks)
//             fp32, D = 64, 80, 96, 128, 256   f32w::flash_bwd_f32_kernel
//                                              (flash_f32_wide.cuh: FFMA
//                                              register micro-tiles, dK and
//                                              dV in shared memory)
//             fp32, D > 256 with D % 64 == 0   f32w::flash_bwd_f32_wide_kernel
//                                              (the same body, in column
//                                              slices of up to 512)
//
// The [B, L, H, D] launchers take every one of those sizes; the pair
// launchers 64, 128, 256 and the multiples of 128 above 256 (the pair
// gate's whole 128-column blocks). The wrappers run any other D on
// zero-padded heads.
//
// Every backward is three launches on the stream: bwd_prepass_kernel
// (delta = rowsum(dO * O) in fp32 and a copy of lse, both at rows padded
// to a multiple of 64 so the bf16 body loads them with one bulk copy a q
// tile), the body, and dq_sum.cu's ordered sum (dq = the sum of the
// bodies' partial slabs in kv-tile order, times sm_scale, in the input
// type: the bodies write unscaled partials), which the wrapper launches
// behind this file's entry point. The slabs and the padded rows live in
// one fp32 workspace the wrapper allocates (bwd_work_floats), with, where
// a body needs it, the scaled copy of q (wide::, bf16 D >= 256: written
// by its scale_q_kernel launch, the body's fourth).
//
// Every backward body is FlashAttention-2's, extended over a GQA group: a
// CTA (or a cluster of them) owns a kv tile of one KV head and batch row,
// walks every q head of its group and, for each, the 64-row q tiles from
// the diagonal down (causal: the Pallas tile skip becomes the loop's
// start), recomputing s and p once per (q tile, kv tile) and feeding all
// three gradients from them. dk and dv accumulate in fp32 on chip for the
// whole walk, so the group sum needs no scratch; dq's partials go into a
// slab of the workspace per part (a kv tile, dq_parts.cuh) with plain
// stores, and the ordered sum adds the slabs in kv-tile order, so every
// gradient is the same bit for bit from launch to launch. State is
// tile-sized, so there is no length cutoff: one kernel does the job of
// the Pallas fused and split backward forms.
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
// exits before any load or dq store. Segment ids are the kSegs template
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

#include <stdint.h>
#include <type_traits>

#include "common.cuh"
#include "dq_parts.cuh"
#include "philox.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the Pallas kernels

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
// delta [B*H, Lq_pad] fp32, written by the pre-pass; dq_acc the bodies'
// dq partials, slab p (dq_parts.cuh) at dq_acc + p * dq_slab, each slab
// [B, Lq, H*D] fp32 (dq_slab floats), which dq_sum.cu sums into dq; dk
// and dv rows dkv_row apart (KV head hk at hk*D). drop, lens, q_seg and
// k_seg as in FwdArgs.
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
  void* dk;
  void* dv;
  long q_row, kv_row, dkv_row;
  int Lq, Lk, H, Hkv, Lq_pad;
  float sm_scale;
  int causal;
  DropParams drop;
  const int* lens;
  const int* q_seg;
  const int* k_seg;
  long dq_slab;
};

// The backward's fp32 workspace, in floats: dq's partial slabs
// (dq_parts(Lk, D, is_bf16) of [B, Lq, H*D]), lse_pad, delta and, in bf16
// at D >= 256, the scaled copy of q (the wide body's, bf16 [B, Lq, H*D]).
// kernels/flash_pair.py `bwd_work_floats` sizes it the same way.
inline long bwd_work_floats(int B, int Lq, int Lk, int H, int D,
                            int is_bf16) {
  const long lq_pad = (Lq + 63) / 64 * 64;
  const long slab = (long)B * Lq * H * D;
  const long base = dq_parts(Lk, D, is_bf16) * slab + 2L * B * H * lq_pad;
  return base + (is_bf16 && D >= 256 ? slab / 2 : 0L);
}

// Points a's scratch into `work` (bwd_work_floats(...) floats).
inline void bwd_set_work(BwdArgs& a, float* work, int B, int D,
                         int is_bf16) {
  a.Lq_pad = (a.Lq + 63) / 64 * 64;
  a.dq_slab = (long)B * a.Lq * a.H * D;
  a.dq_acc = work;
  a.lse_pad = work + dq_parts(a.Lk, D, is_bf16) * a.dq_slab;
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
#include "flash_bwd_sm90.cuh"   // the bf16 backward at D = 64, 80, 96, 128
#include "flash_wide_sm90.cuh"  // bf16 D > 256 both ways, D = 256 backward
#include "flash_f32_wide.cuh"   // fp32 both ways at every D

static_assert(sm90::kBwdRowsKV == 128 && sm90::kBwdRowsWG == 64 &&
                  sm90::kBwdRowsQ == kDqRowsQ && f32w::kKeys == 32 &&
                  f32w::kRows == kDqRowsQ,
              "dq_parts.cuh's parts are the backward bodies' tiles");

namespace {

template <int D, bool kDrop, bool kSegs>
cudaError_t launch_fwd(const FwdArgs& a, int B, int is_bf16,
                       cudaStream_t st) {
  return is_bf16 ? sm90::launch<D, kDrop, kSegs>(a, B, st)
                 : f32w::launch_fwd_small<D, kDrop, kSegs>(a, B, st);
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

// delta = rowsum(dO * O) in fp32 and the forward's lse, both into rows
// padded to Lq_pad (0 past Lq): a thread per (b, h, q row). The dq slabs
// are not zeroed: the bodies write every element the ordered sum reads.
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
}

// The bf16 backward body at head size D (D <= 256): the Hopper body (64,
// 80, 96, 128) or the wide body (256).
template <int D, bool kDrop, bool kSegs>
cudaError_t launch_bwd_bf16(const BwdArgs& a, int B, cudaStream_t stream) {
  static_assert(sm90::bwd_sm90_takes(D) || wide::bwd_takes(D),
                "a bf16 backward body for every built head size");
  if constexpr (sm90::bwd_sm90_takes(D))
    return sm90::launch_bwd<D, kDrop, kSegs>(a, B, stream);
  else
    return wide::launch_bwd<kDrop, kSegs>(a, bwd_qs(a, B), B, D, stream);
}

// The launches of one backward in input type T: the pre-pass, then the
// body (bf16: wide:: above 256, else one of Ds; fp32: f32w:: at every D,
// one of Ds up to 256). dq_sum.cu's ordered sum follows, from the
// wrapper.
template <typename T, bool kDrop, bool kSegs, int... Ds>
cudaError_t launch_bwd_all(HeadDims<Ds...>, const BwdArgs& a, int B, int D,
                           cudaStream_t st) {
  const long rows = (long)B * a.H * a.Lq_pad;
  bwd_prepass_kernel<T><<<grid_for(rows), 256, 0, st>>>(a, B, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (D > 256)
      err = wide::launch_bwd<kDrop, kSegs>(a, bwd_qs(a, B), B, D, st);
    else
      ((D == Ds ? (err = launch_bwd_bf16<Ds, kDrop, kSegs>(a, B, st)) : err),
       ...);
  } else if (D > 256 || ((D == Ds) || ...)) {
    err = f32w::launch_bwd<kDrop, kSegs>(a, B, D, st);
  }
  return err;
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
  bwd_set_work(a, work, B, D, is_bf16);
  return (int)(is_bf16
                   ? launch_bwd_all<__nv_bfloat16, kDrop, kSegs>(dims, a, B,
                                                                 D, st)
                   : launch_bwd_all<float, kDrop, kSegs>(dims, a, B, D, st));
}

}  // namespace
