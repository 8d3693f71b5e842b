// Flash-attention forward on the [B, L, H, D] layout with grouped-query
// attention, per-sequence key lengths, segment ids and in-kernel dropout,
// for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py `_flash_fwd_kernel`
// (launched by `_flash_fwd`, public `flash_attention_blhd`), with its
// `kv_lens` (`lens_ref`), segment ids (`sq`/`sk`) and dropout.
//
// Queries q [B, Lq, H, D] against keys and values k, v [B, Lk, Hkv, D] (H a
// multiple of Hkv): the context out [B, Lq, H, D] and lse [B, H, Lq] fp32,
// causal (the diagonal aligned bottom-right, Lk - Lq) or bidirectional; key
// j of batch row b is attended only below lens[b] and, with segment ids,
// only by the queries of its segment. Head sizes 64, 80, 96, 128 and 256
// are built, and every multiple of 64 above 256. The kernel is
// flash_attention.cuh's forward: in bf16 the Hopper kernels, up to 256
// flash_fwd_sm90.cuh's, above 256 flash_wide_sm90.cuh's (O in 128-column
// slices, round(q * scale) in the workspace `work`), whose TMA descriptors
// read q as a 3-D tensor (H*D columns, Lq rows, B) and k, v as (Hkv*D, Lk,
// B), so no transpose to the Pallas [B*H, L, D] layout; in fp32 the FFMA
// kernels (above 256 flash_f32_wide.cuh's, O in shared memory).
// Those headers give the math, the rounding points and the design. K/V
// tiles are read once per q head of a group (from L2 after the first).
//
// Bound on the H100: operations = 4*D*B*H*(attended pairs), bytes = q, k, v
// read once and out, lse written once. At LLaMA-7B's training shape (B=4,
// L=2048, H=32, D=128, causal, bf16) that is 137 GFLOP (0.139 ms at 989
// TFLOP/s) against 270 MB (0.080 ms at 3.35 TB/s): operations bound it. At
// BERT's padded shape (B=64, L=512, H=12, D=64, mean length ~272) the
// attended pairs are ~53% of L^2 and the bytes bound it (0.06 ms). The
// length's tile skip saves the dead kv tiles; dropout adds one Philox call
// per 4 attended pairs, integer work that neither bound counts.

#include "flash_attention.cuh"

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success). The caller has checked shapes, types, contiguity and
// alignment: q and out are [B, Lq, H, D], k and v [B, Lk, Hkv, D], all of
// the input type and contiguous; lse is [B, H, Lq] fp32; lens ([B]), q_seg
// ([B, Lq]) and k_seg ([B, Lk]) are int32 or null (the segments both or
// neither); work is, in bf16 at D > 256, kernels/flash_pair.py
// fwd_work_floats floats (the scaled copy of q, bf16 [B, Lq, H*D]), else
// unread and may be null. With `dropout` set, the probabilities drop under
// the seed's words, the keep threshold and the scale of kernels/philox.py.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    void* work, const void* lens, const void* q_seg, const void* k_seg,
    int B, int Lq,
    int Lk, int H, int Hkv, int D, int is_bf16, int causal, float sm_scale,
    int dropout, unsigned seed_lo, unsigned seed_hi, unsigned threshold,
    float keep_scale, void* stream) {
  const long q_row = (long)H * D;
  FwdArgs a{q, k, v, out, static_cast<float*>(lse), q_row, (long)Hkv * D,
            q_row, Lq, Lk, H, Hkv, sm_scale, causal,
            {seed_lo, seed_hi, threshold, keep_scale},
            static_cast<const int*>(lens), static_cast<const int*>(q_seg),
            static_cast<const int*>(k_seg)};
  float* w = static_cast<float*>(work);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FlatHeadDims dims{};
  if (q_seg != nullptr) {
    return dropout ? flash_fwd<true, true>(dims, a, w, B, D, is_bf16, st)
                   : flash_fwd<false, true>(dims, a, w, B, D, is_bf16, st);
  }
  return dropout ? flash_fwd<true, false>(dims, a, w, B, D, is_bf16, st)
                 : flash_fwd<false, false>(dims, a, w, B, D, is_bf16, st);
}
