// Flash-attention backward on the [B, L, H, D] layout with grouped-query
// attention, per-sequence key lengths, segment ids and in-kernel dropout,
// for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py
// `_flash_bwd_fused_kernel` (:340, launched by `_flash_bwd` when the whole
// sequence fits one tile pair) and the split pair `_flash_dq_kernel` (:204)
// + `_flash_dkv_kernel` (:267) that take over otherwise, together with the
// XLA group sum of dk/dv that follows them under GQA, with their `kv_lens`,
// segment ids and dropout. All compute one function; this kernel keeps only tile-sized state,
// so it has no length cutoff and does the job of every form.
//
// From q [B, Lq, H, D], k, v [B, Lk, Hkv, D], O and dO [B, Lq, H, D] and
// lse [B, H, Lq] (fp32; delta = rowsum(dO * O) comes from the pre-pass
// launch): dq [B, Lq, H, D] and dk, dv
// [B, Lk, Hkv, D], each KV head's gradient summed in fp32 over its group of
// q heads by the CTA that owns its kv tile (no per-head scratch, no second
// pass). A kv tile past the batch row's length gets zero dk, dv from a CTA
// that loads nothing. The dropout keep mask is the forward's, regenerated
// from the same seed (philox.cuh, keyed on the element). The kernel is
// flash_attention.cuh's backward; that header gives the math, the rounding
// points and the design.
//
// Bound on the H100: operations = 10*D*B*H*(attended pairs), five products
// of 2*D a pair; bytes = q, k, v, O, dO and lse read once plus dq, dk, dv
// written once (the workspace's traffic is not counted). At LLaMA-7B's
// training shape (B=4, L=2048, H=32, D=128,
// causal, bf16) that is 344 GFLOP (0.348 ms at 989 TFLOP/s) against 538 MB
// (0.161 ms at 3.35 TB/s): operations bound it. At BERT's padded shape
// (B=64, L=512, H=12, D=64, ~53% of the pairs attended) ~68 GFLOP (0.07
// ms) against 403 MB (0.12 ms): bytes bound it.

// Head sizes 64, 80, 96, 128, 256 and every multiple of 64 above 256 are
// built: bf16 at 64, 80, 96 and 128 runs the Hopper body of
// flash_bwd_sm90.cuh, at 256 and above the wide Hopper body of
// flash_wide_sm90.cuh (dK/dV in 128-column slices); fp32 the FFMA kernels
// of flash_f32_wide.cuh (flash_attention.cuh sets out the dispatch).

#include "flash_attention.cuh"

// C entry point, bound with ctypes. Returns the cudaError_t of the launches
// (0 on success). The caller has checked shapes, types, contiguity and
// alignment: q, out and dout are [B, Lq, H, D]; k, v, dk and dv [B, Lk,
// Hkv, D], all of the input type; lse [B, H, Lq] fp32, the forward's;
// work an fp32 workspace of bwd_work_floats(B, Lq, Lk, H, D, is_bf16)
// floats, whose dq slabs the caller then sums into dq (dq_sum.cu);
// lens, q_seg, k_seg and the dropout arguments are the forward's.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* work, void* dk, void* dv,
    const void* lens, const void* q_seg, const void* k_seg, int B, int Lq,
    int Lk, int H, int Hkv, int D, int is_bf16, int causal,
    float sm_scale, int dropout, unsigned seed_lo, unsigned seed_hi,
    unsigned threshold, float keep_scale, void* stream) {
  const long q_row = (long)H * D, kv_row = (long)Hkv * D;
  BwdArgs a{q, k, v, out, dout, static_cast<const float*>(lse), nullptr,
            nullptr, nullptr, dk, dv, q_row, kv_row, kv_row, Lq, Lk, H,
            Hkv, 0, sm_scale, causal,
            {seed_lo, seed_hi, threshold, keep_scale},
            static_cast<const int*>(lens), static_cast<const int*>(q_seg),
            static_cast<const int*>(k_seg)};
  float* w = static_cast<float*>(work);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FlatHeadDims dims{};
  if (q_seg != nullptr) {
    return dropout ? flash_bwd<true, true>(dims, a, w, B, D, is_bf16, st)
                   : flash_bwd<false, true>(dims, a, w, B, D, is_bf16, st);
  }
  return dropout ? flash_bwd<true, false>(dims, a, w, B, D, is_bf16, st)
                 : flash_bwd<false, false>(dims, a, w, B, D, is_bf16, st);
}
