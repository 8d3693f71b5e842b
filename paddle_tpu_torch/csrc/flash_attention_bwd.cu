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
// From q [B, Lq, H, D], k, v [B, Lk, Hkv, D], dO [B, Lq, H, D], lse and
// delta = rowsum(dO * O) [B, H, Lq] (fp32): dq [B, Lq, H, D] and dk, dv
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
// written once. At LLaMA-7B's training shape (B=4, L=2048, H=32, D=128,
// causal, bf16) that is 344 GFLOP (0.348 ms at 989 TFLOP/s) against 538 MB
// (0.161 ms at 3.35 TB/s): operations bound it. At BERT's padded shape
// (B=64, L=512, H=12, D=64, ~53% of the pairs attended) ~68 GFLOP (0.07
// ms) against 403 MB (0.12 ms): bytes bound it.

// Head sizes 64, 80, 96, 128 and 256 are built; at 256 a CTA owns 32
// kv rows, so the tiles fit in shared memory and dK/dV in registers.

#include "flash_attention.cuh"

// C entry point, bound with ctypes. Returns the cudaError_t of the launches
// (0 on success). The caller has checked shapes, types, contiguity and
// alignment: q, dout and dq are [B, Lq, H, D]; k, v, dk and dv [B, Lk, Hkv,
// D], all of the input type; lse and delta [B, H, Lq] fp32; dq_acc
// [B, Lq, H, D] fp32, zeroed; lens, q_seg, k_seg and the dropout arguments
// are the forward's.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq_acc, void* dq, void* dk,
    void* dv, const void* lens, const void* q_seg, const void* k_seg, int B,
    int Lq, int Lk, int H, int Hkv, int D, int is_bf16, int causal,
    float sm_scale, int dropout, unsigned seed_lo, unsigned seed_hi,
    unsigned threshold, float keep_scale, void* stream) {
  const long q_row = (long)H * D, kv_row = (long)Hkv * D;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), static_cast<float*>(dq_acc), dq,
            dk, dv, q_row, kv_row, q_row, kv_row, Lq, Lk, H, Hkv, sm_scale,
            causal, {seed_lo, seed_hi, threshold, keep_scale},
            static_cast<const int*>(lens), static_cast<const int*>(q_seg),
            static_cast<const int*>(k_seg)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FlatHeadDims dims{};
  if (q_seg != nullptr) {
    return dropout ? flash_bwd<true, true>(dims, a, B, D, is_bf16, st)
                   : flash_bwd<false, true>(dims, a, B, D, is_bf16, st);
  }
  return dropout ? flash_bwd<true, false>(dims, a, B, D, is_bf16, st)
                 : flash_bwd<false, false>(dims, a, B, D, is_bf16, st);
}
