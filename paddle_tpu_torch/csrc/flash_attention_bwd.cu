// Flash-attention backward on the [B, L, H, D] layout with grouped-query
// attention, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py
// `_flash_bwd_fused_kernel` (:340, launched by `_flash_bwd` when the whole
// sequence fits one tile pair) and the split pair `_flash_dq_kernel` (:204)
// + `_flash_dkv_kernel` (:267) that take over otherwise, together with the
// XLA group sum of dk/dv that follows them under GQA. All compute one
// function; this kernel keeps only tile-sized state, so it has no length
// cutoff and does the job of both forms. Dropout rate 0, no kv_lens, no
// segment ids.
//
// From q [B, Lq, H, D], k, v [B, Lk, Hkv, D], dO [B, Lq, H, D], lse and
// delta = rowsum(dO * O) [B, H, Lq] (fp32): dq [B, Lq, H, D] and dk, dv
// [B, Lk, Hkv, D], each KV head's gradient summed in fp32 over its group of
// q heads by the CTA that owns its kv tile (no per-head scratch, no second
// pass). The kernel is flash_attention.cuh's backward; that header gives
// the math, the rounding points and the design.
//
// Bound on the H100: operations = 10*D*B*H*(attended pairs), five products
// of 2*D a pair; bytes = q, k, v, O, dO and lse read once plus dq, dk, dv
// written once. At LLaMA-7B's training shape (B=4, L=2048, H=32, D=128,
// causal, bf16) that is 344 GFLOP (0.348 ms at 989 TFLOP/s) against 538 MB
// (0.161 ms at 3.35 TB/s): operations bound it.

#include "flash_attention.cuh"

// C entry point, bound with ctypes. Returns the cudaError_t of the launches
// (0 on success). The caller has checked shapes, types, contiguity and
// alignment: q, dout and dq are [B, Lq, H, D]; k, v, dk and dv [B, Lk, Hkv,
// D], all of the input type; lse and delta [B, H, Lq] fp32; dq_acc [B, Lq,
// H, D] fp32, zeroed.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq_acc, void* dq, void* dk, void* dv,
                                   int B, int Lq, int Lk, int H, int Hkv,
                                   int D, int is_bf16, int causal,
                                   float sm_scale, void* stream) {
  const long q_row = (long)H * D, kv_row = (long)Hkv * D;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), static_cast<float*>(dq_acc), dq,
            dk, dv, q_row, kv_row, q_row, kv_row, Lq, Lk, H, Hkv, sm_scale,
            causal};
  return flash_bwd(a, B, D, is_bf16, static_cast<cudaStream_t>(stream));
}
