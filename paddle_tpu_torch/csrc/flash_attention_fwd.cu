// Flash-attention forward on the [B, L, H, D] layout with grouped-query
// attention, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py `_flash_fwd_kernel`
// (launched by `_flash_fwd`, public `flash_attention_blhd`), at dropout
// rate 0, without per-sequence kv_lens or segment ids.
//
// Queries q [B, Lq, H, D] against keys and values k, v [B, Lk, Hkv, D] (H a
// multiple of Hkv): the context out [B, Lq, H, D] and lse [B, H, Lq] fp32,
// causal (the diagonal aligned bottom-right, Lk - Lq) or bidirectional. The
// kernel is flash_attention.cuh's forward reading the rows by stride (no
// transpose to the Pallas [B*H, L, D] layout); that header gives the math,
// the rounding points and the design. K/V tiles are read once per q head of
// a group (from L2 after the first).
//
// Bound on the H100: operations = 4*D*B*H*(attended pairs), bytes = q, k, v
// read once and out, lse written once. At LLaMA-7B's training shape (B=4,
// L=2048, H=32, D=128, causal, bf16) that is 137 GFLOP (0.139 ms at 989
// TFLOP/s) against 270 MB (0.080 ms at 3.35 TB/s): operations bound it.

#include "flash_attention.cuh"

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success). The caller has checked shapes, types, contiguity and
// alignment: q and out are [B, Lq, H, D], k and v [B, Lk, Hkv, D], all of
// the input type and contiguous; lse is [B, H, Lq] fp32.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B,
                                   int Lq, int Lk, int H, int Hkv, int D,
                                   int is_bf16, int causal, float sm_scale,
                                   void* stream) {
  const long q_row = (long)H * D;
  FwdArgs a{q, k, v, out, static_cast<float*>(lse), q_row, (long)Hkv * D,
            q_row, Lq, Lk, H, Hkv, sm_scale, causal};
  return flash_fwd(a, B, D, is_bf16, static_cast<cudaStream_t>(stream));
}
