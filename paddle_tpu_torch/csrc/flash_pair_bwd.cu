// Flash-attention backward over GPT's packed qkv layout, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_pair.py `_pair_bwd_fused_kernel`
// (flash_pair.py:298, launched by `_pair_bwd` when kv_pad fits the TPU's
// VMEM budget) and the split pair `_pair_bwd_dq_kernel` (:363) +
// `_pair_bwd_dkv_kernel` (:398) that take over above that budget. All three
// compute one function; this kernel keeps only tile-sized state, so it has
// no length cutoff and does the job of both forms. Dropout rate 0.
//
// From qkv [B, L, 3*H*D], dO [B, L, H*D], the forward's lse [B, H, L] and
// delta = rowsum(dO * O) [B, H, L] (fp32): d(qkv) [B, L, 3*H*D] in the
// packed layout, dq at columns h*D, dk at (H+h)*D, dv at (2H+h)*D, no
// concatenation copy. The kernel is flash_attention.cuh's backward reading
// the packed rows (row stride 3*H*D) and writing dk/dv and (through the
// fp32 dq scratch) dq into their columns, one q head per KV head; that
// header gives the math, the rounding points and the design.
//
// Bound on the H100: operations = 10*D*B*H*(attended pairs), five products
// of 2*D a pair; bytes = qkv, O, dO and lse read once plus d(qkv) written
// once. At the training shape (B=16, L=1024, H=8, D=128, causal, bf16) that
// is 86.0 GFLOP (0.087 ms at 989 TFLOP/s) against 269 MB (0.080 ms at
// 3.35 TB/s): the two bounds are close, and at longer L the operations
// dominate.

#include "flash_attention.cuh"

// C entry point, bound with ctypes. Returns the cudaError_t of the launches
// (0 on success). The caller has checked shapes, types, contiguity and
// alignment: qkv and dqkv are [B, L, 3*H*D], dout [B, L, H*D] of the input
// type; lse and delta [B, H, L] fp32; dq_acc [B, L, H*D] fp32, zeroed.
extern "C" int flash_pair_bwd(const void* qkv, const void* dout,
                              const void* lse, const void* delta,
                              void* dq_acc, void* dqkv, int B, int L, int H,
                              int D, int is_bf16, int causal, float sm_scale,
                              void* stream) {
  const long hd = (long)H * D;
  const size_t esize = is_bf16 ? 2 : 4;
  const char* in = static_cast<const char*>(qkv);
  char* grad = static_cast<char*>(dqkv);
  BwdArgs a{qkv, in + hd * esize, in + 2 * hd * esize, dout,
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<float*>(dq_acc), dqkv, grad + hd * esize,
            grad + 2 * hd * esize, 3 * hd, 3 * hd, 3 * hd, 3 * hd, L, L, H, H,
            sm_scale, causal};
  return flash_bwd(a, B, D, is_bf16, static_cast<cudaStream_t>(stream));
}
