// Flash-attention forward over GPT's packed qkv layout, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_pair.py `_pair_fwd_kernel`
// (launched by `_pair_fwd`), at dropout rate 0.
//
// For qkv [B, L, 3*H*D] with column order [q heads | k heads | v heads]:
// out [B, L, H*D] (the packed context) and lse [B, H, L] fp32, causal or
// bidirectional. The kernel is flash_attention.cuh's forward reading q, k
// and v straight out of the packed rows (row stride 3*H*D, k at column
// H*D, v at 2*H*D; no relayout, no padding copy), one KV head per q head;
// that header gives the math, the rounding points and the design.
//
// Bound on the H100: at the GPT-medium shape (B=2, L=1024, H=8, D=128,
// causal, bf16) the work is 2*B*H*D*L*(L+1) ~= 4.3 GFLOP (4.4 us at 989
// TFLOP/s) against 16.8 MB of traffic (qkv read once, out and lse written
// once: 5.0 us at 3.35 TB/s); the two bounds are close, and at longer L
// the operations dominate.

#include "flash_attention.cuh"

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success). The caller has checked shapes, types, contiguity and
// alignment; `out` is [B, L, H*D] of the input type and `lse` is [B, H, L]
// fp32.
extern "C" int flash_pair_fwd(const void* qkv, void* out, void* lse, int B,
                              int L, int H, int D, int is_bf16, int causal,
                              float sm_scale, void* stream) {
  const long hd = (long)H * D;
  const size_t esize = is_bf16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  FwdArgs a{qkv, base + hd * esize, base + 2 * hd * esize, out,
            static_cast<float*>(lse), 3 * hd, 3 * hd, hd, L, L, H, H,
            sm_scale, causal};
  return flash_fwd(a, B, D, is_bf16, static_cast<cudaStream_t>(stream));
}
