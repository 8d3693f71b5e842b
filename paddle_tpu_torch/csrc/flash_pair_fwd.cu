// Flash-attention forward over GPT's packed qkv layout, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_pair.py `_pair_fwd_kernel`
// (launched by `_pair_fwd`), with its in-kernel dropout on the attention
// probabilities (Philox, philox.cuh; rate 0 launches the kernel without it).
// It is also the port's `_flash_fwd_packed` (flash_attention.py:701, public
// `flash_attention_qkv_packed`, heads of 128): the same function on the
// same layout.
//
// For qkv [B, L, 3*H*D] with column order [q heads | k heads | v heads]:
// out [B, L, H*D] (the packed context) and lse [B, H, L] fp32, causal or
// bidirectional, at head sizes 64, 128, 256 and the multiples of 128
// above 256. The kernel is flash_attention.cuh's forward reading q, k and
// v straight out of the packed rows (row stride 3*H*D, k at column H*D, v
// at 2*H*D; no relayout, no padding copy), one KV head per q head: in bf16
// the Hopper kernels (up to 256 flash_fwd_sm90.cuh's, above 256
// flash_wide_sm90.cuh's, round(q * scale) in the workspace `work`), whose
// TMA descriptors see q, k and v as three 3-D tensors (H*D columns, L
// rows, B) over the same rows; in fp32 the FFMA kernels (above 256
// flash_f32_wide.cuh's, O in shared memory). Those headers give the
// math, the rounding points and the design.
//
// Bound on the H100: at the GPT-medium shape (B=2, L=1024, H=8, D=128,
// causal, bf16) the work is 2*B*H*D*L*(L+1) ~= 4.3 GFLOP (4.4 us at 989
// TFLOP/s) against 16.8 MB of traffic (qkv read once, out and lse written
// once: 5.0 us at 3.35 TB/s); the two bounds are close, and at longer L
// the operations dominate. At BERT's shape (B=64, L=512, H=12, D=64,
// bidirectional) 51.5 GFLOP (52 us) against 201 MB (60 us): bytes bound.
// Dropout adds one Philox4x32-10 call per 4 attended pairs, integer work
// that neither bound counts.

#include "flash_attention.cuh"

// C entry point, bound with ctypes. Returns the cudaError_t of the launch
// (0 on success). The caller has checked shapes, types, contiguity and
// alignment; `out` is [B, L, H*D] of the input type and `lse` is [B, H, L]
// fp32; `work` in bf16 at D > 256 kernels/flash_pair.py fwd_work_floats
// floats (the scaled copy of q), else unread and may be null. With `dropout` set, the probabilities drop under
// the seed's words, the keep threshold and the scale of kernels/philox.py.
extern "C" int flash_pair_fwd(const void* qkv, void* out, void* lse,
                              void* work, int B, int L, int H, int D,
                              int is_bf16, int causal,
                              float sm_scale, int dropout, unsigned seed_lo,
                              unsigned seed_hi, unsigned threshold,
                              float keep_scale, void* stream) {
  const long hd = (long)H * D;
  const size_t esize = is_bf16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  FwdArgs a{qkv, base + hd * esize, base + 2 * hd * esize, out,
            static_cast<float*>(lse), 3 * hd, 3 * hd, hd, L, L, H, H,
            sm_scale, causal, {seed_lo, seed_hi, threshold, keep_scale}};
  float* w = static_cast<float*>(work);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PairHeadDims dims{};
  return dropout ? flash_fwd<true, false>(dims, a, w, B, D, is_bf16, st)
                 : flash_fwd<false, false>(dims, a, w, B, D, is_bf16, st);
}
