// Flash-attention backward over GPT's packed qkv layout, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_pair.py `_pair_bwd_fused_kernel`
// (flash_pair.py:298, launched by `_pair_bwd` when kv_pad fits the TPU's
// VMEM budget) and the split pair `_pair_bwd_dq_kernel` (:363) +
// `_pair_bwd_dkv_kernel` (:398) that take over above that budget. All three
// compute one function; this kernel keeps only tile-sized state, so it has
// no length cutoff and does the job of both forms. Dropout regenerates the
// forward's keep mask from the same seed (Philox, philox.cuh; keyed on the
// element, so the forward's q tiles and these kv tiles agree). It is also
// the port's `_flash_bwd_packed` (flash_attention.py:755, heads of 128): the
// same function on the same layout.
//
// From qkv [B, L, 3*H*D], O and dO [B, L, H*D] and the forward's lse [B,
// H, L] (fp32; delta = rowsum(dO * O) comes from the pre-pass launch):
// d(qkv) [B, L, 3*H*D] in the
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
// dominate. At BERT's shape (B=64, L=512, H=12, D=64, bidirectional)
// 129 GFLOP (130 us) against 403 MB (120 us).

// Head sizes 64, 128, 256 and every multiple of 128 above 256 (the pair
// gate's) are built: bf16 at 64 and 128 runs the Hopper body of
// flash_bwd_sm90.cuh, bf16 at 256 and above the wide Hopper body of
// flash_wide_sm90.cuh, fp32 the FFMA kernels of flash_f32_wide.cuh.

#include "flash_attention.cuh"

// C entry point, bound with ctypes. Returns the cudaError_t of the launches
// (0 on success). The caller has checked shapes, types, contiguity and
// alignment: qkv and dqkv are [B, L, 3*H*D], out and dout [B, L, H*D] of
// the input type; lse [B, H, L] fp32, the forward's; work an fp32
// workspace of bwd_work_floats(B, L, H, D, is_bf16) floats. The
// dropout arguments are the forward's.
extern "C" int flash_pair_bwd(const void* qkv, const void* out,
                              const void* dout, const void* lse, void* work,
                              void* dqkv, int B, int L, int H, int D,
                              int is_bf16, int causal, float sm_scale,
                              int dropout, unsigned seed_lo, unsigned seed_hi,
                              unsigned threshold, float keep_scale,
                              void* stream) {
  const long hd = (long)H * D;
  const size_t esize = is_bf16 ? 2 : 4;
  const char* in = static_cast<const char*>(qkv);
  char* grad = static_cast<char*>(dqkv);
  BwdArgs a{qkv, in + hd * esize, in + 2 * hd * esize, out, dout,
            static_cast<const float*>(lse), nullptr, nullptr, nullptr, dqkv,
            grad + hd * esize, grad + 2 * hd * esize, 3 * hd,
            3 * hd, 3 * hd, 3 * hd, L, L, H, H, 0, sm_scale, causal,
            {seed_lo, seed_hi, threshold, keep_scale}};
  float* w = static_cast<float*>(work);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PairHeadDims dims{};
  return dropout ? flash_bwd<true, false>(dims, a, w, B, D, is_bf16, st)
                 : flash_bwd<false, false>(dims, a, w, B, D, is_bf16, st);
}
