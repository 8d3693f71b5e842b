// Counter-based Philox4x32-10 (Random123's philox4x32_R, R = 10) for the
// port's dropout kernels: the row dropout (dropout.cu), the fused
// add-dropout-LayerNorm (fused_residual_*.cu) and the flash-attention pair
// kernels (flash_attention.cuh). kernels/philox.py is its plain version and
// gives the same words bit for bit; its docstring sets out the layout:
//   key     = the 63-bit seed as (low word, high word)
//   counter = (column / 4, row word 0, row word 1, op salt)
// and the four output words serve columns 4 * (column / 4) + 0..3. An
// element is kept iff (word & 0x7FFFFFFF) >= threshold, threshold =
// int(rate * 2^31), so the decision depends on the element's coordinates
// and never on a tile or block index: a forward and a backward that walk
// other tiles drop the same elements.

#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t kSaltAttention = 1;  // kernels/philox.py SALT_ATTENTION
constexpr uint32_t kSaltDropout = 2;    // SALT_DROPOUT
constexpr uint32_t kSaltFusedLn = 3;    // SALT_FUSED_LN

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The dropout parameters a launch carries: the seed's two words, the keep
// threshold and the scale of a kept element (1 / (1 - rate) in fp32).
//
// A seed staged in device memory (a captured step's, kernels/philox.py
// DeviceSeed) travels in the same 16 bytes: the threshold's top bit
// (kSeedInMemory; a threshold is below 2^31) says so, and the two words
// then hold the address of the seed's (low, high) words, which the kernel
// reads (``resolved``), so a launch recorded in a CUDA graph draws under
// whatever seed the host staged before each replay. An eager launch passes
// the words by value as before. The parameters keep their layout: a wider
// struct, or an argument block grown past 128 bytes, made ptxas schedule
// the bf16 forward's unrolled draws worse on the H100 (PERF.md).
struct DropParams {
  uint32_t seed_lo, seed_hi, threshold;
  float scale;
};

constexpr uint32_t kSeedInMemory = 0x80000000u;

// (on the host, a launcher picks the instantiation with it)
__host__ __device__ __forceinline__ bool seed_in_memory(const DropParams& d) {
  return (d.threshold & kSeedInMemory) != 0u;
}

// ``d`` with the seed's words in place (read from device memory for a
// staged seed) and the flag cleared. A kernel resolves its parameters once
// and draws from the copy: the bf16 backwards once a tile's keep bits, the
// fp32 and elementwise kernels at their start. The bf16 forwards draw in
// unrolled runs where the words as parameter operands cost no register
// and a resolved copy holds two through the walk: they keep the by-value
// code and launch a second instantiation (kSeedDev) for a staged seed,
// which resolves once a CTA. The flag is a kernel parameter, so the choice
// is uniform over the grid.
__device__ __forceinline__ DropParams resolved(const DropParams& d) {
  DropParams r = d;
  if (seed_in_memory(d)) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(
        ((uint64_t)d.seed_hi << 32) | d.seed_lo);
    r.seed_lo = __ldg(p);
    r.seed_hi = __ldg(p + 1);
    r.threshold = d.threshold & ~kSeedInMemory;
  }
  return r;
}

// Four keep words for columns [4 * group, 4 * group + 4) of a row (``d``
// resolved).
__device__ __forceinline__ uint4 keep_words(const DropParams& d,
                                            uint32_t group, uint32_t row0,
                                            uint32_t row1, uint32_t salt) {
  return philox4x32_10(make_uint4(group, row0, row1, salt), d.seed_lo,
                       d.seed_hi);
}

// Whether the element of `word` is kept.
__device__ __forceinline__ bool kept(const DropParams& d, uint32_t word) {
  return (word & 0x7FFFFFFFu) >= d.threshold;
}

// The factor of one element: scale if its word keeps it, else 0 (for
// finite operands: the attention probabilities).
__device__ __forceinline__ float keep_factor(const DropParams& d,
                                             uint32_t word) {
  return kept(d, word) ? d.scale : 0.0f;
}

// A kept element times the scale, a dropped one 0 (a select, so a dropped
// inf or NaN is 0 as in jnp.where / torch.where).
__device__ __forceinline__ float apply_keep(const DropParams& d,
                                            uint32_t word, float v) {
  return kept(d, word) ? v * d.scale : 0.0f;
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int e) {
  return e == 0 ? w.x : e == 1 ? w.y : e == 2 ? w.z : w.w;
}

}  // namespace
