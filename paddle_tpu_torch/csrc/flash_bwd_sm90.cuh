// The bf16 flash-attention backward for Hopper (sm_90a): TMA-fed, wgmma on
// the tensor cores, dK and dV in registers for the whole walk, dq added to
// its fp32 scratch by bulk reductions. Included by flash_attention.cuh,
// whose backward contract it computes (the math, the rounding points, the
// masks and the dropout keying are set out there); flash_bwd dispatches
// every bf16 backward at head sizes 64, 80, 96 and 128 here, from both
// launchers (flash_attention_bwd.cu, the [B, L, H, D] layout with GQA,
// lengths and segment ids; flash_pair_bwd.cu, packed qkv, at 64 and 128).
// Heads of 256 run the wide body of flash_wide_sm90.cuh (dK/dV of a whole
// head do not fit in registers beside this walk's S and dP there).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py
// `_flash_bwd_fused_kernel`, `_flash_dq_kernel` + `_flash_dkv_kernel` and
// `_flash_bwd_packed`, and flash_pair.py `_pair_bwd_fused_kernel` and its
// split form (one function on two layouts), in bf16; it takes the place of
// the port's WMMA backward at those head sizes.
//
// What bounds it: the five products, 10*D operations an attended pair, so
// the tensor cores' rate at the models' shapes (bytes bound only BERT's
// short padded rows). The design, FlashAttention-3's backward fitted to
// what the forward measured (flash_fwd_sm90.cuh):
//
// * One CTA of two consumer warpgroups per (128-row kv tile, KV head,
//   batch row); each warpgroup owns 64 kv rows and keeps their dK and dV
//   in fp32 registers (D/2 + D/2 a thread) over every q head of the GQA
//   group and every 64-row q tile from the causal diagonal down, so the
//   group sum needs no scratch. No producer warp (a ninth warp caps every
//   thread at 168 registers): warp 0 issues the TMA loads, lane 0
//   predicated inside the PTX. The grid's slowest dimension is the kv
//   tile, so the longest causal walks (kv tile 0) launch first.
// * Tiles live in shared memory in TMA's swizzled layout, cut into column
//   blocks of W = 64 bf16 (128-byte swizzle) where D is a multiple of 64,
//   else of 16 (32-byte swizzle: five blocks at D = 80, six at 96), as the
//   forward's; every product's descriptors carry the blocks' swizzle
//   (S^T and dP^T take one block a k-step, dV, dK and dQ read dO, Q and K
//   MN-major with the blocks' distance as the leading offset).
// * Loads: K and V once by TMA (3-D boxes: columns, L, batch row, so rows
//   past L read as zero within each batch row); Q, dO and the q tile's lse
//   and delta through a ring of two stages with full and empty mbarriers,
//   so the next q tile's copy runs under this tile's products. lse and
//   delta come from a pre-pass that writes them at rows padded to 64
//   (flash_attention.cuh `bwd_prepass_kernel`), one bulk copy each.
// * Orientation: S^T = K Q^T and dP^T = V dO^T (kv rows as M, wgmma
//   m64n64k16 from shared memory, both operands K-major), so P^T and dS^T
//   land in the accumulator layout that is the A fragment of a
//   register-sourced wgmma: dV += P^T dO and dK += dS^T Q read dO and Q
//   MN-major from their [q, D] tiles, nothing transposed, nothing staged.
//   dQ = dS K needs every kv row of the tile: dS^T goes to a 128-byte
//   swizzled bf16 tile [128 kv][64 q], and dQ reads it and K both
//   MN-major (transposed operands). At D = 128 each warpgroup computes one
//   64-column half of dQ over all 128 kv rows; at D = 64, 80 and 96 each
//   sums its own 64 kv rows over all D columns (m64nDk16; two reductions of
//   each dq element a tile).
//   No product stages through fp32 shared memory.
// * The two copies of q: dK takes the unscaled q (the TMA tile), S the
//   scaled and rounded round(q * scale): the consumers write the next q
//   tile's copy into its stage beside Q (elementwise, so the swizzle is
//   kept) while the tensor cores run this tile's dV and dK, then fence the
//   generic proxy against the async one. One CTA barrier a step, before
//   dQ, orders both the copy and dS^T for the other warpgroup; at D = 128
//   a "dS^T free" mbarrier (every thread arrives once its dQ is done)
//   keeps the next step's dS^T stores behind the other warpgroup's dQ
//   reads, with the slack of an arrive/wait pair. (Per-warpgroup copies
//   and dQ over each warpgroup's own rows, with no CTA barrier at all,
//   measured 13% slower at D = 128 and 3% faster at D = 64: not kept.)
// * p = exp(s - lse) as exp2((s - lse) * log2(e)) in fp32, masked pairs 0
//   by a select on a 32-bit mask of the thread's attended pairs, computed
//   before the products are issued, only where the tile crosses the causal
//   diagonal, a length or Lq, and on every tile with segment ids (a
//   warp-uniform flag); ds = round(p * (dp * keep - delta)), P for dV =
//   round(p * keep).
// * Dropout keeps one Philox call per four pairs: a group's four keys sit
//   in four lanes (one kv row each) that share their q columns, so each of
//   the four draws the words of a quarter of the group's q columns and the
//   four transpose them with three xor-shuffles; the keep bits of the
//   thread's 32 pairs become one 32-bit mask, drawn while the tensor cores
//   run S and dP at D = 64, and before they are issued at D >= 80 (where
//   the Philox state and the two accumulators do not fit in registers
//   together).
// * dq: each warpgroup stages its fp32 dQ tile in shared memory (rows
//   padded by 32 bytes: no bank conflicts) and adds it to the fp32 scratch
//   with one cp.reduce.async.bulk .add.f32 a q row (256 bytes; 4 * D at D
//   = 64, 80, 96), issued by 64 threads; sm_scale is applied once, in the conversion
//   launch behind the kernel. The reductions' order changes from run to
//   run (compare dq with a tolerance).
// * Every branch beside a live accumulator is warp-uniform (trip counts
//   and flags broadcast with __shfl_sync, waits and lane-0 work inside the
//   PTX): ptxas serialises every wgmma of a kernel otherwise (note C7520;
//   the build fails on it). The mask bits are computed under such a branch
//   only on the tiles that need them.
// * Epilogue: dK * sm_scale and dV rounded to bf16 from registers, rows
//   past Lk skipped. A CTA whose kv tile starts at or past the batch row's
//   length writes zero dK, dV and exits before any load.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "wgmma.cuh"

namespace {
namespace sm90 {

constexpr int kBwdRowsQ = 64;    // q rows a step
constexpr int kBwdRowsWG = 64;   // kv rows a consumer owns
constexpr int kBwdRowsKV = kConsumers * kBwdRowsWG;

// The head sizes this body runs (bf16).
__host__ __device__ constexpr bool bwd_sm90_takes(int D) {
  return D == 64 || D == 80 || D == 96 || D == 128;
}

template <int D>
struct BwdGeom {
  // columns of one swizzle block: 64 (128-byte swizzle) where D allows,
  // else 16 (32-byte swizzle: five blocks at D = 80, six at 96), as the
  // forward's Geom
  static constexpr int W = D % 64 == 0 ? 64 : 16;
  static constexpr int kBlocks = D / W;
  static constexpr int kRowBytes = W * 2;
  static constexpr int kLayout = swizzle_code(kRowBytes);
  static constexpr int kQBlock = kBwdRowsQ * kRowBytes;  // one column block
  static constexpr int kQTile = kBwdRowsQ * D * 2;
  static constexpr int kKVBlock = kBwdRowsKV * kRowBytes;
  static constexpr int kKVTile = kBwdRowsKV * D * 2;
  // dQ: whole 64-column blocks to each consumer (D = 128), else each sums
  // its own kv rows over every column (D = 64)
  static constexpr bool kSplitN = D >= 128;
  static constexpr int kDqCols = kSplitN ? D / kConsumers : D;
  static constexpr int kDqLd = kDqCols * 4 + 32;  // staged dQ row, bytes
  // 16-byte chunks of one q tile: whole passes of the CTA's threads, and
  // the warps that take the last, partial one (D = 80)
  static constexpr int kQChunks = kQTile / 16;
  static constexpr int kQPasses = kQChunks / kThreadsCTA;
  static constexpr int kQTailWarps = kQChunks % kThreadsCTA / 32;
  static constexpr int kStages = 2;
  // a stage: Q, dO, the scaled copy of Q, lse[64], delta[64]
  static constexpr int kStQ = 0;
  static constexpr int kStDO = kQTile;
  static constexpr int kStQS = 2 * kQTile;
  static constexpr int kStLse = 3 * kQTile;
  static constexpr int kStDelta = kStLse + kBwdRowsQ * 4;
  static constexpr int kStage = (kStDelta + kBwdRowsQ * 4 + 1023) / 1024 * 1024;
  static constexpr int kK = 0;
  static constexpr int kV = kKVTile;
  static constexpr int kSt = 2 * kKVTile;
  static constexpr int kDS = kSt + kStages * kStage;     // dS^T [128][64] bf16
  static constexpr int kDSLayout = swizzle_code(128);  // dS^T's, at every D
  static constexpr int kDQ = kDS + kBwdRowsKV * kBwdRowsQ * 2;
  static constexpr int kBars = kDQ + kConsumers * kBwdRowsQ * kDqLd;
  // kv full, full and empty per stage, then "dS^T free" (D = 128)
  static constexpr int kBytes = kBars + 8 * (2 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align to 1024
  static constexpr int kStepBytes = 2 * kQTile + 2 * kBwdRowsQ * 4;
  __device__ static uint32_t full(uint32_t base, int s) {
    return base + kBars + 8 * (1 + s);
  }
  __device__ static uint32_t empty(uint32_t base, int s) {
    return base + kBars + 8 * (1 + kStages + s);
  }
  __device__ static uint32_t ds_free(uint32_t base) {
    return base + kBars + 8 * (1 + 2 * kStages);
  }
  static_assert(kAlloc <= 232448, "backward tiles exceed shared memory");
  static_assert(kDqCols == 64 || !kSplitN, "64-column dQ halves");
  static_assert(kQChunks % 32 == 0, "whole warps in the scaled copy");
  static_assert(kQBlock % 256 == 0 && kKVBlock % 256 == 0,
                "swizzle alignment of the column blocks");
};

template <int D, bool kDrop, bool kSegs>
__global__ void __launch_bounds__(kThreadsCTA, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const BwdArgs a) {
  using G = BwdGeom<D>;
  using bf16 = __nv_bfloat16;
  // the keep bits before the products are issued (D >= 80: registers)
  constexpr bool kEarlyKeep = D >= 80;
  constexpr int kSlotUnroll = kEarlyKeep ? 1 : 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.z * kBwdRowsKV;  // kv tile 0 walks the most
  const Mask<kSegs> mask = mask_of<kSegs>(a, b);
  const long dkv_base = ((long)b * a.Lk) * a.dkv_row + (long)hk * D;
  bf16* dk_out = static_cast<bf16*>(a.dk) + dkv_base;
  bf16* dv_out = static_cast<bf16*>(a.dv) + dkv_base;

  // warp-uniform, as a broadcast shows the compiler
  if (n0 >= __shfl_sync(0xffffffffu, mask.len, 0)) {
    // every key of this tile is past the length: no query sees it, so its
    // dk and dv are zero, and it adds nothing to dq
    const int rows = min(kBwdRowsKV, a.Lk - n0);
    for (int i = threadIdx.x; i < rows * D; i += kThreadsCTA) {
      const long at = (long)(n0 + i / D) * a.dkv_row + i % D;
      dk_out[at] = __float2bfloat16(0.0f);
      dv_out[at] = __float2bfloat16(0.0f);
    }
    return;
  }

  const int group = a.H / a.Hkv;
  // causal: the first q row that sees key n0 is n0 - offset; the walk
  // starts at the q tile holding it
  const int first = a.causal ? max(0, n0 - mask.offset) : 0;
  const int n_qt = (a.Lq + kBwdRowsQ - 1) / kBwdRowsQ;
  const int mt0 = min(first / kBwdRowsQ, n_qt - 1);
  const int n_mt = n_qt - mt0;
  const int n_steps = group * n_mt;
  const uint32_t bar_kv = base + G::kBars;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(G::full(base, s), 1);
      mbar_init(G::empty(base, s), kThreadsCTA);
    }
    mbar_init(G::ds_free(base), kThreadsCTA);
    mbar_init_fence();
  }
  __syncthreads();

  // Loads step st's Q and dO tiles, lse and delta into stage st % 2 once
  // both consumers have released the step that held it. A whole warp runs
  // it (lane 0 issues, by predicate).
  auto load_step = [&](int st) {
    const int s = st % G::kStages;
    const int issue = threadIdx.x % 32 == 0;
    if (st >= G::kStages)
      mbar_wait(G::empty(base, s), (uint32_t)(st / G::kStages - 1) & 1u);
    const int h = hk * group + st / n_mt;
    const int m0 = (mt0 + st % n_mt) * kBwdRowsQ;
    const uint32_t full = G::full(base, s);
    const uint32_t stage = base + G::kSt + s * G::kStage;
    mbar_arrive_expect_tx(full, G::kStepBytes, issue);
#pragma unroll
    for (int c = 0; c < G::kBlocks; ++c) {
      tma_load_3d(stage + G::kStQ + c * G::kQBlock, &tq, full,
                  h * D + c * G::W, m0, b, issue);
      tma_load_3d(stage + G::kStDO + c * G::kQBlock, &tdo, full,
                  h * D + c * G::W, m0, b, issue);
    }
    const long row = ((long)b * a.H + h) * a.Lq_pad + m0;
    bulk_load(stage + G::kStLse, a.lse_pad + row, kBwdRowsQ * 4, full, issue);
    bulk_load(stage + G::kStDelta, a.delta + row, kBwdRowsQ * 4, full, issue);
  };

  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar_kv, 2 * G::kKVTile);
    for (int c = 0; c < G::kBlocks; ++c) {
      tma_load_3d(base + G::kK + c * G::kKVBlock, &tk, bar_kv,
                  hk * D + c * G::W, n0, b);
      tma_load_3d(base + G::kV + c * G::kKVBlock, &tv, bar_kv,
                  hk * D + c * G::W, n0, b);
    }
    for (int st = 0; st < min(n_steps, G::kStages); ++st) load_step(st);
  }

  // warp-uniform values the compiler can see as such
  const int n_iter = __shfl_sync(0xffffffffu, n_steps, 0);
  const int warp_u = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const bool warp0 = warp_u == 0;
  const int g = threadIdx.x / 128;  // consumer index
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int c4 = lane % 4;
  const int row_a = warp * 16 + lane / 4;  // and row_a + 8 (kv rows)
  const int kv_wg = n0 + g * kBwdRowsWG;   // this consumer's first kv row
  const int kv0 = kv_wg + row_a;
  const int kv1 = kv0 + 8;
  int kseg0 = 0, kseg1 = 0;
  if constexpr (kSegs) {
    kseg0 = mask.ks[max(0, min(kv0, mask.len - 1))];
    kseg1 = mask.ks[max(0, min(kv1, mask.len - 1))];
  }
  // Mask's decisions without a branch (every operand evaluated)
  auto visible = [&](int qr, int kc, int kseg) {
    bool ok = (qr < a.Lq) & (kc < mask.len) &
              (!a.causal | (kc <= qr + mask.offset));
    if constexpr (kSegs) ok &= mask.qs[min(qr, a.Lq - 1)] == kseg;
    return ok;
  };
  // Philox: the four lanes of one key group are r = (lane / 4) % 4 of a
  // quad column c4; the lanes 0-15 hold the groups of kv rows warp * 16 +
  // 0..3 (row_a) and + 8..11 (row_a + 8), lanes 16-31 those of + 4..7 and
  // + 12..15
  const int kr = (lane / 4) % 4;
  const uint32_t grp0 = (uint32_t)(kv_wg + warp * 16 + 4 * (lane / 16)) / 4;
  // The keep bits of the thread's 32 pairs of q tile m0 (bit i for st[i]):
  // slot sl draws group j = sl / 4 for q column i = 4 * (sl % 4) + kr, then
  // the four lanes transpose the words.
  // (At D >= 80 the slots run one after another: unrolled, their Philox
  // states meet dK and dV in registers and spill.)
  auto keep_bits = [&](int m0, uint32_t bh) {
    uint32_t keep = 0u;
#pragma unroll(kSlotUnroll)
    for (int sl = 0; sl < 8; ++sl) {
      const int j = sl / 4;
      const int i = 4 * (sl % 4) + kr;
      const uint32_t qr = (uint32_t)(m0 + 8 * (i / 2) + 2 * c4 + (i & 1));
      const uint4 w =
          keep_words(a.drop, grp0 + 2 * j, qr, bh, kSaltAttention);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = kr ^ k;  // the lane whose key this word serves
        uint32_t word = word_of(w, p);
        if (k) word = __shfl_xor_sync(0xffffffffu, word, 4 * k);
        const int ip = 4 * (sl % 4) + p;  // its q column index
        keep |= (uint32_t)kept(a.drop, word)
                << (4 * (ip / 2) + 2 * j + (ip & 1));
      }
    }
    return keep;
  };

  const uint32_t k_base = base + G::kK + g * kBwdRowsWG * G::kRowBytes;
  const uint32_t v_base = base + G::kV + g * kBwdRowsWG * G::kRowBytes;
  const uint32_t ds_base = base + G::kDS;
  unsigned char* ds_ptr = gbase + G::kDS;
  unsigned char* dq_stage = gbase + G::kDQ + g * kBwdRowsQ * G::kDqLd;
  const uint32_t dq_stage_u32 = base + G::kDQ + g * kBwdRowsQ * G::kDqLd;

  // Waits for step st's stage and writes its scaled copy round(q * scale)
  // beside Q (elementwise at the same offsets, so the swizzle is kept);
  // every thread of the CTA takes a share (at D = 80 the first warps a
  // last, partial pass: a warp-uniform test).
  auto scale_q = [&](int st) {
    const int s = st % G::kStages;
    mbar_wait(G::full(base, s), (uint32_t)(st / G::kStages) & 1u);
    unsigned char* stage_ptr = gbase + G::kSt + s * G::kStage;
    const uint4* src = reinterpret_cast<const uint4*>(stage_ptr + G::kStQ);
    uint4* dst = reinterpret_cast<uint4*>(stage_ptr + G::kStQS);
#pragma unroll
    for (int it = 0; it < G::kQPasses + (G::kQTailWarps > 0); ++it) {
      if (it < G::kQPasses || warp_u < G::kQTailWarps) {
        const int i = it * kThreadsCTA + threadIdx.x;
        uint4 v = src[i];
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          e[k] = __float2bfloat16(__bfloat162float(e[k]) * a.sm_scale);
        dst[i] = v;
      }
    }
  };

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }
  mbar_wait(bar_kv, 0);
  scale_q(0);
  fence_proxy_async();
  named_barrier(1, kThreadsCTA);

  for (int step = 0; step < n_iter; ++step) {
    const int s = step % G::kStages;
    const int gq = step / n_mt;
    const int m0 = (mt0 + step % n_mt) * kBwdRowsQ;
    const int h = hk * group + gq;
    const uint32_t bh = (uint32_t)(b * a.H + h);
    const uint32_t stage = base + G::kSt + s * G::kStage;
    unsigned char* stage_ptr = gbase + G::kSt + s * G::kStage;
    // the stage arrived (scale_q waited for it) and holds its scaled copy
    mbar_wait(G::full(base, s), (uint32_t)(step / G::kStages) & 1u);

    // which of the 32 pairs are attended (bit i for st[i]), decided before
    // the products are issued; evaluated only where the tile crosses the
    // causal diagonal, a length or Lq, or has segment ids (warp-uniform)
    const int kvb = __shfl_sync(0xffffffffu, kv_wg, 0);
    const bool need_mask = __shfl_sync(
        0xffffffffu,
        (int)(kSegs || m0 + kBwdRowsQ > a.Lq || kvb + kBwdRowsWG > mask.len ||
              (a.causal && kvb + kBwdRowsWG - 1 > m0 + mask.offset)),
        0);
    uint32_t vis = ~0u;
    if (need_mask) {  // warp-uniform
      vis = 0u;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qr = m0 + 8 * (i / 4) + 2 * c4 + (i & 1);
        vis |= (uint32_t)visible(qr, (i & 2) ? kv1 : kv0,
                                 (i & 2) ? kseg1 : kseg0)
               << i;
      }
    }
    uint32_t keep_early = 0u;
    if constexpr (kDrop && kEarlyKeep) keep_early = keep_bits(m0, bh);

    // S^T = K Qs^T and dP^T = V dO^T for this consumer's 64 kv rows
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int blk = kk * 16 / G::W;
      const int off = (kk * 16 % G::W) * 2;
      const uint64_t da = wgmma_desc(k_base + blk * G::kKVBlock + off, 16,
                                     8 * G::kRowBytes, G::kLayout);
      const uint64_t db =
          wgmma_desc(stage + G::kStQS + blk * G::kQBlock + off, 16,
                     8 * G::kRowBytes, G::kLayout);
      wgmma_ss<64>(st, da, db, kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int blk = kk * 16 / G::W;
      const int off = (kk * 16 % G::W) * 2;
      const uint64_t da = wgmma_desc(v_base + blk * G::kKVBlock + off, 16,
                                     8 * G::kRowBytes, G::kLayout);
      const uint64_t db =
          wgmma_desc(stage + G::kStDO + blk * G::kQBlock + off, 16,
                     8 * G::kRowBytes, G::kLayout);
      wgmma_ss<64>(dpt, da, db, kk > 0);
    }
    wgmma_commit();

    // st[4 * jn + e]: kv row row_a (e < 2) or row_a + 8, q column
    // 8 * jn + 2 * c4 + (e & 1)
    // at D = 64 the keep bits are drawn while the tensor cores run S^T
    // and dP^T; at D = 128 before they are issued, where their registers
    // do not meet those of the two accumulators
    uint32_t keep = 0u;
    if constexpr (kDrop && !kEarlyKeep) keep = keep_bits(m0, bh);

    const float* lse_s =
        reinterpret_cast<const float*>(stage_ptr + G::kStLse);
    const float* delta_s =
        reinterpret_cast<const float*>(stage_ptr + G::kStDelta);

    wgmma_wait<1>();  // S^T is done; dP^T runs on
    fence_regs(st);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * jn +
                                                        2 * c4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            fast_exp2((st[4 * jn + e] - ((e & 1) ? l.y : l.x)) * kLog2e);
        st[4 * jn + e] = ((vis >> (4 * jn + e)) & 1u) ? p : 0.0f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    if constexpr (kDrop && kEarlyKeep) keep = keep_early;

    // at D = 128 the other consumer's dQ of the previous step reads this
    // consumer's dS^T rows: wait until both have finished it
    if constexpr (G::kSplitN)
      if (step > 0) mbar_wait(G::ds_free(base), (uint32_t)(step - 1) & 1u);

    // P^T (times the keep factor) and dS^T as bf16 A fragments
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + 8 * jn +
                                                         2 * c4);
      float pv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jn + e;
        float f = 1.0f;
        if constexpr (kDrop) f = ((keep >> i) & 1u) ? a.drop.scale : 0.0f;
        pv[e] = st[i] * f;
        dsv[e] = st[i] * (dpt[i] * f - ((e & 1) ? dl.y : dl.x));
      }
      // jn = 2 ks + hi: fragment registers 2 hi (row_a) and 2 hi + 1
      const int ks = jn / 2, hi = jn % 2;
      __nv_bfloat162 v = __floats2bfloat162_rn(pv[0], pv[1]);
      pa[ks][2 * hi] = *reinterpret_cast<const uint32_t*>(&v);
      v = __floats2bfloat162_rn(pv[2], pv[3]);
      pa[ks][2 * hi + 1] = *reinterpret_cast<const uint32_t*>(&v);
      v = __floats2bfloat162_rn(dsv[0], dsv[1]);
      dsa[ks][2 * hi] = *reinterpret_cast<const uint32_t*>(&v);
      v = __floats2bfloat162_rn(dsv[2], dsv[3]);
      dsa[ks][2 * hi + 1] = *reinterpret_cast<const uint32_t*>(&v);
      // dS^T into its swizzled tile: row r, 16-byte chunk jn ^ (r % 8)
      const int r0 = g * kBwdRowsWG + row_a;
      *reinterpret_cast<uint32_t*>(ds_ptr + r0 * 128 +
                                   ((jn ^ (r0 & 7)) * 16) + c4 * 4) =
          dsa[ks][2 * hi];
      *reinterpret_cast<uint32_t*>(ds_ptr + (r0 + 8) * 128 +
                                   ((jn ^ (r0 & 7)) * 16) + c4 * 4) =
          dsa[ks][2 * hi + 1];
    }

    // dV += P^T dO and dK += dS^T Q (q unscaled), dO and Q MN-major
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t db =
          wgmma_desc(stage + G::kStDO + ks * 16 * G::kRowBytes, G::kQBlock,
                     8 * G::kRowBytes, G::kLayout);
      wgmma_rs<D>(dv, pa[ks], db, 1);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t db =
          wgmma_desc(stage + G::kStQ + ks * 16 * G::kRowBytes, G::kQBlock,
                     8 * G::kRowBytes, G::kLayout);
      wgmma_rs<D>(dk, dsa[ks], db, 1);
    }
    wgmma_commit();

    // the next step's scaled copy while dV and dK run, then dQ = dS K
    // (dS^T and K both MN-major) once both consumers' dS^T and copies are
    // in shared memory
    if (step + 1 < n_iter) scale_q(step + 1);  // warp-uniform
    fence_proxy_async();
    named_barrier(1, kThreadsCTA);
    float dq[G::kDqCols / 2];
    wgmma_fence();
    if constexpr (G::kSplitN) {
#pragma unroll
      for (int ks = 0; ks < kBwdRowsKV / 16; ++ks) {
        const uint64_t da = wgmma_desc(ds_base + ks * 16 * 128, 128 * 128,
                                       8 * 128, G::kDSLayout);
        const uint64_t db = wgmma_desc(
            base + G::kK + g * G::kKVBlock + ks * 16 * G::kRowBytes,
            G::kKVBlock, 8 * G::kRowBytes, G::kLayout);
        wgmma_ss_tt<64>(dq, da, db, ks > 0);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kBwdRowsWG / 16; ++ks) {
        const int r = g * kBwdRowsWG + ks * 16;
        const uint64_t da = wgmma_desc(ds_base + r * 128, 128 * 128, 8 * 128,
                                       G::kDSLayout);
        const uint64_t db = wgmma_desc(base + G::kK + r * G::kRowBytes,
                                       G::kKVBlock, 8 * G::kRowBytes,
                                       G::kLayout);
        wgmma_ss_tt<G::kDqCols>(dq, da, db, ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);
    if constexpr (G::kSplitN) mbar_arrive(G::ds_free(base));

    // release the stage; warp 0 refills it with step + 2
    mbar_arrive(G::empty(base, s));
    if (warp0 && step + G::kStages < n_iter) load_step(step + G::kStages);

    // dQ: stage (this consumer's previous reduction has read its rows),
    // then one bulk fp32 reduction a q row
    bulk_wait_read();
    named_barrier(2 + g, 128);
#pragma unroll
    for (int jn = 0; jn < G::kDqCols / 8; ++jn) {
      const int col = 8 * jn + 2 * c4;
      *reinterpret_cast<float2*>(dq_stage + row_a * G::kDqLd + col * 4) =
          make_float2(dq[4 * jn], dq[4 * jn + 1]);
      *reinterpret_cast<float2*>(dq_stage + (row_a + 8) * G::kDqLd +
                                 col * 4) =
          make_float2(dq[4 * jn + 2], dq[4 * jn + 3]);
    }
    fence_proxy_async();
    named_barrier(2 + g, 128);
    {
      const int r = min(t, kBwdRowsQ - 1);
      const long at = ((long)b * a.Lq + m0 + r) * ((long)a.H * D) +
                      (long)h * D + (G::kSplitN ? g * G::kDqCols : 0);
      bulk_reduce_add_f32(a.dq_acc + at, dq_stage_u32 + r * G::kDqLd,
                          G::kDqCols * 4,
                          (t < kBwdRowsQ) & (m0 + t < a.Lq));
      bulk_commit();
    }
  }
  bulk_wait_all();

  // dK (scaled once here) and dV, the group's fp32 sums, rounded once
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) {
    const int col = 8 * jn + 2 * c4;
    if (kv0 < a.Lk) {
      const long at = (long)kv0 * a.dkv_row + col;
      *reinterpret_cast<__nv_bfloat162*>(dk_out + at) = __floats2bfloat162_rn(
          dk[4 * jn] * a.sm_scale, dk[4 * jn + 1] * a.sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
          __floats2bfloat162_rn(dv[4 * jn], dv[4 * jn + 1]);
    }
    if (kv1 < a.Lk) {
      const long at = (long)kv1 * a.dkv_row + col;
      *reinterpret_cast<__nv_bfloat162*>(dk_out + at) = __floats2bfloat162_rn(
          dk[4 * jn + 2] * a.sm_scale, dk[4 * jn + 3] * a.sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
          __floats2bfloat162_rn(dv[4 * jn + 2], dv[4 * jn + 3]);
    }
  }
}

template <int D, bool kDrop, bool kSegs>
cudaError_t launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  using G = BwdGeom<D>;
  CUtensorMap tq, tk, tv, tdo;
  const long hd = (long)a.H * D;
  if (!make_map(&tq, a.q, hd, a.q_row, a.Lq, B, G::W, kBwdRowsQ) ||
      !make_map(&tk, a.k, (long)a.Hkv * D, a.kv_row, a.Lk, B, G::W,
                kBwdRowsKV) ||
      !make_map(&tv, a.v, (long)a.Hkv * D, a.kv_row, a.Lk, B, G::W,
                kBwdRowsKV) ||
      !make_map(&tdo, a.dout, hd, hd, a.Lq, B, G::W, kBwdRowsQ))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_sm90_kernel<D, kDrop, kSegs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kAlloc);
  if (err != cudaSuccess) return err;
  dim3 grid(a.Hkv, B, (a.Lk + kBwdRowsKV - 1) / kBwdRowsKV);
  kernel<<<grid, kThreadsCTA, G::kAlloc, stream>>>(tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace
