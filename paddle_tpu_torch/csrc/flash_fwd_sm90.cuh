// The bf16 flash-attention forward for Hopper (sm_90a): TMA-fed, wgmma on
// the tensor cores, accumulators in registers. Included by
// flash_attention.cuh, whose forward contract it computes (the math, the
// rounding points and the masks are set out there); flash_fwd dispatches
// every bf16 forward with D <= 256 here, from both launchers (flash_attention_fwd.cu, the
// [B, L, H, D] layout; flash_pair_fwd.cu, packed qkv).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py
// `_flash_fwd_kernel` and `_flash_fwd_packed`, and flash_pair.py
// `_pair_fwd_kernel` (one function on two layouts), in bf16; it takes the
// place of the port's first, WMMA forward.
//
// What bounds it: the products, 4*D operations an attended pair against ~2
// bytes a pair of rows read, so the tensor cores' rate at the models'
// shapes; next, the softmax's per-score instructions (a max, a subtract, a
// multiply, an exp2 on the special-function unit, an add), which the walk
// overlaps with the products. The design, FlashAttention-3's consumer side:
//
// * One CTA of two warpgroups per (128-row q tile, q head, batch row),
//   each warpgroup owning 64 q rows, at most 255 registers a thread. A
//   separate producer warp (or warpgroup with setmaxnreg) was measured and
//   dropped: nine or twelve warps put three on one SM sub-partition, which
//   caps every thread at 168 registers (ptxas allocated no more past
//   setmaxnreg), too few for 128-key tiles. Warp 0 issues the TMA loads
//   instead, with lane 0 predicated inside the PTX.
// * Tiles live in shared memory in TMA's swizzled layout, cut into column
//   blocks of W = 64 bf16 (128-byte swizzle) where D is a multiple of 64,
//   else of 16 (32-byte swizzle: five blocks at D = 80, six at 96); wgmma
//   reads them through descriptors of the same swizzle. TMA boxes are 3-D
//   (columns, L, batch row), so rows past L read as zero within each batch
//   row.
// * K and V have rings of two stages each, with a "full" mbarrier (TMA
//   bytes) and an "empty" one (every consumer thread arrives) a stage;
//   once iteration j's wgmmas are done, warp 0 refills K_j's stage with
//   K_{j+2} and V_{j-1}'s with V_{j+1}.
// * The q-scale rounding point: each consumer multiplies its Q tile by
//   sm_scale in place and rounds it back to bf16 (elementwise, so the
//   swizzle does not matter), then fences the generic proxy against the
//   async proxy and syncs its warpgroup before its first wgmma reads Q.
// * S = Q K^T: wgmma m64nNk16 (N = 128 kv rows; 64 at D = 256 and with
//   both dropout and segment ids, so everything fits in 255 registers), Q
//   and K both K-major from shared memory.
// * The online softmax runs in registers on the S fragment (a row over the
//   four lanes of a quad: two shuffles for its max); p = exp2((s - m) *
//   log2(e)). Masked scores become -inf while m stays >= -1e30, so
//   no select guards the exp; the mask is evaluated branch-free, only on
//   tiles that cross the causal diagonal or the length, and on every tile
//   with segment ids.
// * Dropout keeps one Philox call per four pairs: the two lanes that share
//   a four-key group each draw the words of one of their two rows and swap
//   the halves the other needs.
// * O += P V: P becomes bf16 pairs in registers, laid out as the A
//   fragments of a register-sourced wgmma m64nDk16 (the fp32 accumulator
//   layout of S maps onto them); V is read MN-major (transposed B) from its
//   [kv, D] tile, so nothing is transposed. O stays in registers for the
//   whole walk and is rescaled there.
// * The walk overlaps the softmax of tile j with P_{j-1} . V_{j-1} on the
//   tensor cores (intra-warpgroup overlap). The first S and the last P.V
//   are peeled off and every branch beside a live accumulator is
//   warp-uniform, because ptxas serialises every wgmma of a kernel that
//   has a divergent path there (its C7520 note; the build fails on it).
//   Pairing the two warpgroups' products by named barriers ("ping-pong")
//   was measured slower here and dropped.
// * Epilogue: O / max(l, 1e-30) in bf16, staged through the consumer's Q
//   tile (rotated 16-byte chunks, no bank conflicts), stored with 16-byte
//   stores; lse = m + log(max(l, 1e-30)) per row.
// * The q tile is the grid's slowest dimension, heaviest causal walk first.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "wgmma.cuh"

namespace {
namespace sm90 {

constexpr int kConsumers = 2;        // consumer warpgroups, 64 q rows each
constexpr int kRowsWG = 64;          // q rows of one consumer
constexpr int kRowsCTA = kConsumers * kRowsWG;
constexpr int kThreadsCTA = 128 * kConsumers;
constexpr float kLog2e = 1.4426950408889634f;

// kv rows a tile: 128, or 64 where O, S, P and the masks' and dropout's
// registers would not fit in 255 (D = 256; dropout with segment ids)
template <int D, bool kDrop, bool kSegs>
constexpr int kTileFor = D <= 128 && !(kDrop && kSegs) ? 128 : 64;

template <int D, int N>
struct Geom {
  // columns of one swizzle block: 64 (128-byte swizzle) where D allows,
  // else 16 (32-byte swizzle: D = 80 and 96; 96's three 64-byte blocks
  // ran at half the speed of 80's five 32-byte ones)
  static constexpr int W = D % 64 == 0 ? 64 : 16;
  static constexpr int kBlocks = D / W;
  static constexpr int kRowBytes = W * 2;           // 128 or 32
  static constexpr int kLayout = swizzle_code(kRowBytes);
  static constexpr int kTileN = N;
  static constexpr int kStages = 2;
  static constexpr int kQBlock = kRowsWG * kRowBytes;  // one column block
  static constexpr int kQTile = kRowsWG * D * 2;       // one consumer's Q
  static constexpr int kKVBlock = kTileN * kRowBytes;
  static constexpr int kKVTile = kTileN * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kConsumers * kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBars = kV + kStages * kKVTile;
  // the q barrier, then K full, V full, K empty and V empty per stage
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages);
  __device__ static uint32_t full(uint32_t base, int v, int s) {
    return base + kBars + 8 * (1 + v * kStages + s);
  }
  __device__ static uint32_t empty(uint32_t base, int v, int s) {
    return base + kBars + 8 * (1 + (2 + v) * kStages + s);
  }
  // dynamic shared memory asked for: the layout plus room to align its
  // base to the 1024 bytes the 128-byte swizzle repeats over
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kQBlock % 1024 == 0 || W < 64, "swizzle alignment");
};

// Loads tile j of K (v = 0) or V (v = 1) into stage j % kStages once
// both consumers have released the tile that held it. A whole warp runs
// it (every lane waits; lane 0 issues, by predicate), so it puts no
// divergent branch beside the live wgmma accumulators: ptxas serialises
// every wgmma of a kernel that has one.
template <int D, int N>
__device__ __forceinline__ void load_tile_kv(const CUtensorMap* map,
                                             uint32_t base, int v, int j,
                                             int hk, int b) {
  using G = Geom<D, N>;
  const int s = j % G::kStages;
  const int issue = threadIdx.x % 32 == 0;
  if (j >= G::kStages)
    mbar_wait(G::empty(base, v, s), (uint32_t)(j / G::kStages - 1) & 1u);
  const uint32_t full = G::full(base, v, s);
  mbar_arrive_expect_tx(full, G::kKVTile, issue);
  const uint32_t dst = base + (v ? G::kV : G::kK) + s * G::kKVTile;
#pragma unroll
  for (int c = 0; c < G::kBlocks; ++c)
    tma_load_3d(dst + c * G::kKVBlock, map, full, hk * D + c * G::W,
                j * G::kTileN, b, issue);
}

// Releases tile j of K (v = 0) or V (v = 1): every consumer thread
// arrives; warp 0 (`warp0`: a warp-uniform flag) then loads tile j +
// kStages into its stage.
template <int D, int N>
__device__ __forceinline__ void release_kv(const CUtensorMap* map,
                                           uint32_t base, int v, int j,
                                           int n_iter, int hk, int b,
                                           bool warp0) {
  using G = Geom<D, N>;
  mbar_arrive(G::empty(base, v, j % G::kStages));
  if (warp0 && j + G::kStages < n_iter)
    load_tile_kv<D, N>(map, base, v, j + G::kStages, hk, b);
}

// One consumer warpgroup's walk over the kv tiles and its epilogue.
template <int D, int N, bool kDrop, bool kSegs, bool kSeedDev>
__device__ __forceinline__ void consume(const FwdArgs& a,
                                        const Mask<kSegs>& mask,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        uint32_t base, unsigned char* gbase,
                                        int q0, int h, int hk, int b,
                                        int n_walk) {
  using G = Geom<D, N>;
  // the walk's length as a value the compiler knows to be warp-uniform:
  // ptxas serialises wgmmas inside a loop it cannot prove uniform
  const int n_iter = __shfl_sync(0xffffffffu, n_walk, 0);
  // the dropout seed's words: the launch's parameters, or (kSeedDev: a
  // staged seed) read from device memory once for the walk (philox.cuh)
  const DropParams staged =
      kSeedDev ? resolved(a.drop) : a.drop;
  const DropParams& drop = kSeedDev ? staged : a.drop;
  const bool warp0 = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 0;
  constexpr int kTileN = G::kTileN;
  const int g = threadIdx.x / 128;         // consumer index
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int c4 = lane % 4;
  const int row_a = warp * 16 + lane / 4;  // and row_a + 8
  const int wq0 = q0 + g * kRowsWG;        // this consumer's first q row
  const int qrow0 = wq0 + row_a;
  const int qrow1 = qrow0 + 8;
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const uint32_t bar_q = base + G::kBars;
  // the segment ids of this thread's two rows (read once; clamped reads
  // keep the mask free of branches)
  int qseg0 = 0, qseg1 = 0;
  if constexpr (kSegs) {
    qseg0 = mask.qs[min(qrow0, a.Lq - 1)];
    qseg1 = mask.qs[min(qrow1, a.Lq - 1)];
  }
  // Mask's decisions without a branch (every operand evaluated)
  auto visible = [&](int qr, int qseg, int kc) {
    bool ok = (qr < a.Lq) & (kc < mask.len) &
              (!a.causal | (kc <= qr + mask.offset));
    if constexpr (kSegs)
      ok &= qseg == mask.ks[max(0, min(kc, mask.len - 1))];
    return ok;
  };

  // Q: scale by sm_scale, round to bf16, in place
  mbar_wait(bar_q, 0);
  const uint32_t q_base = base + G::kQ + g * G::kQTile;
  {
    uint4* qv = reinterpret_cast<uint4*>(gbase + G::kQ + g * G::kQTile);
#pragma unroll
    for (int it = 0; it < G::kQTile / 16 / 128; ++it) {
      const int i = it * 128 + t;
      uint4 v = qv[i];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        e[k] = __float2bfloat16(__bfloat162float(e[k]) * a.sm_scale);
      qv[i] = v;
    }
  }
  fence_proxy_async();
  named_barrier(1 + g, 128);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf;  // running row max of the scores
  float l0 = 0.0f, l1 = 0.0f;        // this thread's share of the row sums
  float corr0 = 1.0f, corr1 = 1.0f;  // O's rescale before the pending P.V
  float sc[kTileN / 2];              // S, then P, of the current tile
  uint32_t pa[kTileN / 16][4];       // P of the previous tile, A fragments

  // S_j = Qs . K_j^T into sc
  auto issue_s = [&](int j) {
    const uint32_t k_base = base + G::kK + (j % G::kStages) * G::kKVTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int blk = kk * 16 / G::W;
      const int off = (kk * 16 % G::W) * 2;
      const uint64_t da = wgmma_desc(q_base + blk * G::kQBlock + off, 16,
                                     8 * G::kRowBytes, G::kLayout);
      const uint64_t db = wgmma_desc(k_base + blk * G::kKVBlock + off, 16,
                                     8 * G::kRowBytes, G::kLayout);
      wgmma_ss<kTileN>(sc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O += P_j . V_j from pa
  auto issue_pv = [&](int j) {
    const uint32_t v_base = base + G::kV + (j % G::kStages) * G::kKVTile;
#pragma unroll
    for (int ks = 0; ks < kTileN / 16; ++ks) {
      const uint64_t dv = wgmma_desc(v_base + ks * 16 * G::kRowBytes,
                                     G::kKVBlock, 8 * G::kRowBytes,
                                     G::kLayout);
      wgmma_rs<D>(o, pa[ks], dv, 1);
    }
    wgmma_commit();
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      o[4 * jn + 0] *= corr0;
      o[4 * jn + 1] *= corr0;
      o[4 * jn + 2] *= corr1;
      o[4 * jn + 3] *= corr1;
    }
  };
  // tile j's online softmax on sc: masks, m, l, corr, dropout; sc = P
  auto softmax = [&](int j) {
    const int n0 = j * kTileN;
    // sc[4 * jn + e]: row row_a (e < 2) or row_a + 8, key n0 + 8 * jn +
    // 2 * c4 + (e & 1)
    // warp-uniform (a broadcast the compiler can see), so the select
    // below is no divergent branch
    const bool need_mask = __shfl_sync(
        0xffffffffu,
        (int)(kSegs || n0 + kTileN > mask.len ||
              (a.causal && n0 + kTileN - 1 > wq0 + mask.offset)),
        0);
    // masked scores become -inf; m never goes below -1e30 (finite), so a
    // row with no visible key yet gets p = exp2(-inf) = 0 and corr = 1
    // with no select
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int jn = 0; jn < kTileN / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = visible(e < 2 ? qrow0 : qrow1, e < 2 ? qseg0 : qseg1,
                                n0 + 8 * jn + 2 * c4 + (e & 1));
        if (need_mask & !ok) sc[4 * jn + e] = -INFINITY;
        if (e < 2) mx0 = fmaxf(mx0, sc[4 * jn + e]);
        else mx1 = fmaxf(mx1, sc[4 * jn + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    corr0 = fast_exp2((m0 - mn0) * kLog2e);
    corr1 = fast_exp2((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    // p = exp(s - m) as exp2((s - m) * log2(e)). The one-FFMA form
    // exp2(s * log2(e) - m * log2(e)) saves an instruction but rounds
    // m * log2(e) once a row, a row-constant error in l and lse that the
    // backward reads; it failed GPT-medium's [train-plain] (PERF.md §6).
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) {
      const float p = fast_exp2((sc[i] - ((i & 2) ? mn1 : mn0)) * kLog2e);
      if (i & 2) sum1 += p;  // l from the undropped p
      else sum0 += p;
      sc[i] = p;
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    if constexpr (kDrop) {
      // lanes c4 and c4 ^ 1 share key group (n0 + 8 jn) / 4 + c4 / 2: the
      // even lane draws row 0's words, the odd lane row 1's, and they swap
      // the halves the other needs (words 0-1 serve the even lane's
      // columns, 2-3 the odd lane's)
      const bool odd = c4 & 1;
#pragma unroll
      for (int jn = 0; jn < kTileN / 8; ++jn) {
        const uint32_t grp = (uint32_t)(n0 + 8 * jn) / 4 + (c4 >> 1);
        const uint4 w = keep_words(drop, grp,
                                   (uint32_t)(odd ? qrow1 : qrow0), bh,
                                   kSaltAttention);
        const uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
        const uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
        sc[4 * jn + 0] *= keep_factor(drop, odd ? x0 : w.x);
        sc[4 * jn + 1] *= keep_factor(drop, odd ? x1 : w.y);
        sc[4 * jn + 2] *= keep_factor(drop, odd ? w.z : x0);
        sc[4 * jn + 3] *= keep_factor(drop, odd ? w.w : x1);
      }
    }
  };
  // P (rounded to bf16) as the A fragments of P . V's k16 steps
  auto to_pa = [&]() {
#pragma unroll
    for (int ks = 0; ks < kTileN / 16; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
        pa[ks][r] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
  };
  auto wait_full = [&](int v, int j) {
    mbar_wait(G::full(base, v, j % G::kStages),
              (uint32_t)(j / G::kStages) & 1u);
  };

  // The walk, FlashAttention-3's intra-warpgroup overlap: iteration j
  // issues S_j and, behind it, O += P_{j-1} . V_{j-1}, and runs tile j's
  // softmax while the tensor cores work through P_{j-1} . V_{j-1}. The
  // first S and the last P.V are peeled off, so no wgmma sits in a branch
  // and nothing divergent runs while one is in flight (ptxas serialises
  // the wgmmas otherwise). Both consumers walk every tile of the CTA.
  wait_full(0, 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
  release_kv<D, N>(tk, base, 0, 0, n_iter, hk, b, warp0);
  to_pa();
  for (int j = 1; j < n_iter; ++j) {
    wait_full(0, j);
    wait_full(1, j - 1);
    rescale_o();
    wgmma_fence();
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();  // S_j is done; P_{j-1} . V_{j-1} runs on
    fence_regs(sc);
    softmax(j);
    wgmma_wait<0>();
    fence_regs(o);
    release_kv<D, N>(tk, base, 0, j, n_iter, hk, b, warp0);
    release_kv<D, N>(tv, base, 1, j - 1, n_iter, hk, b, warp0);
    to_pa();
  }
  wait_full(1, n_iter - 1);
  rescale_o();
  wgmma_fence();
  issue_pv(n_iter - 1);
  wgmma_wait<0>();
  fence_regs(o);
  release_kv<D, N>(tv, base, 1, n_iter - 1, n_iter, hk, b, warp0);

  // row sums over the quad, then the epilogue through this consumer's Q tile
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  named_barrier(1 + g, 128);  // every warp is done reading Q
  // staging [64][D] bf16; 16-byte chunk c of row r sits at chunk
  // (c + r) % (D / 8), so a warp's eight rows hit eight bank groups
  constexpr int kChunks = D / 8;
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(gbase + G::kQ + g * G::kQTile);
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) {
    const int ch0 = (jn + row_a) % kChunks, ch1 = (jn + row_a + 8) % kChunks;
    *reinterpret_cast<__nv_bfloat162*>(stage + row_a * D + ch0 * 8 + 2 * c4) =
        __floats2bfloat162_rn(o[4 * jn] * inv0, o[4 * jn + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(stage + (row_a + 8) * D + ch1 * 8 +
                                       2 * c4) =
        __floats2bfloat162_rn(o[4 * jn + 2] * inv1, o[4 * jn + 3] * inv1);
  }
  named_barrier(1 + g, 128);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) +
                      (long)b * a.Lq * a.o_row + (long)h * D;
  static_assert(kRowsWG * kChunks % 128 == 0, "epilogue chunks");
#pragma unroll
  for (int it = 0; it < kRowsWG * kChunks / 128; ++it) {
    const int i = it * 128 + t;
    const int r = i / kChunks, c = i % kChunks;
    const int gr = wq0 + r;
    if (gr < a.Lq) {
      *reinterpret_cast<uint4*>(og + (long)gr * a.o_row + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * D +
                                          ((c + r) % kChunks) * 8);
    }
  }
  if (c4 == 0) {
    float* lse = a.lse + ((long)b * a.H + h) * a.Lq;
    // a row that saw no key keeps m = -1e30 (its lse is -1e30 + log(1e-30))
    if (qrow0 < a.Lq) lse[qrow0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (qrow1 < a.Lq) lse[qrow1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
}

template <int D, int N, bool kDrop, bool kSegs, bool kSeedDev>
__global__ void __launch_bounds__(kThreadsCTA, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const FwdArgs a) {
  using G = Geom<D, N>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRowsCTA;  // heaviest first
  const int hk = h / (a.H / a.Hkv);
  const Mask<kSegs> mask = mask_of<kSegs>(a, b);
  const int kv_end =
      a.causal ? min(mask.len, max(0, q0 + kRowsCTA + mask.offset))
               : mask.len;
  // tiles of the walk; at least one, so a CTA whose rows see no key still
  // runs the walk's code (every key masked: output 0) with no branch
  const int n_iter = max(1, (kv_end + G::kTileN - 1) / G::kTileN);
  const uint32_t bar_q = base + G::kBars;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int v = 0; v < 2; ++v) {
      for (int s = 0; s < G::kStages; ++s) {
        mbar_init(G::full(base, v, s), 1);
        mbar_init(G::empty(base, v, s), kThreadsCTA);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // the CTA's Q tiles, then the first kStages K/V tiles; consume()
    // refills each stage as the consumers release it
    mbar_arrive_expect_tx(bar_q, kConsumers * G::kQTile);
    for (int g = 0; g < kConsumers; ++g)
      for (int c = 0; c < G::kBlocks; ++c)
        tma_load_3d(base + G::kQ + g * G::kQTile + c * G::kQBlock, &tq,
                    bar_q, h * D + c * G::W, q0 + g * kRowsWG, b);
    for (int j = 0; j < min(n_iter, G::kStages); ++j) {
      load_tile_kv<D, N>(&tk, base, 0, j, hk, b);
      load_tile_kv<D, N>(&tv, base, 1, j, hk, b);
    }
  }
  consume<D, N, kDrop, kSegs, kSeedDev>(a, mask, &tk, &tv, base, gbase, q0,
                                     h, hk, b, n_iter);
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime's
// entry-point query (no link against libcuda); null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D tensor map (cols, L, B) over bf16 rows `row` elements apart (a
// batch row is L rows): boxes of W columns x `rows` rows with the swizzle
// of W * 2 bytes; rows past L read as zero. False when the encoding fails
// (a base or stride that is not 16-byte aligned).
inline bool make_map(CUtensorMap* map, const void* ptr, long cols, long row,
                     int L, int B, int W, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)row * 2,
                                 (cuuint64_t)row * 2 * (cuuint64_t)L};
  const cuuint32_t box[3] = {(cuuint32_t)W, (cuuint32_t)rows, 1u};
  const cuuint32_t estr[3] = {1u, 1u, 1u};
  const CUtensorMapSwizzle swz =
      W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kDrop, bool kSegs>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t stream) {
  using G = Geom<D, kTileFor<D, kDrop, kSegs>>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, a.q, (long)a.H * D, a.q_row, a.Lq, B, G::W, kRowsWG) ||
      !make_map(&tk, a.k, (long)a.Hkv * D, a.kv_row, a.Lk, B, G::W,
                G::kTileN) ||
      !make_map(&tv, a.v, (long)a.Hkv * D, a.kv_row, a.Lk, B, G::W,
                G::kTileN))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_sm90_kernel<D, G::kTileN, kDrop, kSegs, false>;
  if constexpr (kDrop) {
    // a staged seed: the instantiation that reads it from device memory
    // (the by-value one keeps its words in the parameter space)
    if (seed_in_memory(a.drop))
      kernel = flash_fwd_sm90_kernel<D, G::kTileN, kDrop, kSegs, true>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kAlloc);
  if (err != cudaSuccess) return err;
  dim3 grid(a.H, B, (a.Lq + kRowsCTA - 1) / kRowsCTA);
  kernel<<<grid, kThreadsCTA, G::kAlloc, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace
