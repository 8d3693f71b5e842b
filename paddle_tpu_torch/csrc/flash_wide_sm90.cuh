// The bf16 flash-attention kernels for wide heads on Hopper (sm_90a):
// every multiple of 64 above 256 forward and backward, and the D = 256
// backward. TMA-fed, wgmma on the tensor cores, accumulators in registers.
// Included by flash_attention.cuh, whose contracts they compute (the math,
// the rounding points, the masks and the dropout keying are set out there);
// flash_fwd and flash_bwd dispatch every bf16 D > 256, and the bf16 D = 256
// backward, here from both launchers (flash_attention_{fwd,bwd}.cu, the
// [B, L, H, D] layout with GQA, lengths and segment ids;
// flash_pair_{fwd,bwd}.cu, packed qkv at the multiples of 128).
//
// Replaces, at those head sizes: paddle_tpu/kernels/pallas/
// flash_attention.py `_flash_fwd_kernel`, `_flash_bwd_fused_kernel` and
// `_flash_dq_kernel` + `_flash_dkv_kernel` (the JAX `flash_attention_blhd`
// takes any D), and flash_pair.py `_pair_fwd_kernel` / `_pair_bwd_fused_
// kernel` (the pair gate admits 384, 512, ...), in bf16; it takes the place
// of the port's SIMT bigd:: kernels (flash_big_d.cuh, which keeps fp32)
// and, for the D = 256 backward, of the WMMA body.
//
// What bounds them: the products (4*D and 10*D operations an attended
// pair), so the tensor cores' rate. What stands in the way is room: a
// warpgroup of 64 rows holds an fp32 accumulator of C columns in C / 2
// registers a thread, so O (forward) and dK + dV (backward) of a whole head
// do not fit above D = 128 and 256; a 64-row bf16 tile of Q, K or V is 64
// KB at D = 512, so no operand of a whole head stays resident in shared
// memory beside a ring. The design:
//
// * Column slices. Each CTA owns one slice of kSlice = 128 head columns of
//   its accumulators (the grid's x is head * slices + slice): O[:, c] = P
//   V[:, c] in the forward, dV[:, c] = P^T dO[:, c], dK[:, c] = dS^T Q[:, c]
//   and dQ[:, c] = dS K[:, c] in the backward, with the register budget of
//   the D = 128 bodies (64 columns of O a thread; 64 + 64 of dK and dV).
//   The products that contract over the head, S = Qs K^T and dP = dO V^T,
//   run over the whole D in every slice's CTA: (slices - 1) * 2 * D
//   operations a pair recomputed in the forward, (slices - 1) * 4 * D in
//   the backward. The alternative, two warpgroups sharing 64 q rows and
//   splitting O's columns (128 each) with S computed once a CTA, does 6 * D
//   a pair at D = 512 against the slices' 10 * D, but halves the rows a K/V
//   tile is read for and runs the D = 256 forward's shape (O in 128
//   registers, 64-key tiles), which the card runs at ~0.2 of its peak
//   against ~0.3-0.4 for the D = 128 shape kept here (PERF.md §6): no
//   gain to expect, so the slices stay. They take any D and keep 128 rows a
//   CTA. The last slice of a D that is an odd multiple of 64 computes 64
//   columns twice (its second column block loads the first again) and
//   stores 64.
// * Streamed contraction. S and dP (dS's inputs) contract over D in
//   64-column chunks of 128-byte-swizzled tiles (the k-loop), through a
//   ring: forward, Qs and K chunks (three stages); backward, K, V, Qs and
//   dO chunks (two stages of 48 KB). A chunk's stage is released once its
//   wgmmas are done (wgmma_wait<1> leaves the next chunk's in flight) and
//   warp 0 refills it; so any D fits. The slice's operands of the second
//   products have their own tiles: the V slice ring (forward), the step's
//   Q and dO slices (single-buffered: loaded behind the next step's
//   chunks) and the kv tile's K slice, once (backward).
// * The scaled copy of q. round(q * scale) (S's rounding point) is written
//   once into the workspace by scale_q_kernel ahead of the body, at the
//   input's rows: every slice's CTA and every kv tile reads it many times,
//   and a copy in shared memory per chunk would cost a barrier per chunk.
//   The backward's dK reads the unscaled q.
// * The rest is the D <= 256 bodies' (flash_fwd_sm90.cuh,
//   flash_bwd_sm90.cuh): two consumer warpgroups of 64 rows, warp 0 issues
//   the TMA loads (lane 0 predicated; no producer warp: a ninth warp caps
//   every thread at 168 registers), the online softmax in registers (p =
//   exp2((s - m) * log2(e)), masks branch-free on the tiles that need
//   them), P as register A fragments of P V, S^T = K Qs^T orientation in the
//   backward (P^T and dS^T register-sourced into dV and dK), dS^T through a
//   swizzled tile for dQ, dq by cp.reduce.async.bulk a q row, sm_scale in
//   the conversion, every branch beside a live accumulator warp-uniform
//   (ptxas serialises the wgmmas otherwise: C7520, the build fails on it).
//   Dropout's keep bits come from the same Philox keys in every slice, so
//   the slices drop the same pairs. Only slice 0 writes lse.
// * Forward order per kv tile: P_{j-1} V_{j-1} is issued ahead of S_j's
//   chunks (its wgmmas overlap the first chunk), so each warpgroup's
//   softmax overlaps the other warpgroup's products, not its own.
// * Registers (the backward): dK, dV, S^T and dP^T are 192 registers a
//   thread at the p/dS conversion, the peak. The CTA's scalars (slice
//   columns, walk bounds, length, head) live in a small shared table read
//   where used (volatile loads, so they hold no register across the walk),
//   shared-memory addresses are 32-bit, and p, P^T and dS^T are formed in
//   one loop, so that the dropout instantiations need no spill (all four
//   at 251-255 registers).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "wgmma.cuh"

namespace {
namespace wide {

using sm90::kConsumers;
using sm90::kLog2e;
using sm90::kRowsCTA;
using sm90::kRowsWG;
using sm90::kThreadsCTA;
using sm90::make_map;

constexpr int kW = 64;          // columns of a chunk (one 128-byte row)
constexpr int kRowB = kW * 2;   // bytes of a chunk row
constexpr int kSlice = 128;     // accumulator columns a CTA owns
constexpr int kLayout = swizzle_code(kRowB);

// The bf16 backward at head size D runs here (else flash_bwd_sm90.cuh at
// 64, 80, 96 and 128): D = 256 too, where dK and dV stopped fitting in
// registers.
__host__ __device__ constexpr bool bwd_takes(int D) { return D >= 256; }

__host__ __device__ inline int n_slices(int D) {
  return (D + kSlice - 1) / kSlice;
}

// A K-major 128-byte-swizzled operand at `addr` (rows 128 bytes apart).
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) {
  return wgmma_desc(addr, 16, 8 * kRowB, kLayout);
}

// An MN-major 128-byte-swizzled operand at `addr` whose 64-column blocks
// lie `block` bytes apart.
__device__ __forceinline__ uint64_t mndesc(uint32_t addr, uint32_t block) {
  return wgmma_desc(addr, block, 8 * kRowB, kLayout);
}

// qs = round(q * scale) in bf16: q's rows (B * L of them, `q_row` elements
// apart, H * D columns from `q`) into qs [B * L, H * D]; 16 bytes a thread
// and step. The wide bodies read S's operand from here.
__global__ void scale_q_kernel(const __nv_bfloat16* __restrict__ q,
                               __nv_bfloat16* __restrict__ qs, long rows,
                               int hd, long q_row, float scale) {
  const int per_row = hd / 8;
  const long n = rows * per_row;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long r = i / per_row;
    const int c = (int)(i % per_row) * 8;
    uint4 v = *reinterpret_cast<const uint4*>(q + r * q_row + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      e[k] = __float2bfloat16(__bfloat162float(e[k]) * scale);
    *reinterpret_cast<uint4*>(qs + r * hd + c) = v;
  }
}

// ------------------------------------------------------------------ forward

// kv rows a tile: 128, or 64 where dropout and segment ids together would
// not fit in 255 registers (as flash_fwd_sm90.cuh's kTileFor at D = 128)
template <bool kDrop, bool kSegs>
constexpr int kFwdTile = kDrop && kSegs ? 64 : 128;

template <int N>
struct FwdGeom {
  static constexpr int kStages = 3;                  // the S chunk ring
  static constexpr int kQWG = kRowsWG * kRowB;       // one consumer's Qs rows
  static constexpr int kQChunk = kRowsCTA * kRowB;   // 128 q rows x 64 cols
  static constexpr int kKChunk = N * kRowB;          // N kv rows x 64 cols
  static constexpr int kSStage = kQChunk + kKChunk;
  static constexpr int kVBlock = N * kRowB;          // 64 columns of V
  static constexpr int kVStage = 2 * kVBlock;        // the slice's 128
  static constexpr int kVStages = 2;
  static constexpr int kOStage = kRowsWG * kSlice * 2;  // staged O, bf16
  static constexpr int kS = 0;
  static constexpr int kV = kS + kStages * kSStage;
  static constexpr int kO = kV + kVStages * kVStage;
  static constexpr int kBars = kO + kConsumers * kOStage;
  // S full and empty per stage, then V full and empty per stage
  static constexpr int kBytes = kBars + 8 * 2 * (kStages + kVStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align to 1024
  __device__ static uint32_t s_full(uint32_t base, int s) {
    return base + kBars + 8 * s;
  }
  __device__ static uint32_t s_empty(uint32_t base, int s) {
    return base + kBars + 8 * (kStages + s);
  }
  __device__ static uint32_t v_full(uint32_t base, int s) {
    return base + kBars + 8 * (2 * kStages + s);
  }
  __device__ static uint32_t v_empty(uint32_t base, int s) {
    return base + kBars + 8 * (2 * kStages + kVStages + s);
  }
  static_assert(kSStage % 1024 == 0 && kQWG % 1024 == 0 &&
                    kVBlock % 1024 == 0,
                "128-byte swizzle alignment");
  static_assert(kBars % 8 == 0, "mbarrier alignment");
  static_assert(kAlloc <= 232448, "forward tiles exceed shared memory");
};

template <int N, bool kDrop, bool kSegs>
__global__ void __launch_bounds__(kThreadsCTA, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const FwdArgs a, int D) {
  using G = FwdGeom<N>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);

  const int ns = n_slices(D);
  const int h = blockIdx.x / ns;
  const int c0 = (blockIdx.x % ns) * kSlice;  // this CTA's first column
  // the slice's second column block (the first again in a 64-column slice)
  const int c1 = min(c0 + kW, D - kW);
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRowsCTA;  // heaviest first
  const int hk = h / (a.H / a.Hkv);
  const Mask<kSegs> mask = mask_of<kSegs>(a, b);
  const int kv_end =
      a.causal ? min(mask.len, max(0, q0 + kRowsCTA + mask.offset))
               : mask.len;
  // at least one tile, so a CTA whose rows see no key runs the walk (every
  // key masked: output 0) with no branch
  const int n_walk = max(1, (kv_end + N - 1) / N);
  const int nc = D / kW;  // chunks of the contraction

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(G::s_full(base, s), 1);
      mbar_init(G::s_empty(base, s), kThreadsCTA);
    }
    for (int s = 0; s < G::kVStages; ++s) {
      mbar_init(G::v_full(base, s), 1);
      mbar_init(G::v_empty(base, s), kThreadsCTA);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Chunk u = j * nc + c of the S walk: the CTA's 128 Qs rows and tile j's
  // K rows at columns [c * 64, +64), into stage u % kStages once every
  // consumer thread has released the chunk that held it. Run by a whole
  // warp (lane 0 issues, by predicate), so no divergent branch sits beside
  // the live accumulators.
  auto load_s = [&](int u) {
    const int s = u % G::kStages;
    const int issue = threadIdx.x % 32 == 0;
    if (u >= G::kStages)
      mbar_wait(G::s_empty(base, s), (uint32_t)(u / G::kStages - 1) & 1u);
    const int j = u / nc, c = u % nc;
    const uint32_t full = G::s_full(base, s);
    const uint32_t dst = base + G::kS + s * G::kSStage;
    mbar_arrive_expect_tx(full, G::kSStage, issue);
    tma_load_3d(dst, &tq, full, h * D + c * kW, q0, b, issue);
    tma_load_3d(dst + G::kQChunk, &tk, full, hk * D + c * kW, j * N, b,
                issue);
  };
  // Tile j of V at the slice's columns into stage j % 2.
  auto load_v = [&](int j) {
    const int s = j % G::kVStages;
    const int issue = threadIdx.x % 32 == 0;
    if (j >= G::kVStages)
      mbar_wait(G::v_empty(base, s), (uint32_t)(j / G::kVStages - 1) & 1u);
    const uint32_t full = G::v_full(base, s);
    const uint32_t dst = base + G::kV + s * G::kVStage;
    mbar_arrive_expect_tx(full, G::kVStage, issue);
    tma_load_3d(dst, &tv, full, hk * D + c0, j * N, b, issue);
    tma_load_3d(dst + G::kVBlock, &tv, full, hk * D + c1, j * N, b, issue);
  };

  if (threadIdx.x == 0) {
    for (int u = 0; u < min(n_walk * nc, G::kStages); ++u) load_s(u);
    for (int j = 0; j < min(n_walk, G::kVStages); ++j) load_v(j);
  }

  // warp-uniform values the compiler can see as such: ptxas serialises
  // wgmmas inside a loop it cannot prove uniform
  const int n_iter = __shfl_sync(0xffffffffu, n_walk, 0);
  const int n_ch = __shfl_sync(0xffffffffu, nc, 0);
  const int n_chunks = n_iter * n_ch;
  const bool warp0 = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 0;
  const int g = threadIdx.x / 128;  // consumer index
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int c4 = lane % 4;
  const int row_a = warp * 16 + lane / 4;  // and row_a + 8
  const int wq0 = q0 + g * kRowsWG;        // this consumer's first q row
  const int qrow0 = wq0 + row_a;
  const int qrow1 = qrow0 + 8;
  const uint32_t bh = (uint32_t)(b * a.H + h);
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

  float o[kSlice / 2];
#pragma unroll
  for (int i = 0; i < kSlice / 2; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf;  // running row max of the scores
  float l0 = 0.0f, l1 = 0.0f;        // this thread's share of the row sums
  float corr0 = 1.0f, corr1 = 1.0f;  // O's rescale before the pending P.V
  float sc[N / 2];                   // S, then P, of the current tile
  uint32_t pa[N / 16][4];            // P of the previous tile, A fragments

  // every consumer thread releases chunk u; warp 0 refills its stage
  auto release_s = [&](int u) {
    mbar_arrive(G::s_empty(base, u % G::kStages));
    if (warp0 && u + G::kStages < n_chunks) load_s(u + G::kStages);
  };
  auto release_v = [&](int j) {
    mbar_arrive(G::v_empty(base, j % G::kVStages));
    if (warp0 && j + G::kVStages < n_iter) load_v(j + G::kVStages);
  };
  // S_j = Qs . K_j^T into sc, chunk by chunk; a chunk's stage is released
  // once its wgmmas (and every group before them) are done, the next
  // chunk's left in flight. Returns with every wgmma group done.
  auto run_s = [&](int j) {
    for (int c = 0; c < n_ch; ++c) {
      const int u = j * n_ch + c;
      const int s = u % G::kStages;
      mbar_wait(G::s_full(base, s), (uint32_t)(u / G::kStages) & 1u);
      const uint32_t q_base = base + G::kS + s * G::kSStage + g * G::kQWG;
      const uint32_t k_base = base + G::kS + s * G::kSStage + G::kQChunk;
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk)
        wgmma_ss<N>(sc, kdesc(q_base + kk * 32), kdesc(k_base + kk * 32),
                    (c > 0) | (kk > 0));
      wgmma_commit();
      if (c > 0) {  // warp-uniform
        wgmma_wait<1>();
        release_s(u - 1);
      }
    }
    wgmma_wait<0>();
    release_s(j * n_ch + n_ch - 1);
  };
  // O += P_j . V_j[:, slice] from pa (V MN-major, its two column blocks
  // kVBlock apart)
  auto issue_pv = [&](int j) {
    const uint32_t v_base = base + G::kV + (j % G::kVStages) * G::kVStage;
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks)
      wgmma_rs<kSlice>(o, pa[ks], mndesc(v_base + ks * 16 * kRowB,
                                         G::kVBlock), 1);
    wgmma_commit();
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int jn = 0; jn < kSlice / 8; ++jn) {
      o[4 * jn + 0] *= corr0;
      o[4 * jn + 1] *= corr0;
      o[4 * jn + 2] *= corr1;
      o[4 * jn + 3] *= corr1;
    }
  };
  // tile j's online softmax on sc: masks, m, l, corr, dropout; sc = P
  // (flash_fwd_sm90.cuh's, at kv tile N)
  auto softmax = [&](int j) {
    const int n0 = j * N;
    // sc[4 * jn + e]: row row_a (e < 2) or row_a + 8, key n0 + 8 * jn +
    // 2 * c4 + (e & 1)
    const bool need_mask = __shfl_sync(
        0xffffffffu,
        (int)(kSegs || n0 + N > mask.len ||
              (a.causal && n0 + N - 1 > wq0 + mask.offset)),
        0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int jn = 0; jn < N / 8; ++jn) {
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
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
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
      // the halves the other needs
      const bool odd = c4 & 1;
#pragma unroll
      for (int jn = 0; jn < N / 8; ++jn) {
        const uint32_t grp = (uint32_t)(n0 + 8 * jn) / 4 + (c4 >> 1);
        const uint4 w = keep_words(a.drop, grp,
                                   (uint32_t)(odd ? qrow1 : qrow0), bh,
                                   kSaltAttention);
        const uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
        const uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
        sc[4 * jn + 0] *= keep_factor(a.drop, odd ? x0 : w.x);
        sc[4 * jn + 1] *= keep_factor(a.drop, odd ? x1 : w.y);
        sc[4 * jn + 2] *= keep_factor(a.drop, odd ? w.z : x0);
        sc[4 * jn + 3] *= keep_factor(a.drop, odd ? w.w : x1);
      }
    }
  };
  // P (rounded to bf16) as the A fragments of P . V's k16 steps
  auto to_pa = [&]() {
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
        pa[ks][r] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
  };
  auto wait_v = [&](int j) {
    mbar_wait(G::v_full(base, j % G::kVStages),
              (uint32_t)(j / G::kVStages) & 1u);
  };

  // The walk. Iteration j issues O += P_{j-1} . V_{j-1}, then S_j's chunks
  // behind it; once S_j is done (and with it P_{j-1} . V_{j-1}), V_{j-1}
  // is released and tile j's softmax runs. The first S and the last P.V
  // are peeled off, so no wgmma sits in a branch.
  wgmma_fence();
  run_s(0);
  fence_regs(sc);
  softmax(0);
  to_pa();
  for (int j = 1; j < n_iter; ++j) {
    wait_v(j - 1);
    rescale_o();
    wgmma_fence();
    issue_pv(j - 1);
    run_s(j);
    fence_regs(sc);
    fence_regs(o);
    release_v(j - 1);
    softmax(j);
    to_pa();
  }
  wait_v(n_iter - 1);
  rescale_o();
  wgmma_fence();
  issue_pv(n_iter - 1);
  wgmma_wait<0>();
  fence_regs(o);
  release_v(n_iter - 1);

  // row sums over the quad, then the epilogue through this consumer's O
  // stage: [64][128] bf16, 16-byte chunk c of row r at chunk (c + r) % 16,
  // so a warp's eight rows hit eight bank groups
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  constexpr int kChunks = kSlice / 8;
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(gbase + G::kO + g * G::kOStage);
#pragma unroll
  for (int jn = 0; jn < kSlice / 8; ++jn) {
    const int ch0 = (jn + row_a) % kChunks, ch1 = (jn + row_a + 8) % kChunks;
    *reinterpret_cast<__nv_bfloat162*>(stage + row_a * kSlice + ch0 * 8 +
                                       2 * c4) =
        __floats2bfloat162_rn(o[4 * jn] * inv0, o[4 * jn + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(stage + (row_a + 8) * kSlice +
                                       ch1 * 8 + 2 * c4) =
        __floats2bfloat162_rn(o[4 * jn + 2] * inv1, o[4 * jn + 3] * inv1);
  }
  named_barrier(1 + g, 128);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) +
                      (long)b * a.Lq * a.o_row + (long)h * D + c0;
  const int cols = min(kSlice, D - c0);  // 128, or 64 in the last slice
#pragma unroll
  for (int it = 0; it < kRowsWG * kChunks / 128; ++it) {
    const int i = it * 128 + t;
    const int r = i / kChunks, c = i % kChunks;
    const int gr = wq0 + r;
    if (gr < a.Lq && c * 8 < cols) {
      *reinterpret_cast<uint4*>(og + (long)gr * a.o_row + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kSlice +
                                          ((c + r) % kChunks) * 8);
    }
  }
  if (c4 == 0 && c0 == 0) {
    float* lse = a.lse + ((long)b * a.H + h) * a.Lq;
    // a row that saw no key keeps m = -1e30 (its lse is -1e30 + log(1e-30))
    if (qrow0 < a.Lq) lse[qrow0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (qrow1 < a.Lq) lse[qrow1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
}

// The bf16 forward at D (a multiple of 64 above 256): scale_q_kernel into
// `qs` (bf16 [B, Lq, H * D], the workspace), then the body.
template <bool kDrop, bool kSegs>
cudaError_t launch_fwd(const FwdArgs& a, __nv_bfloat16* qs, int B, int D,
                       cudaStream_t stream) {
  constexpr int N = kFwdTile<kDrop, kSegs>;
  using G = FwdGeom<N>;
  if (D <= 256 || D % kW || qs == nullptr) return cudaErrorInvalidValue;
  const long hd = (long)a.H * D;
  const long rows = (long)B * a.Lq;
  scale_q_kernel<<<grid_for(rows * hd / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), qs, rows, (int)hd, a.q_row,
      a.sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, qs, hd, hd, a.Lq, B, kW, kRowsCTA) ||
      !make_map(&tk, a.k, (long)a.Hkv * D, a.kv_row, a.Lk, B, kW, N) ||
      !make_map(&tv, a.v, (long)a.Hkv * D, a.kv_row, a.Lk, B, kW, N))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wide_kernel<N, kDrop, kSegs>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::kAlloc);
  if (err != cudaSuccess) return err;
  dim3 grid(a.H * n_slices(D), B, (a.Lq + kRowsCTA - 1) / kRowsCTA);
  kernel<<<grid, kThreadsCTA, G::kAlloc, stream>>>(tq, tk, tv, a, D);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- backward

using sm90::kBwdRowsKV;
using sm90::kBwdRowsQ;
using sm90::kBwdRowsWG;

constexpr int kCtaInts = 9;  // the backward CTA's scalar table

struct BwdGeom {
  static constexpr int kKVChunk = kBwdRowsKV * kRowB;  // 128 kv rows x 64
  static constexpr int kQChunk = kBwdRowsQ * kRowB;    // 64 q rows x 64
  // a chunk stage: K, V (the tile's 128 kv rows), Qs, dO (64 q rows)
  static constexpr int kCK = 0;
  static constexpr int kCV = kKVChunk;
  static constexpr int kCQ = 2 * kKVChunk;
  static constexpr int kCDO = 2 * kKVChunk + kQChunk;
  static constexpr int kChunk = 2 * kKVChunk + 2 * kQChunk;
  static constexpr int kStages = 2;
  // the step's slice: Q (unscaled) and dO at the slice's two column blocks
  // (kQChunk apart), lse[64], delta[64]
  static constexpr int kSlQ = 0;
  static constexpr int kSlDO = 2 * kQChunk;
  static constexpr int kSlLse = 4 * kQChunk;
  static constexpr int kSlDelta = kSlLse + kBwdRowsQ * 4;
  static constexpr int kSlBytes = kSlDelta + kBwdRowsQ * 4;  // loaded a step
  static constexpr int kSl = (kSlBytes + 1023) / 1024 * 1024;
  // the kv tile's K at the slice's two column blocks, kKVChunk apart
  static constexpr int kDqLd = kW * 4 + 32;  // staged dQ row, bytes
  static constexpr int kRing = 0;
  static constexpr int kSlc = kRing + kStages * kChunk;
  static constexpr int kK = kSlc + kSl;
  static constexpr int kDS = kK + 2 * kKVChunk;      // dS^T [128][64] bf16
  static constexpr int kDQ = kDS + kBwdRowsKV * kBwdRowsQ * 2;
  static constexpr int kCta = kDQ + kConsumers * kBwdRowsQ * kDqLd;
  static constexpr int kBars = kCta + (4 * kCtaInts + 15) / 16 * 16;
  // K slice full; chunk full and empty per stage; slice full, slice
  // empty; dS^T free
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages + 3);
  static constexpr int kAlloc = kBytes + 1024;  // room to align to 1024
  __device__ static uint32_t k_full(uint32_t base) { return base + kBars; }
  __device__ static uint32_t c_full(uint32_t base, int s) {
    return base + kBars + 8 * (1 + s);
  }
  __device__ static uint32_t c_empty(uint32_t base, int s) {
    return base + kBars + 8 * (1 + kStages + s);
  }
  __device__ static uint32_t sl_full(uint32_t base) {
    return base + kBars + 8 * (1 + 2 * kStages);
  }
  __device__ static uint32_t sl_empty(uint32_t base) {
    return base + kBars + 8 * (2 + 2 * kStages);
  }
  __device__ static uint32_t ds_free(uint32_t base) {
    return base + kBars + 8 * (3 + 2 * kStages);
  }
  static_assert(kChunk % 1024 == 0 && kQChunk % 1024 == 0 &&
                    kSlc % 1024 == 0 && kK % 1024 == 0 && kDS % 1024 == 0,
                "128-byte swizzle alignment");
  static_assert(kBars % 8 == 0 && kDQ % 16 == 0 && kDqLd % 16 == 0,
                "mbarrier and bulk-copy alignment");
  static_assert(kAlloc <= 232448, "backward tiles exceed shared memory");
};

template <bool kDrop, bool kSegs>
__global__ void __launch_bounds__(kThreadsCTA, 1)
    flash_bwd_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tqs,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const BwdArgs a, int D) {
  using G = BwdGeom;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int ns = n_slices(D);
  const int hk = blockIdx.x / ns;
  const int c0 = (blockIdx.x % ns) * kSlice;  // this CTA's first column
  const int b = blockIdx.y;
  const int n0 = blockIdx.z * kBwdRowsKV;  // kv tile 0 walks the most
  const Mask<kSegs> mask = mask_of<kSegs>(a, b);

  // warp-uniform, as a broadcast shows the compiler
  if (n0 >= __shfl_sync(0xffffffffu, mask.len, 0)) {
    // every key of this tile is past the length: no query sees it, so its
    // dk and dv are zero, and it adds nothing to dq
    const int cols = min(kSlice, D - c0);
    const long at0 = ((long)b * a.Lk) * a.dkv_row + (long)hk * D + c0;
    const int rows = min(kBwdRowsKV, a.Lk - n0);
    for (int i = threadIdx.x; i < rows * cols; i += kThreadsCTA) {
      const long at = at0 + (long)(n0 + i / cols) * a.dkv_row + i % cols;
      static_cast<bf16*>(a.dk)[at] = __float2bfloat16(0.0f);
      static_cast<bf16*>(a.dv)[at] = __float2bfloat16(0.0f);
    }
    return;
  }

  // causal: the first q row that sees key n0 is n0 - offset; the walk
  // starts at the q tile holding it
  const int group = a.H / a.Hkv;
  const int first = a.causal ? max(0, n0 - mask.offset) : 0;
  const int n_qt = (a.Lq + kBwdRowsQ - 1) / kBwdRowsQ;
  const int mt0 = min(first / kBwdRowsQ, n_qt - 1);
  const int n_mt = n_qt - mt0;
  const int n_steps = group * n_mt;
  const int nc = D / kW;  // chunks of the contraction

  // The CTA's scalars, in shared memory and read where they are used: the
  // walk holds dK, dV, S^T and dP^T (192 registers a thread) at once, and
  // these would otherwise sit in registers beside them.
  enum { kC0, kC1, kChunks, kMt0, kNmt, kGroup, kLen, kHk, kOff };
  auto cta = [&](int i) { return ld_shared_s32(base + G::kCta + 4 * i); };

  if (threadIdx.x == 0) {
    mbar_init(G::k_full(base), 1);
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(G::c_full(base, s), 1);
      mbar_init(G::c_empty(base, s), kThreadsCTA);
    }
    mbar_init(G::sl_full(base), 1);
    mbar_init(G::sl_empty(base), kThreadsCTA);
    mbar_init(G::ds_free(base), kThreadsCTA);
    mbar_init_fence();
    // the slice's second column block: the first again in a 64-column
    // slice (see the header)
    const int table[kCtaInts] = {c0, min(c0 + kW, D - kW), n_steps * nc, mt0,
                                 n_mt, group, mask.len, hk,
                                 mask.offset};
    for (int i = 0; i < kCtaInts; ++i)
      st_shared_u32(base + G::kCta + 4 * i, (uint32_t)table[i]);
  }
  __syncthreads();

  // Chunk u = st * nc + c: columns [c * 64, +64) of the tile's K and V and
  // of step st's Qs and dO, into stage u % 2 once every consumer thread
  // has released the chunk that held it. A whole warp runs it (lane 0
  // issues, by predicate).
  auto load_chunk = [&](int u, int n_ch) {
    const int s = u % G::kStages;
    const int issue = threadIdx.x % 32 == 0;
    if (u >= G::kStages)
      mbar_wait(G::c_empty(base, s), (uint32_t)(u / G::kStages - 1) & 1u);
    const int st = u / n_ch, c = u % n_ch;
    const int n_mt_ = cta(kNmt), hk_ = cta(kHk);
    const int h = hk_ * cta(kGroup) + st / n_mt_;
    const int m0 = (cta(kMt0) + st % n_mt_) * kBwdRowsQ;
    const int r0 = blockIdx.z * kBwdRowsKV;
    const uint32_t full = G::c_full(base, s);
    const uint32_t dst = base + G::kRing + s * G::kChunk;
    mbar_arrive_expect_tx(full, G::kChunk, issue);
    tma_load_3d(dst + G::kCK, &tk, full, hk_ * D + c * kW, r0, blockIdx.y,
                issue);
    tma_load_3d(dst + G::kCV, &tv, full, hk_ * D + c * kW, r0, blockIdx.y,
                issue);
    tma_load_3d(dst + G::kCQ, &tqs, full, h * D + c * kW, m0, blockIdx.y,
                issue);
    tma_load_3d(dst + G::kCDO, &tdo, full, h * D + c * kW, m0, blockIdx.y,
                issue);
  };
  // Step st's Q and dO at the slice's columns, lse and delta, once every
  // consumer thread has released step st - 1's.
  auto load_slice = [&](int st) {
    const int issue = threadIdx.x % 32 == 0;
    if (st > 0) mbar_wait(G::sl_empty(base), (uint32_t)(st - 1) & 1u);
    const int n_mt_ = cta(kNmt);
    const int h = cta(kHk) * cta(kGroup) + st / n_mt_;
    const int m0 = (cta(kMt0) + st % n_mt_) * kBwdRowsQ;
    const int col0 = h * D + cta(kC0), col1 = h * D + cta(kC1);
    const uint32_t full = G::sl_full(base);
    const uint32_t dst = base + G::kSlc;
    mbar_arrive_expect_tx(full, G::kSlBytes, issue);
    tma_load_3d(dst + G::kSlQ, &tq, full, col0, m0, blockIdx.y, issue);
    tma_load_3d(dst + G::kSlQ + G::kQChunk, &tq, full, col1, m0, blockIdx.y,
                issue);
    tma_load_3d(dst + G::kSlDO, &tdo, full, col0, m0, blockIdx.y, issue);
    tma_load_3d(dst + G::kSlDO + G::kQChunk, &tdo, full, col1, m0,
                blockIdx.y, issue);
    const long row = ((long)blockIdx.y * a.H + h) * a.Lq_pad + m0;
    bulk_load(dst + G::kSlLse, a.lse_pad + row, kBwdRowsQ * 4, full, issue);
    bulk_load(dst + G::kSlDelta, a.delta + row, kBwdRowsQ * 4, full, issue);
  };

  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(G::k_full(base), 2 * G::kKVChunk);
    tma_load_3d(base + G::kK, &tk, G::k_full(base), hk * D + c0, n0, b);
    tma_load_3d(base + G::kK + G::kKVChunk, &tk, G::k_full(base),
                hk * D + min(c0 + kW, D - kW), n0, b);
    for (int u = 0; u < min(n_steps * nc, G::kStages); ++u)
      load_chunk(u, nc);
    load_slice(0);
  }

  // warp-uniform values the compiler can see as such
  const int n_iter = __shfl_sync(0xffffffffu, n_steps, 0);
  const int n_ch = __shfl_sync(0xffffffffu, nc, 0);
  const bool warp0 = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0) == 0;
  const int g = threadIdx.x / 128;  // consumer index
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int c4 = lane % 4;
  const int row_a = warp * 16 + lane / 4;  // and row_a + 8 (kv rows)
  const int kv_wg = n0 + g * kBwdRowsWG;   // this consumer's first kv row
  // Philox, as flash_bwd_sm90.cuh draws it: the four lanes of one key group
  // are r = (lane / 4) % 4 of a quad column c4; each draws the words of a
  // quarter of the group's q columns and the four transpose them. The
  // slots run one after another (their states would meet dK and dV).
  auto keep_bits = [&](int m0, uint32_t bh) {
    const int kr = (lane / 4) % 4;
    const uint32_t grp0 =
        (uint32_t)(kv_wg + warp * 16 + 4 * (lane / 16)) / 4;
    uint32_t keep = 0u;
#pragma unroll 1
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

  // every consumer thread releases chunk u; warp 0 refills its stage
  auto release_chunk = [&](int u) {
    mbar_arrive(G::c_empty(base, u % G::kStages));
    if (warp0 && u + G::kStages < cta(kChunks))
      load_chunk(u + G::kStages, n_ch);
  };

  float dk[kSlice / 2], dv[kSlice / 2];
#pragma unroll
  for (int i = 0; i < kSlice / 2; ++i) {
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }
  mbar_wait(G::k_full(base), 0);

  for (int step = 0; step < n_iter; ++step) {
    const int n_mt_ = cta(kNmt);
    const int m0 = (cta(kMt0) + step % n_mt_) * kBwdRowsQ;
    const uint32_t bh =
        (uint32_t)(b * a.H + cta(kHk) * cta(kGroup) + step / n_mt_);

    // which of the 32 pairs are attended (bit i for st[i]), only where the
    // tile crosses the causal diagonal, a length or Lq, or has segment ids
    const int len = cta(kLen);
    const int kvb = __shfl_sync(0xffffffffu, kv_wg, 0);
    const bool need_mask = __shfl_sync(
        0xffffffffu,
        (int)(kSegs || m0 + kBwdRowsQ > a.Lq || kvb + kBwdRowsWG > len ||
              (a.causal && kvb + kBwdRowsWG - 1 > m0 + cta(kOff))),
        0);
    uint32_t vis = ~0u;
    if (need_mask) {  // warp-uniform
      vis = 0u;
      const int kv0 = kv_wg + row_a, kv1 = kv0 + 8;
      const int off = cta(kOff);
      // the segment ids of this thread's two kv rows and the tile's q
      // rows (clamped reads keep the mask free of branches)
      int kseg0 = 0, kseg1 = 0;
      if constexpr (kSegs) {
        kseg0 = mask.ks[max(0, min(kv0, len - 1))];
        kseg1 = mask.ks[max(0, min(kv1, len - 1))];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qr = m0 + 8 * (i / 4) + 2 * c4 + (i & 1);
        const int kc = (i & 2) ? kv1 : kv0;
        bool ok = (qr < a.Lq) & (kc < len) &
                  (!a.causal | (kc <= qr + off));
        if constexpr (kSegs)
          ok &= mask.qs[min(qr, a.Lq - 1)] == ((i & 2) ? kseg1 : kseg0);
        vis |= (uint32_t)ok << i;
      }
    }
    uint32_t keep = 0u;
    if constexpr (kDrop) keep = keep_bits(m0, bh);

    // S^T = K Qs^T and dP^T = V dO^T for this consumer's 64 kv rows, over
    // the head's chunks; each chunk's stage is released once its products
    // are done
    float st[32], dpt[32];
    wgmma_fence();
    for (int c = 0; c < n_ch; ++c) {
      const int u = step * n_ch + c;
      const int s = u % G::kStages;
      mbar_wait(G::c_full(base, s), (uint32_t)(u / G::kStages) & 1u);
      const uint32_t stage = base + G::kRing + s * G::kChunk;
      const uint32_t k_rows = stage + G::kCK + g * kBwdRowsWG * kRowB;
      const uint32_t v_rows = stage + G::kCV + g * kBwdRowsWG * kRowB;
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk)
        wgmma_ss<64>(st, kdesc(k_rows + kk * 32),
                     kdesc(stage + G::kCQ + kk * 32), (c > 0) | (kk > 0));
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk)
        wgmma_ss<64>(dpt, kdesc(v_rows + kk * 32),
                     kdesc(stage + G::kCDO + kk * 32), (c > 0) | (kk > 0));
      wgmma_commit();
      if (c > 0) {  // warp-uniform
        wgmma_wait<1>();
        release_chunk(u - 1);
      }
    }
    wgmma_wait<0>();
    release_chunk(step * n_ch + n_ch - 1);
    fence_regs(st);
    fence_regs(dpt);

    // the step's lse, delta, Q and dO slices
    mbar_wait(G::sl_full(base), (uint32_t)step & 1u);
    // the other consumer's dQ of the previous step reads this consumer's
    // dS^T rows: wait until both have finished it
    if (step > 0) mbar_wait(G::ds_free(base), (uint32_t)(step - 1) & 1u);

    // p, then P^T (times the keep factor) and dS^T as bf16 A fragments,
    // four q columns at a time (one loop: its peak is lower than two
    // loops', and the dropout instantiations then need no spill);
    // st[4 * jn + e]: kv row row_a (e < 2) or row_a + 8, q column
    // 8 * jn + 2 * c4 + (e & 1)
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 l =
          ld_shared_f32x2(base + G::kSlc + G::kSlLse + 4 * (8 * jn + 2 * c4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            fast_exp2((st[4 * jn + e] - ((e & 1) ? l.y : l.x)) * kLog2e);
        st[4 * jn + e] = ((vis >> (4 * jn + e)) & 1u) ? p : 0.0f;
      }
      const float2 dl = ld_shared_f32x2(base + G::kSlc + G::kSlDelta +
                                        4 * (8 * jn + 2 * c4));
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
      st_shared_u32(base + G::kDS + r0 * 128 + ((jn ^ (r0 & 7)) * 16) +
                        c4 * 4,
                    dsa[ks][2 * hi]);
      st_shared_u32(base + G::kDS + (r0 + 8) * 128 + ((jn ^ (r0 & 7)) * 16) +
                        c4 * 4,
                    dsa[ks][2 * hi + 1]);
    }

    // dV += P^T dO[:, slice] and dK += dS^T Q[:, slice] (q unscaled), dO
    // and Q MN-major, their two column blocks kQChunk apart
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs<kSlice>(dv, pa[ks],
                       mndesc(base + G::kSlc + G::kSlDO + ks * 16 * kRowB,
                              G::kQChunk),
                       1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs<kSlice>(dk, dsa[ks],
                       mndesc(base + G::kSlc + G::kSlQ + ks * 16 * kRowB,
                              G::kQChunk),
                       1);
    wgmma_commit();

    // dQ[:, block g] = dS K[:, block g] over the tile's 128 kv rows once
    // both consumers' dS^T are in shared memory (dS^T and K MN-major)
    fence_proxy_async();
    named_barrier(1, kThreadsCTA);
    float dq[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBwdRowsKV / 16; ++ks)
      wgmma_ss_tt<64>(dq, mndesc(base + G::kDS + ks * 16 * 128, 128 * 128),
                    mndesc(base + G::kK + g * G::kKVChunk + ks * 16 * kRowB,
                           G::kKVChunk),
                    ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);
    mbar_arrive(G::ds_free(base));

    // release the step's slices; warp 0 loads the next step's (needed
    // behind its chunks)
    mbar_arrive(G::sl_empty(base));
    if (warp0 && step + 1 < n_iter) load_slice(step + 1);

    // dQ: stage (this consumer's previous reduction has read its rows),
    // then one bulk fp32 reduction a q row
    bulk_wait_read();
    named_barrier(2 + g, 128);
    const uint32_t dq_stage = base + G::kDQ + g * kBwdRowsQ * G::kDqLd;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int col = 8 * jn + 2 * c4;
      st_shared_f32x2(dq_stage + row_a * G::kDqLd + col * 4, dq[4 * jn],
                      dq[4 * jn + 1]);
      st_shared_f32x2(dq_stage + (row_a + 8) * G::kDqLd + col * 4,
                      dq[4 * jn + 2], dq[4 * jn + 3]);
    }
    fence_proxy_async();
    named_barrier(2 + g, 128);
    {
      // this consumer's dQ columns: the slice's block g (none when that
      // block repeats the first one, in a 64-column slice)
      const int n_mt2 = cta(kNmt);
      const int m0r = (cta(kMt0) + step % n_mt2) * kBwdRowsQ;
      const int h = cta(kHk) * cta(kGroup) + step / n_mt2;
      const int c0r = cta(kC0);
      const int dq_live = g == 0 || c0r + kW < D;
      const int r = min(t, kBwdRowsQ - 1);
      const long at = ((long)b * a.Lq + m0r + r) * ((long)a.H * D) +
                      (long)h * D + cta(g ? kC1 : kC0);
      bulk_reduce_add_f32(a.dq_acc + at, dq_stage + r * G::kDqLd, kW * 4,
                          (t < kBwdRowsQ) & (m0r + t < a.Lq) & dq_live);
      bulk_commit();
    }
  }
  bulk_wait_all();

  // dK (scaled once here) and dV, the group's fp32 sums, rounded once, at
  // the slice's columns
  const int c0e = cta(kC0);
  const int cols = min(kSlice, D - c0e);
  const long dkv_base =
      ((long)b * a.Lk) * a.dkv_row + (long)cta(kHk) * D + c0e;
  bf16* dk_out = static_cast<bf16*>(a.dk) + dkv_base;
  bf16* dv_out = static_cast<bf16*>(a.dv) + dkv_base;
  const int kv0 = kv_wg + row_a, kv1 = kv0 + 8;
#pragma unroll
  for (int jn = 0; jn < kSlice / 8; ++jn) {
    const int col = 8 * jn + 2 * c4;
    if (8 * jn < cols) {
      if (kv0 < a.Lk) {
        const long at = (long)kv0 * a.dkv_row + col;
        *reinterpret_cast<__nv_bfloat162*>(dk_out + at) =
            __floats2bfloat162_rn(dk[4 * jn] * a.sm_scale,
                                  dk[4 * jn + 1] * a.sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
            __floats2bfloat162_rn(dv[4 * jn], dv[4 * jn + 1]);
      }
      if (kv1 < a.Lk) {
        const long at = (long)kv1 * a.dkv_row + col;
        *reinterpret_cast<__nv_bfloat162*>(dk_out + at) =
            __floats2bfloat162_rn(dk[4 * jn + 2] * a.sm_scale,
                                  dk[4 * jn + 3] * a.sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
            __floats2bfloat162_rn(dv[4 * jn + 2], dv[4 * jn + 3]);
      }
    }
  }
}

// The bf16 backward body at D (256 or a multiple of 64 above): the scaled
// copy of q into `qs` (bf16 [B, Lq, H * D], the workspace's last region),
// then the body. The pre-pass (delta, lse, dq's scratch zeroed) runs before
// and the dq conversion after, as for every backward.
template <bool kDrop, bool kSegs>
cudaError_t launch_bwd(const BwdArgs& a, __nv_bfloat16* qs, int B, int D,
                       cudaStream_t stream) {
  using G = BwdGeom;
  if (!bwd_takes(D) || D % kW || qs == nullptr) return cudaErrorInvalidValue;
  const long hd = (long)a.H * D;
  const long rows = (long)B * a.Lq;
  scale_q_kernel<<<grid_for(rows * hd / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), qs, rows, (int)hd, a.q_row,
      a.sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tqs, tk, tv, tdo;
  const long kvd = (long)a.Hkv * D;
  if (!make_map(&tq, a.q, hd, a.q_row, a.Lq, B, kW, kBwdRowsQ) ||
      !make_map(&tqs, qs, hd, hd, a.Lq, B, kW, kBwdRowsQ) ||
      !make_map(&tk, a.k, kvd, a.kv_row, a.Lk, B, kW, kBwdRowsKV) ||
      !make_map(&tv, a.v, kvd, a.kv_row, a.Lk, B, kW, kBwdRowsKV) ||
      !make_map(&tdo, a.dout, hd, hd, a.Lq, B, kW, kBwdRowsQ))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_wide_kernel<kDrop, kSegs>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::kAlloc);
  if (err != cudaSuccess) return err;
  dim3 grid(a.Hkv * n_slices(D), B, (a.Lk + kBwdRowsKV - 1) / kBwdRowsKV);
  kernel<<<grid, kThreadsCTA, G::kAlloc, stream>>>(tq, tqs, tk, tv, tdo, a,
                                                   D);
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace
