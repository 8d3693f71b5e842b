// Flash attention in fp32 for Hopper (sm_90a), on both launchers, both
// ways at every head size: heads above 256 (every multiple of 64: 320,
// 384, 512, ...: flash_fwd_f32_wide_kernel, flash_bwd_f32_wide_kernel) and
// heads up to 256 (64, 80, 96, 128, 256: flash_fwd_f32_small_kernel,
// flash_bwd_f32_kernel). Included by flash_attention.cuh, whose contracts
// these kernels compute (the math, the rounding points, the masks and the
// dropout keying are set out there); flash_fwd and flash_bwd dispatch
// every fp32 D here from both launchers (flash_attention_{fwd,bwd}.cu, the
// [B, L, H, D] layout with GQA, lengths and segment ids;
// flash_pair_{fwd,bwd}.cu, packed qkv at 64, 128, 256 and the multiples of
// 128 above). bf16 runs the wgmma kernels.
//
// Replaces, in fp32: paddle_tpu/kernels/pallas/flash_attention.py
// `_flash_fwd_kernel`, `_flash_bwd_fused_kernel` and `_flash_dq_kernel` +
// `_flash_dkv_kernel` (the JAX `flash_attention_blhd` takes any D), and
// flash_pair.py `_pair_fwd_kernel` / `_pair_bwd_fused_kernel`.
// flash_fwd_f32_small_kernel and flash_bwd_f32_kernel take the place of
// the port's first SIMT bodies (one lane pair a q row, one chain over D a
// score, S, P and O in shared memory, scalar dq atomics).
//
// What bounds them: the products, 4*D operations an attended pair forward
// and 10*D backward, on the fp32 FMA pipes (67 TFLOP/s on the H100: TF32
// would miss the exact-gradient gate, 2.3e-6). Measured on the card, what
// holds them back is shared-memory loads (a lane receives 4 bytes a
// clock, so a 4 x 4 register tile, half a float a FFMA, caps the FMA
// pipes near half their rate), the operand copies and the barriers, each
// a share of a few tenths (PERF.md, Findings). The design:
//
// * Register micro-tiles. Every product is a small matrix product over
//   tiles in shared memory; each thread computes a block of outputs from
//   16-byte loads: 4 x 4 in the forward's S and P.V and the backward's S
//   and dP (four loads of each operand feed 64 FFMAs), 8 x 4 in dV, dK
//   and dQ. Operand rows are padded (68 floats; 36 in the backward's
//   32-column items, P and dS) and the K/V rows of the score products
//   stored permuted (key 4t + b at tile row b * rows / 4 + t), so the rows
//   a warp reads at once fall on distinct banks while a thread's four keys
//   stay adjacent: one Philox call covers them (dropout keys go in groups
//   of four).
// * The accumulators in shared memory for the whole walk: O (forward) and
//   dK, dV (backward) of up to kMaxW = 512 columns, read-modify-written
//   once a chunk from the registers. No global scratch.
// * Column slices above 512: a CTA owns the O (dK and dV) columns of one
//   slice (ceil(D / 512) slices, their widths within a chunk of 64 of
//   each other) and computes the score products over the whole head, so
//   D = 320 ... 512 run one slice and a wider head recomputes S (and dP)
//   once a slice.
// * The contraction over D in 64-column chunks, each chunk summed apart in
//   one fp32 chain and the chunk sums added (the short chains the
//   exact-gradient gate needs), streamed through a two-stage ring of
//   cp.async copies: the next item lands while this one is multiplied, one
//   barrier an item. round(q * scale) (S's rounding point: the fp32
//   product) is formed in shared memory by the thread that copied it.
// * Forward: one CTA of 256 threads per (64-row q tile, q head, batch row,
//   slice), heaviest causal tiles first; one pass over the kv tiles of 64
//   keys with the online softmax (m, l per row in registers; O rescaled by
//   exp(m_old - m_new) as P.V of each 64-column chunk is added into it).
//   Each warp owns 8 q rows: the row max and sum are warp shuffles, and P
//   is written and read by the warp that owns its rows.
// * Backward: one CTA of 256 threads per (32-row kv tile, KV head, batch
//   row, slice, rank), walking the group's q heads and the 64-row q tiles
//   from the causal diagonal down. A step: S = Qs K^T (warps 0-3) and dP =
//   dO V^T (warps 4-7) over D in items of 32 columns (two make a chunk
//   sum), p and dS into shared memory, then per chunk of the slice dV +=
//   P^T dO (warps 0-1) and dK += dS^T q (warps 2-3) into the shared
//   accumulators and dQ = dS K (warps 4-7) added to dq's fp32 scratch by
//   16-byte reductions (red.global.add.v4.f32). The causal walks differ
//   by up to Lq / 64 steps, and the longest sets a launch's time: a
//   cluster of up to kMaxSplit CTAs shares a kv tile's walk, and each CTA
//   sums its rows of dK and dV over the cluster in rank order through
//   distributed shared memory, so dk and dv stay equal between launches.
//   A kv tile past the length writes zero dk, dv.
// * Heads up to 256, both ways at one slice with the head size a template
//   argument of the forward. The scores s are one fp32 chain over the head
//   in column order, starting at 0, in both: flash_fwd_f32_small_kernel
//   sums them so and flash_bwd_f32_kernel recomputes them (and dp) the
//   same way, so the backward's s equals the forward's bit for bit and p =
//   exp(s - lse) keeps the forward's normalisation (summed in chunks, as
//   above 256, p sat farther from the exact gradient than the plain
//   version, over its 9e-7 gate). Change the order in both or in neither.
//   The forward keeps round(q * scale) in shared memory for the whole walk
//   and O in registers (a lane's 4 x 4 of each chunk: 16 floats a chunk,
//   64 at D = 256), so a kv tile is ceil(D / 64) K chunks and as many V
//   chunks and two CTAs share an SM up to D = 128. The backward's score
//   items are 64 columns where D is a multiple of 64 (half the items and
//   barriers a step), 32 at 80 and 96 (three items, not two of 64 over
//   128 columns). Columns past D are copied as zeros (cp.async's source
//   size) and never written, so 80 and 96 need no padded copy.
//
// Shared memory (bytes), static_asserted below: forward 87,040 + 256 * W,
// backward 100,864 + 256 * W for a slice of W columns (32-column score
// items; 123,392 + 256 * W with 64-column ones): D = 320, 384, 448, 512
// run one slice (forward 168,960 / 185,344 / 201,728 / 218,112; backward
// 182,784 / 199,168 / 215,552 / 231,936); D = 1024 runs two slices of 512
// (the score products twice); up to 256 the forward takes 69,632 / 86,016
// / 86,016 / 86,016 / 118,784 and the backward 139,776 / 133,632 / 133,632
// / 156,160 / 188,928 at D = 64 / 80 / 96 / 128 / 256.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

#include "wgmma.cuh"  // smem_u32

namespace {
namespace f32w {

constexpr int kThr = 256;     // threads of a CTA
constexpr int kRows = 64;     // q rows of a forward CTA and of a backward step
constexpr int kKeys = 32;     // kv rows of a backward CTA
constexpr int kW = 64;        // columns of a chunk
constexpr int kH = 32;        // columns of a backward score item (32-wide)
constexpr int kLd = kW + 4;   // padded row of a forward score operand (floats)
constexpr int kLdP = kKeys + 4;  // padded row of the backward's P and dS
constexpr int kMaxW = 512;    // columns of the widest slice
constexpr int kMaxSplit = 4;  // CTAs of a backward cluster
constexpr int kSmemMax = 232448;
// q rows a forward lane owns: warp w owns 2 * kFwdRA rows, lane (ty, tx)
// rows 2w * kFwdRA + ty + 2a
constexpr int kFwdRA = kRows * 16 / kThr;

// Forward layout (floats): P [64][kLd] | 2 stages of {Q [64][kLd], K or V
// [64][kLd]} | O [64][W].
constexpr int kFwdTile = kRows * kLd;
constexpr int kFwdStage = 2 * kFwdTile;
constexpr int kFwdO = kFwdTile + 2 * kFwdStage;
__host__ __device__ constexpr int fwd_smem_bytes(int W) {
  return 4 * (kFwdO + kRows * W);
}
static_assert(fwd_smem_bytes(kMaxW) <= kSmemMax,
              "forward tiles exceed shared memory");

// Backward layout (floats) for score items of SW columns: 2 stages | P, dS
// [64][kLdP] | lse, delta [64] | dK, dV [32][W]. A stage holds a score
// item's {Q [64][kLd], K [32][kLd], dO [64][kLd], V [32][kLd]} (SW columns
// of each, rows padded to kLd = SW + 4) or a gradient item's {dO [64][64],
// q [64][64], K [32][64]} (64 columns).
template <int SW>
struct BwdLayout {
  static constexpr int kLd = SW + 4;
  static constexpr int kGrad = 2 * kRows * kW + kKeys * kW;
  static constexpr int kScore = 2 * (kRows + kKeys) * kLd;
  static constexpr int kStage = kGrad > kScore ? kGrad : kScore;
  static constexpr int kP = 2 * kStage;
  static constexpr int kDS = kP + kRows * kLdP;
  static constexpr int kLse = kDS + kRows * kLdP;
  static constexpr int kAcc = kLse + 2 * kRows;
  __host__ __device__ static constexpr int bytes(int W) {
    return 4 * (kAcc + 2 * kKeys * W);
  }
  static_assert(kAcc % 4 == 0 && kStage % 4 == 0 && kP % 4 == 0 &&
                    kDS % 4 == 0 && kLse % 4 == 0,
                "16-byte alignment of the regions");
};
// Columns of a score item of the backward up to 256 at head size D: 64
// where D is a multiple of 64 (half the items and barriers of 32-column
// ones), 32 at 80 and 96 (three cover 96 columns; two of 64 would run 128).
__host__ __device__ constexpr int small_sw(int D) { return D % kW ? kH : kW; }
static_assert(BwdLayout<kH>::bytes(kMaxW) <= kSmemMax &&
                  BwdLayout<kW>::bytes(256) <= kSmemMax,
              "backward tiles exceed shared memory");
static_assert(kFwdO % 4 == 0, "16-byte alignment of the regions");

// Slices of a head of D columns: ceil(D / kMaxW), chunk c in slice s when
// s * nC / slices <= c < (s + 1) * nC / slices (nC = D / 64 chunks).
__host__ __device__ inline int n_slices(int D) {
  return (D + kMaxW - 1) / kMaxW;
}
__host__ __device__ inline int widest_slice(int D) {
  const int nc = D / kW, s = n_slices(D);
  return (nc + s - 1) / s * kW;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// dq's fp32 scratch += v at p (16-byte aligned): one vector reduction.
__device__ __forceinline__ void red_add4(float* p, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The cluster's CTAs: a barrier over all their threads (release, acquire),
// and a 16-byte load from CTA `rank`'s shared memory at the offset of
// this CTA's `p`.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float4 ld4_cluster(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

// Copies rows [r0, r0 + R) x columns [c0, c0 + C) of a matrix whose rows
// are `row` floats apart into a tile whose rows are LD floats apart, with
// kPerm row 4t + b at tile row b * R / 4 + t; rows at or past L read as
// zero, and with kCols columns at or past `cols` (a multiple of 4) too.
// Thread i copies the 16-byte slots i, i + 256, ... (scale_tile scales the
// same slots).
template <int R, int C, int LD, bool kPerm, bool kCols = false>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int L, long row, int c0,
                                          int cols = 0) {
  static_assert((R * C / 4) % kThr == 0, "whole passes");
#pragma unroll
  for (int k = 0; k < R * C / 4 / kThr; ++k) {
    const int i = threadIdx.x + k * kThr;
    const int r = i / (C / 4), s = i % (C / 4);
    const int tr = kPerm ? (r & 3) * (R / 4) + (r >> 2) : r;
    const bool ok = r0 + r < L && (!kCols || c0 + 4 * s < cols);
    cp_async16(dst + tr * LD + 4 * s,
               src + (long)(ok ? r0 + r : 0) * row +
                   (!kCols || ok ? c0 + 4 * s : 0),
               ok ? 16 : 0);
  }
}

// The slots this thread copied into a [64][LD] tile of C columns (load_tile
// without kPerm), times `scale` (round(q * scale) in fp32), once its copies
// have landed.
template <int C, int LD>
__device__ __forceinline__ void scale_tile(float* t, float scale) {
#pragma unroll
  for (int k = 0; k < kRows * C / 4 / kThr; ++k) {
    const int i = threadIdx.x + k * kThr;
    float* p = t + i / (C / 4) * LD + 4 * (i % (C / 4));
    float4 v = ld4(p);
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    st4(p, v);
  }
}

// acc[a][b] += A[a] . B[b] over K columns (kSet: acc = ...), summed apart
// in one chain and then added (the short chains the exact-gradient gate
// needs), or with kChain in acc's own chain, column after column (the
// scores' order up to D = 256, both ways): A rows `a_ld` floats apart from A,
// B rows `b_ld` floats apart from B (16-byte loads along the contraction).
template <int K, bool kSet = false, bool kChain = false, int NA, int NB>
__device__ __forceinline__ void nt_chunk(float (&acc)[NA][NB],
                                         const float* A, int a_ld,
                                         const float* B, int b_ld) {
  float part[NA][NB];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) part[a][b] = kChain ? acc[a][b] : 0.0f;
#pragma unroll
  for (int d4 = 0; d4 < K / 4; ++d4) {
    float4 x[NA], y[NB];
#pragma unroll
    for (int a = 0; a < NA; ++a) x[a] = ld4(A + a * a_ld + 4 * d4);
#pragma unroll
    for (int b = 0; b < NB; ++b) y[b] = ld4(B + b * b_ld + 4 * d4);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        part[a][b] = fmaf(x[a].x, y[b].x, part[a][b]);
        part[a][b] = fmaf(x[a].y, y[b].y, part[a][b]);
        part[a][b] = fmaf(x[a].z, y[b].z, part[a][b]);
        part[a][b] = fmaf(x[a].w, y[b].w, part[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b)
      acc[a][b] = kSet || kChain ? part[a][b] : acc[a][b] + part[a][b];
}

// acc[a][0..3] = sum over K keys j of A[a][j] * B[j][0..3] (kZero false:
// acc += ...): A rows a_ld floats apart (16-byte loads along j), B rows
// b_ld floats apart (a 16-byte load of four output columns a key).
template <int K, bool kZero = true, int NA>
__device__ __forceinline__ void nn_tile(float (&acc)[NA][4], const float* A,
                                        int a_ld, const float* B, int b_ld) {
  if constexpr (kZero) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = 0.0f;
  }
#pragma unroll
  for (int j4 = 0; j4 < K / 4; ++j4) {
    float4 x[NA], y[4];
#pragma unroll
    for (int a = 0; a < NA; ++a) x[a] = ld4(A + a * a_ld + 4 * j4);
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = ld4(B + (4 * j4 + e) * b_ld);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float p = comp(x[a], e);
        acc[a][0] = fmaf(p, y[e].x, acc[a][0]);
        acc[a][1] = fmaf(p, y[e].y, acc[a][1]);
        acc[a][2] = fmaf(p, y[e].z, acc[a][2]);
        acc[a][3] = fmaf(p, y[e].w, acc[a][3]);
      }
  }
}

// ------------------------------------------------------------------ forward

template <bool kDrop, bool kSegs>
__global__ void __launch_bounds__(kThr, 1)
    flash_fwd_f32_wide_kernel(FwdArgs a, int D, int slices) {
  constexpr int RA = kFwdRA;
  extern __shared__ __align__(16) float sm[];
  float* Ps = sm;
  float* Os = sm + kFwdO;
  const int nc = D / kW;
  const int tiles = gridDim.x / slices;
  const int slice = blockIdx.x % slices;
  // heaviest causal q tiles first
  const int q0 = (tiles - 1 - (int)blockIdx.x / slices) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const int c_lo = slice * nc / slices;
  const int W = ((slice + 1) * nc / slices - c_lo) * kW;
  const Mask<kSegs> mask = mask_of<kSegs>(a, b);
  const float* qg = static_cast<const float*>(a.q) +
                    (long)b * a.Lq * a.q_row + (long)h * D;
  const long kv_base = (long)b * a.Lk * a.kv_row + (long)hk * D;
  const float* kg = static_cast<const float*>(a.k) + kv_base;
  const float* vg = static_cast<const float*>(a.v) + kv_base;
  // lane (ty, tx) of warp w owns q rows r0 + 2a (a < RA) and, of a kv
  // tile, keys 4tx .. 4tx + 3 (of a chunk, O columns 4tx .. 4tx + 3)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 15;
  const int r0 = warp * 2 * RA + (lane >> 4);
  const int kv_end =
      a.causal ? min(mask.len, max(0, q0 + kRows + mask.offset)) : mask.len;
  const int per = nc + W / kW;  // items a kv tile: nc score chunks, V chunks
  const int n_items = (kv_end + kW - 1) / kW * per;

  for (int c = 0; c < W; c += kW)
#pragma unroll
    for (int r = 0; r < RA; ++r)
      st4(Os + (r0 + 2 * r) * W + c + 4 * tx, make_float4(0.f, 0.f, 0.f, 0.f));

  auto issue = [&](int it) {
    float* st = sm + kFwdTile + (it & 1) * kFwdStage;
    const int n0 = it / per * kW, c = it % per;
    if (c < nc) {
      load_tile<kRows, kW, kLd, false>(st, qg, q0, a.Lq, a.q_row, c * kW);
      load_tile<kRows, kW, kLd, true>(st + kFwdTile, kg, n0, a.Lk, a.kv_row,
                                      c * kW);
    } else {
      load_tile<kRows, kW, kLd, false>(st + kFwdTile, vg, n0, a.Lk, a.kv_row,
                                       (c_lo + c - nc) * kW);
    }
    cp_async_commit();
  };

  float m[RA], l[RA], alpha[RA], s[RA][4];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
    alpha[r] = 1.0f;
  }
  if (n_items > 0) issue(0);
  for (int it = 0; it < n_items; ++it) {
    float* st = sm + kFwdTile + (it & 1) * kFwdStage;
    const int n0 = it / per * kW, c = it % per;
    cp_async_wait_all();
    if (c < nc) scale_tile<kW, kLd>(st, a.sm_scale);
    __syncthreads();  // item it landed; item it - 1's stage is free
    if (it + 1 < n_items) issue(it + 1);
    if (c < nc) {
      if (c == 0) {
#pragma unroll
        for (int r = 0; r < RA; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) s[r][k] = 0.0f;
      }
      nt_chunk<kW>(s, st + r0 * kLd, 2 * kLd, st + kFwdTile + tx * kLd,
                   16 * kLd);
      if (c == nc - 1) {
        // online softmax of this kv tile: m, l and alpha per row; P = p *
        // keep into the warp's rows of the P tile
#pragma unroll
        for (int r = 0; r < RA; ++r) {
          const int qrow = q0 + r0 + 2 * r;
          bool vis[4];
          float mx = kNegInf;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            vis[k] = mask(qrow, n0 + 4 * tx + k);
            if (vis[k]) mx = fmaxf(mx, s[r][k]);
          }
#pragma unroll
          for (int o = 1; o < 16; o <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float mn = fmaxf(m[r], mx);
          alpha[r] = expf(m[r] - mn);
          float f[4] = {1.0f, 1.0f, 1.0f, 1.0f};
          if constexpr (kDrop) {
            const uint4 w = keep_words(a.drop, (uint32_t)(n0 + 4 * tx) >> 2,
                                       (uint32_t)qrow, bh, kSaltAttention);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              f[k] = keep_factor(a.drop, word_of(w, k));
          }
          float sum = 0.0f, pv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float p = vis[k] ? expf(s[r][k] - mn) : 0.0f;
            sum += p;  // l from the undropped p
            pv[k] = p * f[k];
          }
#pragma unroll
          for (int o = 1; o < 16; o <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          l[r] = l[r] * alpha[r] + sum;
          m[r] = mn;
          st4(Ps + (r0 + 2 * r) * kLd + 4 * tx,
              make_float4(pv[0], pv[1], pv[2], pv[3]));
        }
        __syncwarp();
      }
    } else {
      // O[:, chunk] = O * alpha + P . V[:, chunk] for this lane's rows
      float acc[RA][4];
      nn_tile<kW>(acc, Ps + r0 * kLd, 2 * kLd, st + kFwdTile + 4 * tx, kLd);
      const int oc = (c - nc) * kW + 4 * tx;
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        float* o = Os + (r0 + 2 * r) * W + oc;
        const float4 old = ld4(o);
        st4(o, make_float4(fmaf(old.x, alpha[r], acc[r][0]),
                           fmaf(old.y, alpha[r], acc[r][1]),
                           fmaf(old.z, alpha[r], acc[r][2]),
                           fmaf(old.w, alpha[r], acc[r][3])));
      }
    }
  }

  // out = O / max(l, 1e-30) (rows with no visible key: 0), lse by slice 0
  float* og = static_cast<float*>(a.out) + (long)b * a.Lq * a.o_row +
              (long)h * D + c_lo * kW;
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int qrow = q0 + r0 + 2 * r;
    if (qrow < a.Lq) {
      const float inv = 1.0f / fmaxf(l[r], 1e-30f);
      for (int c = 0; c < W; c += kW) {
        const float4 o = ld4(Os + (r0 + 2 * r) * W + c + 4 * tx);
        st4(og + (long)qrow * a.o_row + c + 4 * tx,
            make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
      }
      if (slice == 0 && tx == 0)
        a.lse[((long)b * a.H + h) * a.Lq + qrow] =
            m[r] + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

template <bool kDrop, bool kSegs>
cudaError_t launch_fwd(const FwdArgs& a, int B, int D, cudaStream_t stream) {
  if (D % kW) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_f32_wide_kernel<kDrop, kSegs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fwd_smem_bytes(kMaxW));
  if (err != cudaSuccess) return err;
  const int slices = n_slices(D);
  dim3 grid((a.Lq + kRows - 1) / kRows * slices, a.H, B);
  kernel<<<grid, kThr, fwd_smem_bytes(widest_slice(D)), stream>>>(
      a, D, slices);
  return cudaGetLastError();
}

// ------------------------------------------------ forward, heads up to 256

// Layout of the forward up to 256 (floats): Qs [64][ldq], round(q * scale)
// for the whole walk | P [64][kLd] | 2 stages of a K or V chunk [64][kLd],
// with ldq = Dc + 4 for the Dc = ceil(D / 64) * 64 columns of the chunks.
__host__ __device__ constexpr int small_fwd_ldq(int D) {
  return (D + kW - 1) / kW * kW + 4;
}
__host__ __device__ constexpr int small_fwd_smem_bytes(int D) {
  return 4 * (kRows * small_fwd_ldq(D) + 3 * kFwdTile);
}
// CTAs an SM runs at once: two up to D = 128 (86,016 bytes of shared
// memory each at 128; 128 registers a thread), one at 256 (118,784 bytes)
__host__ __device__ constexpr int small_fwd_ctas(int D) {
  return D <= 128 ? 2 : 1;
}
static_assert(small_fwd_smem_bytes(256) <= kSmemMax &&
                  2 * (small_fwd_smem_bytes(128) + 1024) <= 233472,
              "forward tiles exceed shared memory");

// fp32 heads up to 256 (64, 80, 96, 128, 256): the forward above at one
// slice, with D a template argument. Q is copied and scaled once and stays
// in shared memory for the whole walk; O lives in registers (a lane's 4
// rows x 4 columns of each 64-column chunk), rescaled by alpha once a kv
// tile; a kv tile is nc = ceil(D / 64) K chunks, then nc V chunks, through
// the two-stage ring. The scores are one fp32 chain over the head in column
// order (nt_chunk's kChain, continued across the chunks): s is the value
// flash_bwd_f32_kernel recomputes, bit for bit, so p = exp(s - lse) keeps
// this forward's normalisation in the backward. At 80 and 96 the last
// chunk's columns past D are copied as zeros (fmaf(0, 0, s) = s) and never
// written.
template <int D, bool kDrop, bool kSegs>
__global__ void __launch_bounds__(kThr, small_fwd_ctas(D))
    flash_fwd_f32_small_kernel(FwdArgs a) {
  constexpr int RA = kFwdRA;
  constexpr int nc = (D + kW - 1) / kW;  // 64-column chunks of the head
  constexpr int kLdQ = small_fwd_ldq(D);
  constexpr bool kCols = D % kW != 0;
  static_assert(D % 16 == 0 && D <= 256, "a head up to 256");
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Ps = sm + kRows * kLdQ;
  float* ring = Ps + kFwdTile;
  // heaviest causal q tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const uint32_t bh = (uint32_t)(b * a.H + h);
  const Mask<kSegs> mask = mask_of<kSegs>(a, b);
  const float* qg = static_cast<const float*>(a.q) +
                    (long)b * a.Lq * a.q_row + (long)h * D;
  const long kv_base = (long)b * a.Lk * a.kv_row + (long)hk * D;
  const float* kg = static_cast<const float*>(a.k) + kv_base;
  const float* vg = static_cast<const float*>(a.v) + kv_base;
  // lane (ty, tx) of warp w owns q rows r0 + 2a (a < RA) and, of a kv
  // tile, keys 4tx .. 4tx + 3 (of a chunk, O columns 4tx .. 4tx + 3)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 15;
  const int r0 = warp * 2 * RA + (lane >> 4);
  const int kv_end =
      a.causal ? min(mask.len, max(0, q0 + kRows + mask.offset)) : mask.len;
  const int n_tiles = (kv_end + kW - 1) / kW;

  // item c of the kv tile at n0: K chunk c (c < nc), else V chunk c - nc
  auto issue = [&](int n0, int c) {
    float* st = ring + (c & 1) * kFwdTile;
    if (c < nc)
      load_tile<kRows, kW, kLd, true, kCols>(st, kg, n0, a.Lk, a.kv_row,
                                             c * kW, D);
    else
      load_tile<kRows, kW, kLd, false, kCols>(st, vg, n0, a.Lk, a.kv_row,
                                              (c - nc) * kW, D);
    cp_async_commit();
  };

  float m[RA], l[RA], s[RA][4], o[nc][RA][4];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < nc; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][r][e] = 0.0f;
  }
  if (n_tiles > 0) {
    load_tile<kRows, nc * kW, kLdQ, false, kCols>(Qs, qg, q0, a.Lq, a.q_row,
                                                  0, D);
    issue(0, 0);  // one group with Q
    cp_async_wait_all();
    scale_tile<nc * kW, kLdQ>(Qs, a.sm_scale);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * kW;
#pragma unroll
    for (int c = 0; c < 2 * nc; ++c) {
      const float* st = ring + (c & 1) * kFwdTile;
      cp_async_wait_all();
      __syncthreads();  // item c landed (and Q scaled); the other stage free
      if (c + 1 < 2 * nc)
        issue(n0, c + 1);
      else if (t + 1 < n_tiles)
        issue(n0 + kW, 0);
      if (c < nc) {
        if (c == 0) {
#pragma unroll
          for (int r = 0; r < RA; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) s[r][k] = 0.0f;
        }
        nt_chunk<kW, false, true>(s, Qs + r0 * kLdQ + c * kW, 2 * kLdQ,
                                  st + tx * kLd, 16 * kLd);
        if (c == nc - 1) {
          // online softmax of this kv tile: m, l, O *= alpha per row; P =
          // p * keep into the warp's rows of the P tile
#pragma unroll
          for (int r = 0; r < RA; ++r) {
            const int qrow = q0 + r0 + 2 * r;
            bool vis[4];
            float mx = kNegInf;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              vis[k] = mask(qrow, n0 + 4 * tx + k);
              if (vis[k]) mx = fmaxf(mx, s[r][k]);
            }
#pragma unroll
            for (int x = 1; x < 16; x <<= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
            const float mn = fmaxf(m[r], mx);
            const float alpha = expf(m[r] - mn);
            float f[4] = {1.0f, 1.0f, 1.0f, 1.0f};
            if constexpr (kDrop) {
              const uint4 w = keep_words(a.drop, (uint32_t)(n0 + 4 * tx) >> 2,
                                         (uint32_t)qrow, bh, kSaltAttention);
#pragma unroll
              for (int k = 0; k < 4; ++k)
                f[k] = keep_factor(a.drop, word_of(w, k));
            }
            float sum = 0.0f, pv[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float p = vis[k] ? expf(s[r][k] - mn) : 0.0f;
              sum += p;  // l from the undropped p
              pv[k] = p * f[k];
            }
#pragma unroll
            for (int x = 1; x < 16; x <<= 1)
              sum += __shfl_xor_sync(0xffffffffu, sum, x);
            l[r] = l[r] * alpha + sum;
            m[r] = mn;
#pragma unroll
            for (int cc = 0; cc < nc; ++cc)
#pragma unroll
              for (int e = 0; e < 4; ++e) o[cc][r][e] *= alpha;
            st4(Ps + (r0 + 2 * r) * kLd + 4 * tx,
                make_float4(pv[0], pv[1], pv[2], pv[3]));
          }
          __syncwarp();  // the warp reads only its own rows of P
        }
      } else {
        // O[:, chunk] += P . V[:, chunk] for this lane's rows
        nn_tile<kW, false>(o[c >= nc ? c - nc : 0], Ps + r0 * kLd, 2 * kLd,
                           st + 4 * tx, kLd);
      }
    }
  }

  // out = O / max(l, 1e-30) (rows with no visible key: 0) and lse
  float* og = static_cast<float*>(a.out) + (long)b * a.Lq * a.o_row +
              (long)h * D;
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int qrow = q0 + r0 + 2 * r;
    if (qrow < a.Lq) {
      const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < nc; ++c) {
        const int col = c * kW + 4 * tx;
        if (!kCols || col < D)
          st4(og + (long)qrow * a.o_row + col,
              make_float4(o[c][r][0] * inv, o[c][r][1] * inv,
                          o[c][r][2] * inv, o[c][r][3] * inv));
      }
      if (tx == 0)
        a.lse[((long)b * a.H + h) * a.Lq + qrow] =
            m[r] + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

// The fp32 forward at head size D (64, 80, 96, 128 or 256).
template <int D, bool kDrop, bool kSegs>
cudaError_t launch_fwd_small(const FwdArgs& a, int B, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_small_kernel<D, kDrop, kSegs>;
  constexpr int bytes = small_fwd_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Lq + kRows - 1) / kRows, a.H, B);
  kernel<<<grid, kThr, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- backward

// One backward CTA's work (both kernels below): head size D, a multiple of
// 16; the gradient chunks cover ceil(D / 64) * 64 columns and the score
// items ceil(D / 32) * 32, columns past D read as zero and are never
// written. With kChain the scores s and dp are one fp32 chain over the
// head in column order, as flash_fwd_f32_small_kernel sums its scores (D
// <= 256): s then equals the forward's bit for bit, so p = exp(s - lse)
// keeps the forward's normalisation; else each 64-column chunk is summed
// apart, as the wide forward does.
template <bool kDrop, bool kSegs, bool kChain, int SW>
__device__ __forceinline__ void bwd_cta(const BwdArgs& a, int D, int slices,
                                        int split) {
  using Lay = BwdLayout<SW>;
  constexpr int kLd = Lay::kLd;
  static_assert(kChain || SW == kH, "chunk sums pair 32-column items");
  extern __shared__ __align__(16) float sm[];
  float* Ps = sm + Lay::kP;
  float* DSs = sm + Lay::kDS;
  float* Lse = sm + Lay::kLse;
  float* Delta = Lse + kRows;
  float* dKs = sm + Lay::kAcc;
  const int nc = (D + kW - 1) / kW;  // gradient chunks of the head
  const int ns = (D + SW - 1) / SW;  // score items of a step
  const int rank = blockIdx.x % split;  // the CTA's rank in its cluster
  const int slice = blockIdx.x / split % slices;
  const int n0 = (int)blockIdx.x / split / slices * kKeys;  // tile 0 walks most
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.H / a.Hkv;
  const long hd = (long)a.H * D;  // dO and the dq scratch: contiguous rows
  const int c_lo = slice * nc / slices;
  const int W = ((slice + 1) * nc / slices - c_lo) * kW;
  const int Wv = min(W, D - c_lo * kW);  // the slice's columns inside D
  float* dVs = dKs + kKeys * W;
  const Mask<kSegs> mask = mask_of<kSegs>(a, b);
  const long kv_base = (long)b * a.Lk * a.kv_row + (long)hk * D;
  const float* kg = static_cast<const float*>(a.k) + kv_base;
  const float* vg = static_cast<const float*>(a.v) + kv_base;
  const long dkv_base = (long)b * a.Lk * a.dkv_row + (long)hk * D + c_lo * kW;
  float* dk_out = static_cast<float*>(a.dk) + dkv_base;
  float* dv_out = static_cast<float*>(a.dv) + dkv_base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the kv rows of the tile whose dk and dv this CTA writes
  const int w_lo = rank * kKeys / split, w_hi = (rank + 1) * kKeys / split;

  if (n0 >= mask.len) {
    // every key of this tile is past the length: zero dk, dv, no dq
    for (int i = threadIdx.x; i < (w_hi - w_lo) * Wv / 4; i += kThr) {
      const int r = w_lo + i / (Wv / 4), c = 4 * (i % (Wv / 4));
      if (n0 + r < a.Lk) {
        st4(dk_out + (long)(n0 + r) * a.dkv_row + c,
            make_float4(0.f, 0.f, 0.f, 0.f));
        st4(dv_out + (long)(n0 + r) * a.dkv_row + c,
            make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < 2 * kKeys * W / 4; i += kThr)
    st4(dKs + 4 * i, make_float4(0.f, 0.f, 0.f, 0.f));

  // causal: the first q row that sees key n0 is n0 - offset; the walk
  // starts at the q tile holding it. Its steps (q head, q tile) are shared
  // out between the cluster's CTAs.
  const int first = a.causal ? max(0, n0 - mask.offset) : 0;
  const int m_begin = first / kRows * kRows;
  const int nq = max(0, (a.Lq - m_begin + kRows - 1) / kRows);
  const int steps = group * nq;
  const int step0 = rank * steps / split;
  const int per = ns + W / kW;  // score items, then gradient chunks
  const int n_items = ((rank + 1) * steps / split - step0) * per;

  // the item's q head and q tile
  auto head = [&](int it) { return hk * group + (step0 + it / per) / nq; };
  auto tile0 = [&](int it) {
    return m_begin + (step0 + it / per) % nq * kRows;
  };
  auto issue = [&](int it) {
    float* st = sm + (it & 1) * Lay::kStage;
    const int h = head(it), m0 = tile0(it), c = it % per;
    const float* qg = static_cast<const float*>(a.q) +
                      (long)b * a.Lq * a.q_row + (long)h * D;
    const float* dog = static_cast<const float*>(a.dout) +
                       (long)b * a.Lq * hd + (long)h * D;
    if (c < ns) {
      const int col = c * SW;
      load_tile<kRows, SW, kLd, false, true>(st, qg, m0, a.Lq, a.q_row, col,
                                             D);
      load_tile<kKeys, SW, kLd, true, true>(st + kRows * kLd, kg, n0, a.Lk,
                                            a.kv_row, col, D);
      load_tile<kRows, SW, kLd, false, true>(st + (kRows + kKeys) * kLd, dog,
                                             m0, a.Lq, hd, col, D);
      load_tile<kKeys, SW, kLd, true, true>(st + (2 * kRows + kKeys) * kLd,
                                            vg, n0, a.Lk, a.kv_row, col, D);
      if (c == 0 && threadIdx.x < 32) {
        const long pad = ((long)b * a.H + h) * a.Lq_pad + m0;
        const int i = threadIdx.x & 15;
        float* dst = (threadIdx.x < 16 ? Lse : Delta) + 4 * i;
        const float* src = (threadIdx.x < 16 ? a.lse_pad : a.delta) + pad;
        cp_async16(dst, src + 4 * i, 16);
      }
    } else {
      const int col = (c_lo + c - ns) * kW;
      load_tile<kRows, kW, kW, false, true>(st, dog, m0, a.Lq, hd, col, D);
      load_tile<kRows, kW, kW, false, true>(st + kRows * kW, qg, m0, a.Lq,
                                            a.q_row, col, D);
      load_tile<kKeys, kW, kW, false, true>(st + 2 * kRows * kW, kg, n0, a.Lk,
                                            a.kv_row, col, D);
    }
    cp_async_commit();
  };

  // score items: warps 0-3 S = Qs K^T, warps 4-7 dP = dO V^T; lane (ty,
  // tx) of warp w owns q rows 16 (w % 4) + ty + 4a and keys 4tx .. 4tx + 3
  const bool dp_warp = warp >= 4;
  const int rs = 16 * (warp & 3) + (lane >> 3);
  const int ks = lane & 7;
  float sd[4][4];  // s (warps 0-3) or dp (warps 4-7) of the step
  float half[4][4];  // the 64-column chunk's sum, over two score items
  if (n_items > 0) issue(0);
  for (int it = 0; it < n_items; ++it) {
    float* st = sm + (it & 1) * Lay::kStage;
    const int c = it % per;
    cp_async_wait_all();
    if (c < ns) scale_tile<SW, kLd>(st, a.sm_scale);
    __syncthreads();  // item it landed; item it - 1's stage is free
    if (c == ns) {
      // p and dS of the step from s (this lane's registers, warps 0-3) and
      // dp (written by warps 4-7), in place of dp
      if (!dp_warp) {
        const int h = head(it), m0 = tile0(it);
        const uint32_t bh = (uint32_t)(b * a.H + h);
        const int key0 = n0 + 4 * ks;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = rs + 4 * r, qrow = m0 + row;
          const float lse = Lse[row], dl = Delta[row];
          const float4 dp4 = ld4(DSs + row * kLdP + 4 * ks);
          float f[4] = {1.0f, 1.0f, 1.0f, 1.0f};
          if constexpr (kDrop) {
            const uint4 w = keep_words(a.drop, (uint32_t)key0 >> 2,
                                       (uint32_t)qrow, bh, kSaltAttention);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              f[k] = keep_factor(a.drop, word_of(w, k));
          }
          float pv[4], dsv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float p =
                mask(qrow, key0 + k) ? expf(sd[r][k] - lse) : 0.0f;
            pv[k] = p * f[k];
            dsv[k] = p * (comp(dp4, k) * f[k] - dl);
          }
          st4(Ps + row * kLdP + 4 * ks,
              make_float4(pv[0], pv[1], pv[2], pv[3]));
          st4(DSs + row * kLdP + 4 * ks,
              make_float4(dsv[0], dsv[1], dsv[2], dsv[3]));
        }
      }
      __syncthreads();  // P and dS of the step written
    }
    if (it + 1 < n_items) issue(it + 1);
    if (c < ns) {
      if (c == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) sd[r][k] = 0.0f;
      }
      const float* A = st + (dp_warp ? (kRows + kKeys) * kLd : 0);
      const float* Bt = st + (dp_warp ? 2 * kRows + kKeys : kRows) * kLd;
      if constexpr (kChain) {
        nt_chunk<SW, false, true>(sd, A + rs * kLd, 4 * kLd, Bt + ks * kLd,
                                  8 * kLd);
      } else {
        if (c % 2 == 0)
          nt_chunk<SW, true>(half, A + rs * kLd, 4 * kLd, Bt + ks * kLd,
                             8 * kLd);
        else
          nt_chunk<SW>(half, A + rs * kLd, 4 * kLd, Bt + ks * kLd, 8 * kLd);
        if (c % 2 == 1) {  // a 64-column chunk's sum
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) sd[r][k] += half[r][k];
        }
      }
      if (c == ns - 1 && dp_warp) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          st4(DSs + (rs + 4 * r) * kLdP + 4 * ks,
              make_float4(sd[r][0], sd[r][1], sd[r][2], sd[r][3]));
      }
    } else {
      const int m0 = tile0(it);
      const int cc = (c - ns) * kW;  // the chunk's columns in the slice
      if (warp < 4) {
        // dV += P^T dO (warps 0-1), dK += dS^T q (warps 2-3): lane t of
        // the pair owns kv rows 8 (t / 16) + {0..7} and chunk columns
        // 4 (t % 16) + {0..3}
        const bool dk = warp >= 2;
        const int t = threadIdx.x & 63;
        const int j0 = 8 * (t >> 4), d0 = 4 * (t & 15);
        const float* A = (dk ? DSs : Ps) + j0;
        const float* Bm = st + (dk ? kRows * kW : 0) + d0;
        float acc[8][4];
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[e][f] = 0.0f;
#pragma unroll 8
        for (int i = 0; i < kRows; ++i) {
          const float4 x0 = ld4(A + i * kLdP), x1 = ld4(A + i * kLdP + 4);
          const float4 y = ld4(Bm + i * kW);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float p = e < 4 ? comp(x0, e) : comp(x1, e - 4);
            acc[e][0] = fmaf(p, y.x, acc[e][0]);
            acc[e][1] = fmaf(p, y.y, acc[e][1]);
            acc[e][2] = fmaf(p, y.z, acc[e][2]);
            acc[e][3] = fmaf(p, y.w, acc[e][3]);
          }
        }
        float* g = (dk ? dKs : dVs) + j0 * W + cc + d0;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          st4(g + e * W, add4(ld4(g + e * W),
                              make_float4(acc[e][0], acc[e][1], acc[e][2],
                                          acc[e][3])));
      } else {
        // dQ partial = dS K[:, chunk] (warps 4-7): lane (ty, tx) of warp w
        // owns q rows 16 (w - 4) + ty + 2a and columns 4tx .. 4tx + 3,
        // added to dq's scratch (unscaled; the conversion scales)
        const int r0 = 16 * (warp - 4) + (lane >> 4);
        const int tx = lane & 15;
        float acc[8][4];
        nn_tile<kKeys>(acc, DSs + r0 * kLdP, 2 * kLdP,
                       st + 2 * kRows * kW + 4 * tx, kW);
        const int h = head(it);
        const int col = c_lo * kW + cc + 4 * tx;
        float* dqg = a.dq_acc + (long)b * a.Lq * hd + (long)h * D + col;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int qrow = m0 + r0 + 2 * r;
          if (qrow < a.Lq && col < D)
            red_add4(dqg + (long)qrow * hd,
                     make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
        }
      }
    }
  }

  // dk (scaled once) and dv: the sums over the cluster's CTAs, taken in
  // rank order (so the same inputs give the same bits), of this CTA's rows
  __syncthreads();
  if (split > 1) cluster_sync();  // every CTA's dK, dV final
  for (int i = threadIdx.x; i < (w_hi - w_lo) * Wv / 4; i += kThr) {
    const int r = w_lo + i / (Wv / 4), c = 4 * (i % (Wv / 4));
    if (n0 + r < a.Lk) {
      float4 k4 = ld4(dKs + r * W + c), v4 = ld4(dVs + r * W + c);
      if (split > 1) {
        k4 = v4 = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < split; ++q) {
          k4 = add4(k4, ld4_cluster(dKs + r * W + c, q));
          v4 = add4(v4, ld4_cluster(dVs + r * W + c, q));
        }
      }
      st4(dk_out + (long)(n0 + r) * a.dkv_row + c,
          make_float4(k4.x * a.sm_scale, k4.y * a.sm_scale,
                      k4.z * a.sm_scale, k4.w * a.sm_scale));
      st4(dv_out + (long)(n0 + r) * a.dkv_row + c, v4);
    }
  }
  if (split > 1) cluster_sync();  // no CTA leaves while its rows are read
}

// fp32 heads above 256 (multiples of 64).
template <bool kDrop, bool kSegs>
__global__ void __launch_bounds__(kThr, 1)
    flash_bwd_f32_wide_kernel(BwdArgs a, int D, int slices, int split) {
  bwd_cta<kDrop, kSegs, false, kH>(a, D, slices, split);
}

// fp32 heads up to 256 (64, 80, 96, 128, 256: one slice), score items of
// SW = small_sw(D) columns.
template <int SW, bool kDrop, bool kSegs>
__global__ void __launch_bounds__(kThr, 1)
    flash_bwd_f32_kernel(BwdArgs a, int D, int slices, int split) {
  bwd_cta<kDrop, kSegs, true, SW>(a, D, slices, split);
}

// The fp32 backward body at head size D: a multiple of 16 up to 256
// (flash_bwd_f32_kernel) or of 64 above (flash_bwd_f32_wide_kernel).
template <bool kDrop, bool kSegs>
cudaError_t launch_bwd(const BwdArgs& a, int B, int D, cudaStream_t stream) {
  if (D <= 0 || D % (D > 256 ? kW : 16)) return cudaErrorInvalidValue;
  const bool wide = D > 256, sw64 = !wide && small_sw(D) == kW;
  auto kernel = wide   ? flash_bwd_f32_wide_kernel<kDrop, kSegs>
                : sw64 ? flash_bwd_f32_kernel<kW, kDrop, kSegs>
                       : flash_bwd_f32_kernel<kH, kDrop, kSegs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sw64 ? BwdLayout<kW>::bytes(256) : BwdLayout<kH>::bytes(kMaxW));
  if (err != cudaSuccess) return err;
  // a cluster of `split` CTAs shares out a kv tile's walk when the longest
  // walk (kv tile 0: every q tile of the group's heads) has at least 8
  // steps a CTA: causal walks differ by up to Lq / 64 steps, and the
  // longest one sets the launch's time
  const int Dg = (D + kW - 1) / kW * kW;  // the gradient chunks' columns
  const int slices = n_slices(Dg);
  const int tiles = (a.Lk + kKeys - 1) / kKeys * slices;
  const int longest = a.H / a.Hkv * ((a.Lq + kRows - 1) / kRows);
  int split = 1;
  while (split < kMaxSplit && longest >= 16 * split) split *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * split, a.Hkv, B);
  cfg.blockDim = dim3(kThr);
  cfg.dynamicSmemBytes = sw64 ? BwdLayout<kW>::bytes(Dg)
                              : BwdLayout<kH>::bytes(widest_slice(Dg));
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a, D, slices, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace f32w
}  // namespace
