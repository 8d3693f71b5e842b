// dq in a fixed order: where each backward body puts its dq partials, and
// which of them hold a q row's. Included by flash_attention.cuh (the
// bodies and the workspace) and dq_sum.cu (the ordered sum), so both read
// one rule; kernels/dq_sum.py `dq_parts_geometry` and `parts_of_rows`
// mirror it for the wrappers and the plain version.
//
// A part is a kv tile of the body (128 kv rows in bf16, 32 in fp32) or,
// in the bf16 body at D = 64, 80 and 96, one consumer warpgroup's 64 rows
// of a tile (the two warpgroups of one CTA then cover the same dq rows).
// Part p writes its contribution to every dq element it reaches into slab
// p of the workspace, [parts, B, Lq, H*D] fp32, with plain stores: no
// element of a slab is written twice. The ordered sum then adds, for each
// dq element, slabs 0, 1, ..., n - 1 in that order from 0.0f, so dq does
// not depend on which CTA finished first. The Pallas kernels' sequential
// grid sums dq over the kv tiles in the same order
// (paddle_tpu/kernels/pallas/flash_pair.py `_pair_bwd_fused_kernel`).
//
// Which parts hold row r of batch row b: a tile starting at or past the
// row's key length writes nothing (its CTA exits first), and a causal CTA
// walks the 64-row q tiles from the one holding its first visible row
// (n0 - (Lk - Lq)) down, so tile j reaches q tile r / 64 iff
// j * kv_tile < (r / 64 + 1) * 64 + Lk - Lq. Both conditions keep a prefix
// of the tiles. Slab rows outside those prefixes are never written and
// never read.

#pragma once

namespace {

constexpr int kDqRowsQ = 64;  // q rows of a backward step, in every body

struct DqParts {
  int kv_tile;   // kv rows of a body's tile
  int per_tile;  // parts a tile (two consumer warpgroups, or one part)
};

// The part geometry of the body that runs a backward of head size D.
__host__ __device__ inline DqParts dq_parts_geometry(int D, int is_bf16) {
  if (!is_bf16) return DqParts{32, 1};
  return DqParts{128, (D == 64 || D == 80 || D == 96) ? 2 : 1};
}

// The slabs of a backward over Lk keys.
__host__ __device__ inline long dq_parts(int Lk, int D, int is_bf16) {
  const DqParts g = dq_parts_geometry(D, is_bf16);
  return (long)((Lk + g.kv_tile - 1) / g.kv_tile) * g.per_tile;
}

// How many of the first slabs hold q row r's partials; len is the batch
// row's key length (Lk without lengths, clamped to [0, Lk]).
__host__ __device__ inline int dq_parts_of_row(int r, int len, int Lq,
                                               int Lk, int causal,
                                               DqParts g) {
  int tiles = (len + g.kv_tile - 1) / g.kv_tile;
  if (causal) {
    const long reach = (long)(r / kDqRowsQ + 1) * kDqRowsQ + (Lk - Lq);
    const int t =
        reach <= 0 ? 0 : (int)((reach + g.kv_tile - 1) / g.kv_tile);
    tiles = tiles < t ? tiles : t;
  }
  return tiles * g.per_tile;
}

}  // namespace
