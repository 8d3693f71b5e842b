"""The flash backwards' ordered dq sum (paddle_tpu_torch.kernels.dq_sum,
``csrc/dq_sum.cu`` and ``csrc/dq_parts.cuh``) on the CPU.

Every backward body stores dq's partials a kv tile apart and the ordered
sum adds the slabs that hold a row's partials in kv-tile order. Here:

* ``parts_of_rows`` (the closed form the kernel and its plain version
  read) equals the rows each body's walk writes, walked out tile by tile
  as the CUDA bodies walk them (the early exit past a length, the causal
  start at the q tile of the first visible row), for every body's part
  geometry, with lengths and Lq != Lk;
* slabs filled with each kv tile's dq partials, NaN wherever no body
  writes, sum to the JAX package's dq (jax.vjp of ``flash_attention_blhd``
  in interpret mode, as tests/test_torch_flash_attention.py holds the
  plain backward), with GQA, lengths and the causal band: no unwritten
  element is ever read;
* the plain version adds in part order from 0.0, scales in fp32 and
  rounds once, and the wrapper writes it into a strided column slice (the
  packed layout's dq) counting no launch on the CPU.

The kernel itself is held to its plain version bit for bit by the
``cuda``-marked test and by chip_smoke.py's [bwd-order].
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.flash_attention import flash_attention_blhd
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels.dq_sum import (dq_ordered_sum,
                                             dq_ordered_sum_reference,
                                             dq_parts, dq_parts_geometry,
                                             parts_of_rows)
from paddle_tpu_torch.kernels.flash_pair import bwd_work_floats

# (dtype, head size): the bf16 Hopper body at 64 (two parts a tile) and
# 128, the wide body at 256, the fp32 body (32-key tiles)
BODIES = [(torch.bfloat16, 64), (torch.bfloat16, 128),
          (torch.bfloat16, 256), (torch.float32, 64)]


def _walked(b, lq, lk, causal, kv_tile, per_tile, lens):
    """``[P, B, Lq]`` bool: which slab rows the bodies write, walked out as
    the CUDA bodies walk: a tile starting at or past the row's length
    exits first; a causal tile starts at the 64-row q tile holding its
    first visible row, min(first / 64, last q tile), and walks to the
    end."""
    tiles = -(-lk // kv_tile)
    out = np.zeros((tiles * per_tile, b, lq), bool)
    n_qt = -(-lq // 64)
    for bi in range(b):
        length = lk if lens is None else max(0, min(lk, lens[bi]))
        for j in range(tiles):
            n0 = j * kv_tile
            if n0 >= length:
                continue
            first = max(0, n0 - (lk - lq)) if causal else 0
            mt0 = min(first // 64, n_qt - 1)
            for g in range(per_tile):
                out[j * per_tile + g, bi, mt0 * 64:] = True
    return out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 200, 300), (2, 300, 200),
                                   (1, 256, 256)])
@pytest.mark.parametrize("body", BODIES,
                         ids=["bf16-64", "bf16-128", "bf16-256", "fp32"])
def test_parts_of_rows_follow_the_bodies_walks(body, shape, causal):
    dtype, d = body
    b, lq, lk = shape
    kv_tile, per_tile = dq_parts_geometry(d, dtype)
    assert dq_parts(lk, d, dtype) == -(-lk // kv_tile) * per_tile
    for lens in (None, [lk, max(1, lk // 3)][:b], [0, lk][:b]):
        walked = _walked(b, lq, lk, causal, kv_tile, per_tile, lens)
        n = parts_of_rows(b, lq, lk, causal, kv_tile, per_tile,
                          None if lens is None else torch.tensor(lens))
        prefix = np.arange(walked.shape[0])[:, None, None] < \
            n.numpy()[None]
        np.testing.assert_array_equal(walked, prefix)


def _partials(q, k, v, g, causal, lens, kv_tile, per_tile):
    """The bodies' slabs on the CPU: each part's dq contribution ds.K
    (unscaled, over its keys) in fp32 where its body writes, NaN
    elsewhere; ds from the plain backward's math."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf = q.transpose(1, 2)
    kf = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    vf = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    s = (qf * scale) @ kf.transpose(-1, -2)
    keys = torch.arange(lk)
    valid = torch.ones(b, 1, lq, lk, dtype=torch.bool)
    if lens is not None:
        valid = valid & (keys[None, None, None, :]
                         < torch.tensor(lens)[:, None, None, None])
    if causal:
        valid = valid & (keys[None, :] <= torch.arange(lq)[:, None]
                         + (lk - lq))
    s = torch.where(valid, s, -1e30)
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
    do = g.transpose(1, 2)
    dp = do @ vf.transpose(-1, -2)
    o = p @ vf
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    walked = torch.from_numpy(_walked(b, lq, lk, causal, kv_tile, per_tile,
                                      lens))
    slabs = torch.full((walked.shape[0], b, lq, h * d), float("nan"))
    rows = kv_tile // per_tile
    for part in range(walked.shape[0]):
        k0 = part * rows
        dq = ds[..., k0:k0 + rows] @ kf[..., k0:k0 + rows, :]   # [b,h,lq,d]
        dq = dq.transpose(1, 2).reshape(b, lq, h * d)
        slabs[part] = torch.where(walked[part][..., None], dq, slabs[part])
    return slabs


@pytest.mark.parametrize("case", [
    (torch.bfloat16, 64, True, None, 256, 256),
    (torch.bfloat16, 64, True, [256, 100], 128, 256),
    (torch.bfloat16, 128, False, [100, 256], 256, 256),
    (torch.float32, 64, True, [256, 90], 256, 128)],
    ids=["bf16-64-causal", "bf16-64-lens-128x256", "bf16-128-lens",
         "fp32-lens-256x128"])
def test_ordered_sum_of_tile_partials_matches_jax_dq(case):
    """Slabs of per-part partials (NaN where no body writes) summed by the
    ordered sum (the plain version, in fp32 for the comparison) give the
    JAX package's dq, GQA 4/2."""
    geometry_dtype, d, causal, lens, lq, lk = case
    kv_tile, per_tile = dq_parts_geometry(d, geometry_dtype)
    b, h, hkv = 2, 4, 2
    rs = np.random.RandomState(d + lq + lk)
    q = (rs.randn(b, lq, h, d) * 1.5).astype(np.float32)
    k = (rs.randn(b, lk, hkv, d) * 1.5).astype(np.float32)
    v = rs.randn(b, lk, hkv, d).astype(np.float32)
    g = rs.randn(b, lq, h, d).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, bb, c: flash_attention_blhd(
            a, bb, c, causal=causal, block_q=128, block_k=128,
            interpret=True,
            kv_lens=None if lens is None else jnp.asarray(lens, jnp.int32)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    slabs = _partials(*(torch.from_numpy(x) for x in (q, k, v, g)), causal,
                      lens, kv_tile, per_tile)
    assert torch.isnan(slabs).any() or lens is None
    dq = dq_ordered_sum_reference(
        slabs, lk, causal, kv_tile, per_tile, 1.0 / math.sqrt(d),
        torch.float32, None if lens is None else torch.tensor(lens))
    assert not torch.isnan(dq).any()
    np.testing.assert_allclose(dq.numpy().reshape(b, lq, h, d), want,
                               atol=1e-4, rtol=1e-4)


def test_plain_sum_order_and_strided_output():
    """0.0 plus the row's slabs in part order, times the scale in fp32,
    rounded once: the sequential fp32 chain, not a pairwise tree; the
    wrapper writes it into the dq columns of a packed [B, L, 3*hd]
    gradient and leaves the rest; CPU tensors count no launch."""
    rs = np.random.RandomState(0)
    b, lq, lk, hd = 2, 96, 160, 8
    kv_tile, per_tile = 32, 1
    n = dq_parts(lk, 64, torch.float32)
    # slabs of two magnitudes, so that another order of the adds would
    # round otherwise
    scale = np.where(rs.rand(n, 1, 1, 1) < 0.5, 1.0, 1e4)
    parts = torch.from_numpy((rs.randn(n, b, lq, hd) * scale)
                             .astype(np.float32))
    lens = torch.tensor([lk, 70], dtype=torch.int32)
    rows = parts_of_rows(b, lq, lk, True, kv_tile, per_tile, lens)
    want = np.zeros((b, lq, hd), np.float32)
    for bi in range(b):
        for r in range(lq):
            acc = np.zeros(hd, np.float32)
            for p in range(int(rows[bi, r])):
                acc = acc + parts[p, bi, r].numpy()
            want[bi, r] = acc * np.float32(0.125)
    packed = torch.full((b, lq, 3 * hd), 7.0)
    reset_launch_counts()
    dq_ordered_sum(parts, packed[..., :hd], lk, True, kv_tile, per_tile,
                   0.125, lens)
    assert launch_counts()["dq_ordered_sum"] == 0
    np.testing.assert_array_equal(packed[..., :hd].numpy(), want)
    assert torch.equal(packed[..., hd:], torch.full((b, lq, 2 * hd), 7.0))
    bf16 = dq_ordered_sum_reference(parts, lk, True, kv_tile, per_tile,
                                    0.125, torch.bfloat16, lens)
    assert torch.equal(bf16, torch.from_numpy(want).to(torch.bfloat16))
    rows_apart = torch.zeros(lq, b, 3 * hd)[..., :hd].transpose(0, 1)
    with pytest.raises(ValueError, match="evenly spaced"):
        dq_ordered_sum(parts, rows_apart, lk, True, kv_tile, per_tile, 0.125)


def test_backward_workspace_holds_the_slabs():
    """The wrappers' workspace starts with the slabs dq_ordered_sum reads
    (``dq_parts`` of them), then lse and delta."""
    for dtype, d in BODIES:
        parts = dq_parts(300, d, dtype)
        assert bwd_work_floats(2, 200, 300, 4, d, dtype) >= \
            parts * 2 * 200 * 4 * d + 2 * 2 * 4 * 256


@pytest.mark.cuda
@pytest.mark.parametrize("body", BODIES,
                         ids=["bf16-64", "bf16-128", "bf16-256", "fp32"])
def test_cuda_ordered_sum_matches_plain_bitwise(body):
    """The kernel against its plain version on random slabs, bit for bit,
    causal with lengths and Lq != Lk, into a strided dq."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dtype, d = body
    b, lq, lk, h = 2, 300, 400, 2
    kv_tile, per_tile = dq_parts_geometry(d, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(d)
    parts = torch.randn(dq_parts(lk, d, dtype), b, lq, h * d, device="cuda",
                        generator=gen)
    lens = torch.tensor([lk, 123], dtype=torch.int32, device="cuda")
    packed = torch.zeros(b, lq, 3 * h * d, dtype=dtype, device="cuda")
    reset_launch_counts()
    got = dq_ordered_sum(parts, packed[..., :h * d], lk, True, kv_tile,
                         per_tile, 0.125, lens)
    torch.cuda.synchronize()
    assert launch_counts()["dq_ordered_sum"] == 1
    want = dq_ordered_sum_reference(parts, lk, True, kv_tile, per_tile,
                                    0.125, dtype, lens)
    assert torch.equal(got, want)
