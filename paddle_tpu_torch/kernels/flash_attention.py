"""Flash attention on the ``[B, L, H, D]`` layout, with grouped-query
attention, per-sequence key lengths, segment ids and in-kernel dropout (the
"flat" path), and packed-qkv attention for heads of 128.

Counterpart of ``paddle_tpu/kernels/pallas/flash_attention.py``
(``flash_attention_blhd`` and ``flash_attention_qkv_packed``). Two kernels,
CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use and bound with
``ctypes``:

* ``flash_attention_fwd(q, k, v, causal)`` (``csrc/flash_attention_fwd.cu``)
  takes queries ``[B, Lq, H, D]`` and keys/values ``[B, Lk, Hkv, D]``
  (``H`` a multiple of ``Hkv``: q head ``h`` reads KV head ``h // (H /
  Hkv)``, as ``_kv_map`` folds them) and returns the context ``[B, Lq, H,
  D]`` in the input type and the per-row log-sum-exp ``[B, H, Lq]`` in
  fp32. The causal diagonal is aligned bottom-right (key ``j`` is visible
  to query ``i`` when ``j <= i + Lk - Lq``); a row with no visible key
  gives 0.
* ``flash_attention_bwd(q, k, v, out, lse, dout, causal)``
  (``csrc/flash_attention_bwd.cu``) returns ``(dq, dk, dv)`` in the
  inputs' layouts: the job of the Pallas fused, dq and dkv kernels, with
  each KV head's gradient summed over its group of q heads in fp32.

Every head size runs: 64, 80, 96, 128 and 256 are built, and above 256
every multiple of 64; any other size runs at the next built one on
zero-padded heads (``kernel_head_dim``), as the JAX ``flash_attention_blhd``
takes any head size. In bf16 the kernels are Hopper ones: the forward
``csrc/flash_fwd_sm90.cuh`` up to 256 and ``csrc/flash_wide_sm90.cuh``
above; the backward ``csrc/flash_bwd_sm90.cuh`` at 64, 80, 96 and 128
(80 and 96 on 32-byte swizzle blocks), ``csrc/flash_wide_sm90.cuh`` at 256
and above. In fp32 the forward is a SIMT kernel (``csrc/
flash_attention.cuh``) up to 256, and every other fp32 body is an FFMA
micro-tile kernel of ``csrc/flash_f32_wide.cuh``.
``csrc/flash_attention.cuh``'s header table says which body runs where.

Both take the masks of the Pallas ``_valid_mask``: ``kv_lens`` ``[B]``
(key ``j`` of batch row ``b`` is attended only below ``kv_lens[b]``;
queries past it still attend the valid keys, an additive padding mask's
semantics) and ``q_segments`` / ``kv_segments`` ``[B, Lq]`` / ``[B, Lk]``
(only pairs of one segment attend), and drop the probabilities at
``dropout_rate`` under ``seed`` with the mask of ``philox.attention_keep``
keyed on (b, q head, q position, key position): the pair kernels' mask, so
a padded batch at full lengths drops what the packed path drops.

``flash_attention_qkv_packed(qkv, num_heads)`` (row 6: the Pallas
``_flash_fwd_packed`` / ``_flash_bwd_packed``) takes the fused projection
output ``[B, L, 3*H*D]`` with ``D % 128 == 0``: the pair kernels' layout,
so it runs them (``flash_pair.FlashPairPacked``), which compute the same
function there.

``FlashAttention`` ties the two kernels together under autograd. On a
CUDA tensor a wrapper launches its kernel; on a CPU tensor it computes its
``_reference``, the same math in plain torch. There is no other path:
anything the kernels do not take raises.

While the monitor counts a call's FLOPs each wrapper reports its score and
context products over the (query, key) pairs its masks leave visible
(``_report``), as ``flash_pair`` does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..monitor import goodput as _goodput
from . import _build, philox
from .flash_pair import (FlashPairPacked, bwd_work_floats, count_bodies,
                         sum_dq,
                         fwd_work_floats)

__all__ = ["flash_attention_fwd", "flash_attention_fwd_reference",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "FlashAttention", "flash_attention_qkv_packed"]

_NEG_INF = -1e30
_DTYPES = (torch.bfloat16, torch.float32)
# head sizes up to 256 the kernels are built for (csrc/flash_attention.cuh
# FlatHeadDims); above 256 every multiple of 64 is built (bf16: the wide
# kernels of csrc/flash_wide_sm90.cuh; fp32: csrc/flash_f32_wide.cuh). Any
# other size runs at the next built one with zero columns.
_HEAD_DIMS = (64, 80, 96, 128, 256)
_BIG_D_QUANTUM = 64


def kernel_head_dim(d: int) -> int:
    """The head size a head of ``d`` runs at on the card: the smallest
    built size that holds it (``d`` itself when it is built): one of
    ``_HEAD_DIMS`` up to 256, the next multiple of 64 above. Zero columns
    add exact zeros to q.k and give zero output columns, which are sliced
    off."""
    if d > _HEAD_DIMS[-1]:
        return -(-d // _BIG_D_QUANTUM) * _BIG_D_QUANTUM
    return next(k for k in _HEAD_DIMS if k >= d)


def pad_head_dim(x, d: int):
    """``x [..., D]`` with zero columns up to ``d`` (``x`` itself when
    ``D == d``), contiguous."""
    return x if x.shape[-1] == d else \
        torch.nn.functional.pad(x, (0, d - x.shape[-1])).contiguous()


def _check_rate(who, dropout_rate, seed):
    if not 0.0 <= float(dropout_rate) < 1.0:
        raise ValueError(f"{who}: dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError(f"{who}: dropout_rate > 0 needs a seed "
                         f"(core.random.next_seed)")


def _compute_type(dt):
    """fp32 for the kernels' types; fp64 stays fp64 (the plain versions
    take it, as an exact oracle)."""
    return torch.promote_types(dt, torch.float32)


def _check(q, k, v, dropout_rate=0.0, seed=None, block_q=None, block_k=None,
           who="flash_attention_fwd", plain=False):
    """Validate the forward's inputs (``plain``: the plain versions', which
    also take fp64); returns ``(B, Lq, Lk, H, Hkv, D)``."""
    _check_rate(who, dropout_rate, seed)
    if block_q is not None or block_k is not None:
        raise NotImplementedError(
            f"{who}: the block sizes are the kernel's own; a measured block "
            f"choice (the JAX package's _tuned_blocks) is not ported yet "
            f"(ROADMAP Queue 2, support code)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{who}: q, k, v must be [B, L, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, lq, h, d = q.shape
    _, lk, hkv, _ = k.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"{who}: k and v must be [B, Lk, Hkv, D] with q's "
                         f"B and D, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if h % hkv:
        raise ValueError(f"{who}: {h} query heads are not a multiple of "
                         f"{hkv} key/value heads")
    if d < 1:
        raise ValueError(f"{who}: empty head (head_dim {d})")
    types = _DTYPES + ((torch.float64,) if plain else ())
    if q.dtype not in types or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{who}: q, k, v must share one dtype of bfloat16 "
                        f"or float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{who}: q, k and v must be contiguous")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"{who}: q, k and v must be on one device")
    if lq < 1 or lk < 1:
        raise ValueError(f"{who}: empty sequence (Lq={lq}, Lk={lk})")
    return b, lq, lk, h, hkv, d


def _masks(b, lq, lk, device, kv_lens, q_segments, kv_segments,
           who="flash_attention_fwd"):
    """The structured masks as the kernels read them: ``(lens [B],
    q_segments [B, Lq], kv_segments [B, Lk])``, each int32, contiguous, on
    ``device``, or None (the JAX ``flash_attention_blhd`` casts them the
    same way). Segments come in pairs."""
    if (q_segments is None) != (kv_segments is None):
        raise ValueError(f"{who}: q_segments and kv_segments must be given "
                         f"together")

    def as_int32(x, shape, name):
        t = torch.as_tensor(x, device=device).to(torch.int32).contiguous()
        if tuple(t.shape) != shape:
            raise ValueError(f"{who}: {name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        return t

    lens = None if kv_lens is None else as_int32(kv_lens, (b,), "kv_lens")
    if q_segments is None:
        return lens, None, None
    return (lens, as_int32(q_segments, (b, lq), "q_segments"),
            as_int32(kv_segments, (b, lk), "kv_segments"))


def _scale(d, sm_scale):
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _heads_first(x, group):
    """``[B, L, Hx, D]`` -> ``[B, Hx * group, L, D]`` in the compute type,
    each head repeated ``group`` times in place (q head ``h`` reads KV head
    ``h // group``)."""
    return x.to(_compute_type(x.dtype)).transpose(1, 2) \
        .repeat_interleave(group, dim=1)


def _visible(lq, lk, causal, device, lens=None, q_seg=None, kv_seg=None):
    """Mask of the (query, key) pairs attended, ``[Lq, Lk]`` or, with
    lengths or segments, ``[B, 1, Lq, Lk]``: all, or the
    bottom-right-aligned causal band ``j <= i + Lk - Lq``; keys below
    ``lens[b]``; pairs of one segment."""
    valid = torch.ones(lq, lk, dtype=torch.bool, device=device)
    if causal:
        valid = valid.tril(lk - lq)
    if lens is not None:
        cols = torch.arange(lk, device=device)
        valid = valid & (cols < lens.long()[:, None])[:, None, None, :]
    if q_seg is not None:
        valid = valid & (q_seg[:, :, None] == kv_seg[:, None, :])[:, None]
    return valid


def _report(b, lq, lk, h, d, causal, masks, device, backward=False):
    """Into the open FLOP count: one launch's attention products over
    the visible pairs (the masks' pairs summed: data-dependent, so read
    from the device, only while a count is open)."""
    if any(m is not None for m in masks):
        pairs_total = int(_visible(lq, lk, causal, device, *masks).sum())
        pairs, b = pairs_total, 1
    else:
        pairs = _goodput.causal_pairs(lq, lk) if causal else lq * lk
    _goodput.kernel_flops(_goodput.attention_flops(b, h, pairs, d,
                                                   backward))


def _keep_factor(b, h, lq, lk, dropout_rate, seed, device):
    """``[B, H, Lq, Lk]`` fp32 factor of each pair: ``keep_scale`` where the
    Philox word keeps it, 0 where it drops (None at rate 0)."""
    if dropout_rate <= 0.0:
        return None
    keep = philox.attention_keep(seed, b, h, lq, lk, dropout_rate, device)
    return torch.where(keep, philox.keep_scale(dropout_rate), 0.0)


def flash_attention_fwd_reference(q, k, v, causal: bool, sm_scale=None,
                                  dropout_rate: float = 0.0, *, seed=None,
                                  kv_lens=None, q_segments=None,
                                  kv_segments=None):
    """The kernel's math in fp32 torch: q * scale rounded to the input type
    before Q.K^T, the masked pairs at -1e30, ``l`` summed over the
    undropped probabilities, then each probability times its keep factor
    (dropout), rounded to v's type before P.V, and the final ``acc / max(l,
    1e-30)``, so a row with no visible key gives 0 and its lse is -1e30.
    Returns ``(out [B, Lq, H, D] in q's type, lse [B, H, Lq] fp32)``. Takes
    fp64 too (computed in fp64, lse fp64), as an exact oracle."""
    b, lq, lk, h, hkv, d = _check(q, k, v, dropout_rate, seed, plain=True)
    masks = _masks(b, lq, lk, q.device, kv_lens, q_segments, kv_segments)
    dt = q.dtype
    ct = _compute_type(dt)
    scale = _scale(d, sm_scale)
    qs = (q.to(ct) * scale).to(dt).to(ct).transpose(1, 2)     # [b,h,lq,d]
    kf = _heads_first(k, h // hkv)
    vf = _heads_first(v, h // hkv)
    valid = _visible(lq, lk, causal, q.device, *masks)
    s = torch.where(valid, qs @ kf.transpose(-1, -2), _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    f = _keep_factor(b, h, lq, lk, dropout_rate, seed, q.device)
    if f is not None:
        p = p * f
    o = (p.to(dt).to(ct) @ vf) / l
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).to(dt).contiguous(), lse


_FWD_ARGTYPES = (*(ctypes.c_void_p,) * 9, *(ctypes.c_int,) * 8,
                 ctypes.c_float, *philox.KERNEL_ARGTYPES, ctypes.c_void_p)


def _check_aligned(who, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{who}: inputs must be 16-byte aligned (the kernels "
                         f"read them with TMA and in 16-byte vectors)")


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention_fwd(q, k, v, causal: bool, sm_scale=None,
                        dropout_rate: float = 0.0, block_q=None,
                        block_k=None, *, seed=None, kv_lens=None,
                        q_segments=None, kv_segments=None):
    """Flash-attention forward: ``(out [B, Lq, H, D], lse [B, H, Lq])``,
    with the masks of ``kv_lens`` and the segment ids, the probabilities
    dropped at ``dropout_rate`` under ``seed`` (a 64-bit int; required when
    the rate is positive).

    A CUDA tensor launches the kernel on the current stream (one launch
    per call, counted in ``flash_attention_fwd.launches``; a head above 256
    also in ``.wide_launches``, the bf16 wide kernel's, or
    ``.f32_wide_launches``, the fp32 one's; an fp32 head up to 256 in
    ``.f32_fwd_launches``; a head size that is not built
    runs at ``kernel_head_dim`` on zero-padded copies, with the scale of the
    true size; in bf16 above 256 the kernel takes an fp32 workspace of
    ``flash_pair.fwd_work_floats``); a CPU tensor runs
    ``flash_attention_fwd_reference``. Raises on a rate outside [0, 1), a
    positive rate without a seed, explicit block sizes, a query head count
    that is not a multiple of the KV head count, a type other than
    bf16/fp32, malformed masks, and non-contiguous or misaligned input."""
    dims = _check(q, k, v, dropout_rate, seed, block_q, block_k)
    b, lq, lk, h, hkv, d = dims
    masks = _masks(b, lq, lk, q.device, kv_lens, q_segments, kv_segments)
    if q.device.type == "cpu":
        if not _goodput.counting():
            return flash_attention_fwd_reference(
                q, k, v, causal, sm_scale, dropout_rate, seed=seed,
                kv_lens=masks[0], q_segments=masks[1], kv_segments=masks[2])
        with _goodput.uncounted():
            res = flash_attention_fwd_reference(
                q, k, v, causal, sm_scale, dropout_rate, seed=seed,
                kv_lens=masks[0], q_segments=masks[1], kv_segments=masks[2])
        _report(b, lq, lk, h, d, causal, masks, q.device)
        return res
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    kd = kernel_head_dim(d)
    if kd != d:
        out, lse = flash_attention_fwd(
            *(pad_head_dim(t, kd) for t in (q, k, v)), causal,
            _scale(d, sm_scale), dropout_rate, seed=seed, kv_lens=masks[0],
            q_segments=masks[1], kv_segments=masks[2])
        return out[..., :d].contiguous(), lse
    _check_aligned("flash_attention_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=q.device)
    n_work = fwd_work_floats(b, lq, h, d, q.dtype)
    work = torch.empty(n_work, dtype=torch.float32, device=q.device) \
        if n_work else None
    lib = _build.load("flash_attention_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _ptr(work), *map(_ptr, masks), b, lq, lk, h,
            hkv, d,
            int(q.dtype == torch.bfloat16), int(bool(causal)),
            _scale(d, sm_scale), *philox.kernel_args(dropout_rate, seed),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed "
                           f"(cudaError {rc})")
    flash_attention_fwd.launches += 1
    count_bodies(flash_attention_fwd, q.dtype, d)
    if _goodput.counting():
        _report(b, lq, lk, h, d, causal, masks, q.device)
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.wide_launches = 0
flash_attention_fwd.f32_wide_launches = 0
flash_attention_fwd.f32_fwd_launches = 0


def _check_bwd(q, k, v, out, lse, dout, dropout_rate, seed, plain=False):
    b, lq, lk, h, hkv, d = _check(q, k, v, dropout_rate, seed,
                                  who="flash_attention_bwd", plain=plain)
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} must be [B, Lq, "
                             f"H, D] = {tuple(q.shape)} of {q.dtype}, got "
                             f"{tuple(t.shape)} of {t.dtype}")
    if tuple(lse.shape) != (b, h, lq) or lse.dtype != _compute_type(q.dtype):
        raise ValueError(f"flash_attention_bwd: lse must be [B, H, Lq] = "
                         f"{(b, h, lq)} float32, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if not all(t.is_contiguous() for t in (out, lse, dout)):
        raise ValueError("flash_attention_bwd: out, lse and dout must be "
                         "contiguous")
    if len({t.device for t in (q, out, lse, dout)}) != 1:
        raise ValueError("flash_attention_bwd: all inputs must be on one "
                         "device")
    return b, lq, lk, h, hkv, d


def _delta(out, dout):
    """``rowsum(dO * O)`` in the compute type as ``[B, H, Lq]``
    (flash_attention.py:526, outside the kernel there too; the kernels'
    pre-pass computes the same)."""
    ct = _compute_type(out.dtype)
    return (dout.to(ct) * out.to(ct)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, dout, causal: bool,
                                  sm_scale=None, dropout_rate: float = 0.0,
                                  *, seed=None, kv_lens=None,
                                  q_segments=None, kv_segments=None):
    """The backward kernel's math in fp32 torch, written out at the
    kernel's rounding points (not autograd of the forward): ``qs = q *
    scale`` rounded to the input type, ``p = exp(qs.K^T - lse)`` zeroed
    where masked, ``f`` the forward's keep factor of each pair (1 at rate
    0), ``dp = (dO.V^T) * f``, ``ds = p * (dp - delta)`` rounded to the
    input type, ``dq = ds.K * scale``, ``dk = ds^T.q * scale`` with the
    unscaled q, ``dv = round(p * f)^T.dO``, per q head; then each KV head's
    dk and dv are the fp32 sums over its group of q heads, rounded once.

    Where this differs from the JAX package: ``_flash_bwd`` rounds each q
    head's dk and dv to the input type before its fp32 group sum
    (flash_attention.py:591-599, :679-684), so in bf16 a grouped KV
    head's gradient carries ``group`` roundings there and one here. With
    one q head per KV head, and in fp32, the two agree up to summation
    order. Returns ``(dq [B, Lq, H, D], dk, dv [B, Lk, Hkv, D])`` in the
    input type. Takes fp64 too (with an fp64 lse; computed in fp64), as an
    exact oracle."""
    b, lq, lk, h, hkv, d = _check_bwd(q, k, v, out, lse, dout, dropout_rate,
                                      seed, plain=True)
    masks = _masks(b, lq, lk, q.device, kv_lens, q_segments, kv_segments,
                   "flash_attention_bwd")
    dt = q.dtype
    ct = _compute_type(dt)
    group = h // hkv
    scale = _scale(d, sm_scale)
    qf = q.to(ct).transpose(1, 2)                             # [b,h,lq,d]
    qs = (q.to(ct) * scale).to(dt).to(ct).transpose(1, 2)
    kf = _heads_first(k, group)                               # [b,h,lk,d]
    vf = _heads_first(v, group)
    do = dout.to(ct).transpose(1, 2)
    valid = _visible(lq, lk, causal, q.device, *masks)
    p = torch.where(valid, torch.exp(qs @ kf.transpose(-1, -2)
                                     - lse[..., None]), 0.0)
    dp = do @ vf.transpose(-1, -2)
    p_dv = p
    f = _keep_factor(b, h, lq, lk, dropout_rate, seed, q.device)
    if f is not None:
        p_dv = p * f
        dp = dp * f
    ds = (p * (dp - _delta(out, dout)[..., None])).to(dt).to(ct)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf).reshape(b, hkv, group, lk, d).sum(2) \
        * scale
    dv = (p_dv.to(dt).to(ct).transpose(-1, -2) @ do) \
        .reshape(b, hkv, group, lk, d).sum(2)
    return tuple(x.transpose(1, 2).to(dt).contiguous() for x in (dq, dk, dv))


_BWD_ARGTYPES = (*(ctypes.c_void_p,) * 12, *(ctypes.c_int,) * 8,
                 ctypes.c_float, *philox.KERNEL_ARGTYPES, ctypes.c_void_p)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool,
                        sm_scale=None, dropout_rate: float = 0.0, *,
                        seed=None, kv_lens=None, q_segments=None,
                        kv_segments=None):
    """Flash-attention backward: ``(dq, dk, dv)`` in the inputs' layouts
    and type, from the forward's inputs and outputs and the output's
    gradient ``dout``; the masks, ``dropout_rate`` and ``seed`` are the
    forward's.

    A CUDA tensor launches the kernel on the current stream (one counted
    launch per call in ``flash_attention_bwd.launches``; a bf16 head of 256
    or more, the wide body's, also in ``.wide_launches``, an fp32 head above
    256, the fp32 wide body's, in ``.f32_wide_launches``, an fp32 head up to
    256 in ``.f32_bwd_launches``, a bf16 head of 80 or 96 in
    ``.sw32_bwd_launches``; a pre-pass launch before the kernel computes
    ``delta = rowsum(dO*O)``, as the JAX package computes it outside its
    kernel, the kernel stores dq's partials in slabs of one fp32
    workspace, and ``dq_sum.dq_ordered_sum`` behind it, counted apart, adds
    them in kv-tile order into dq, so the gradients are the same bit for
    bit from call to call; a head size that is not built runs padded, as
    in the forward); a CPU
    tensor runs ``flash_attention_bwd_reference``. Raises on what the
    kernel does not take, as the forward does, and on mismatched shapes or
    types."""
    dims = _check_bwd(q, k, v, out, lse, dout, dropout_rate, seed)
    b, lq, lk, h, hkv, d = dims
    masks = _masks(b, lq, lk, q.device, kv_lens, q_segments, kv_segments,
                   "flash_attention_bwd")
    if q.device.type == "cpu":
        if not _goodput.counting():
            return flash_attention_bwd_reference(
                q, k, v, out, lse, dout, causal, sm_scale, dropout_rate,
                seed=seed, kv_lens=masks[0], q_segments=masks[1],
                kv_segments=masks[2])
        with _goodput.uncounted():
            res = flash_attention_bwd_reference(
                q, k, v, out, lse, dout, causal, sm_scale, dropout_rate,
                seed=seed, kv_lens=masks[0], q_segments=masks[1],
                kv_segments=masks[2])
        _report(b, lq, lk, h, d, causal, masks, q.device, True)
        return res
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    kd = kernel_head_dim(d)
    if kd != d:
        # dO's zero columns meet O's: delta is unchanged
        grads = flash_attention_bwd(
            *(pad_head_dim(t, kd) for t in (q, k, v, out)), lse,
            pad_head_dim(dout, kd), causal, _scale(d, sm_scale),
            dropout_rate, seed=seed, kv_lens=masks[0], q_segments=masks[1],
            kv_segments=masks[2])
        return tuple(g[..., :d].contiguous() for g in grads)
    _check_aligned("flash_attention_bwd", q, k, v, out, dout)
    work = torch.empty(bwd_work_floats(b, lq, lk, h, d, q.dtype),
                       dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_attention_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), work.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *map(_ptr, masks),
            b, lq, lk, h, hkv, d, int(q.dtype == torch.bfloat16),
            int(bool(causal)), _scale(d, sm_scale),
            *philox.kernel_args(dropout_rate, seed), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed "
                           f"(cudaError {rc})")
    flash_attention_bwd.launches += 1
    count_bodies(flash_attention_bwd, q.dtype, d, backward=True)
    sum_dq(work, dq.view(b, lq, h * d), lk, d, causal, _scale(d, sm_scale),
           masks[0])
    if _goodput.counting():
        _report(b, lq, lk, h, d, causal, masks, q.device, True)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.wide_launches = 0
flash_attention_bwd.f32_wide_launches = 0
flash_attention_bwd.f32_bwd_launches = 0
flash_attention_bwd.sw32_bwd_launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention under autograd (the counterpart of the JAX
    package's ``custom_vjp`` ``_flash``): ``forward`` runs
    ``flash_attention_fwd`` and saves ``(q, k, v, out, lse)``, the masks
    (int32 tensors) and the dropout seed (an int); ``backward`` runs
    ``flash_attention_bwd``, which regenerates the forward's keep mask from
    that seed. ``apply(q, k, v, causal, dropout_rate=0.0, seed=None,
    kv_lens=None, q_segments=None, kv_segments=None) -> out [B, Lq, H,
    D]``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, dropout_rate=0.0, seed=None,
                kv_lens=None, q_segments=None, kv_segments=None):
        b, lq, h, _ = q.shape
        masks = _masks(b, lq, k.shape[1], q.device, kv_lens, q_segments,
                       kv_segments)
        out, lse = flash_attention_fwd(
            q, k, v, causal, dropout_rate=dropout_rate, seed=seed,
            kv_lens=masks[0], q_segments=masks[1], kv_segments=masks[2])
        ctx.save_for_backward(q, k, v, out, lse, *masks)
        ctx.causal = causal
        ctx.dropout_rate, ctx.seed = dropout_rate, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, lens, q_seg, kv_seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), ctx.causal,
            dropout_rate=ctx.dropout_rate, seed=ctx.seed, kv_lens=lens,
            q_segments=q_seg, kv_segments=kv_seg)
        return dq, dk, dv, None, None, None, None, None, None


# ------------------------------------------------------------ packed qkv


def flash_attention_qkv_packed(qkv, num_heads: int, causal: bool = True,
                               sm_scale=None, dropout_rate: float = 0.0,
                               seed=None):
    """Flash attention straight off the fused projection (row 6, the JAX
    ``flash_attention_qkv_packed``): ``qkv [B, L, 3*H*D]`` (q | k | v
    column blocks, ``D % 128 == 0``) -> the packed context ``[B, L,
    H*D]``, differentiable; ``seed`` (a 64-bit int) is required at a
    positive ``dropout_rate``. The layout is the pair kernels' own, so this
    is ``FlashPairPacked``: ``flash_pair_fwd`` / ``flash_pair_bwd`` launch
    on a CUDA tensor, their plain versions run on a CPU tensor."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"flash_attention_qkv_packed: qkv must be [B, L, "
                         f"3*H*D] with H={num_heads}, got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // (3 * num_heads)
    if d % 128:
        raise ValueError(f"flash_attention_qkv_packed: the packed layout "
                         f"takes head_dim 128 (a multiple of 128 the kernels "
                         f"support), got {d}; use flash_attention_fwd")
    return FlashPairPacked.apply(qkv, int(num_heads), bool(causal),
                                 float(dropout_rate), seed, sm_scale)
