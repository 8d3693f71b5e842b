"""Flash attention on the ``[B, L, H, D]`` layout, with grouped-query
attention (the "flat" path).

Counterpart of ``paddle_tpu/kernels/pallas/flash_attention.py``
(``flash_attention_blhd``) at dropout rate 0, without per-sequence
``kv_lens`` or segment ids. Two kernels, CUDA C++ for ``sm_90a``, built
with ``nvcc`` at first use and bound with ``ctypes``:

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

``FlashAttention`` ties them together under autograd. On a CUDA tensor a
wrapper launches its kernel; on a CPU tensor it computes its ``_reference``,
the same math in plain torch. There is no other path: anything the kernels
do not take raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention_fwd", "flash_attention_fwd_reference",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "FlashAttention"]

_NEG_INF = -1e30
_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 128)


def _check(q, k, v, dropout_rate=0.0, block_q=None, block_k=None,
           who="flash_attention_fwd"):
    """Validate the forward's inputs; returns ``(B, Lq, Lk, H, Hkv, D)``."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            f"{who}: in-kernel dropout comes with slice 4 (ROADMAP Queue 2, "
            f"items 1-2 and 8); call it with dropout_rate=0")
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
    if d not in _HEAD_DIMS:
        raise ValueError(f"{who}: head_dim {d} is not supported (head_dim "
                         f"in {_HEAD_DIMS})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{who}: q, k, v must share one dtype of bfloat16 "
                        f"or float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{who}: q, k and v must be contiguous")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"{who}: q, k and v must be on one device")
    if lq < 1 or lk < 1:
        raise ValueError(f"{who}: empty sequence (Lq={lq}, Lk={lk})")
    return b, lq, lk, h, hkv, d


def _scale(d, sm_scale):
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def _heads_first(x, group):
    """``[B, L, Hx, D]`` -> fp32 ``[B, Hx * group, L, D]``, each head
    repeated ``group`` times in place (q head ``h`` reads KV head ``h //
    group``)."""
    return x.float().transpose(1, 2).repeat_interleave(group, dim=1)


def _visible(lq, lk, causal, device):
    """``[Lq, Lk]`` mask of the (query, key) pairs attended: all, or the
    bottom-right-aligned causal band ``j <= i + Lk - Lq``."""
    if not causal:
        return torch.ones(lq, lk, dtype=torch.bool, device=device)
    return torch.ones(lq, lk, dtype=torch.bool, device=device).tril(lk - lq)


def flash_attention_fwd_reference(q, k, v, causal: bool, sm_scale=None,
                                  dropout_rate: float = 0.0):
    """The kernel's math in fp32 torch: q * scale rounded to the input type
    before Q.K^T, the mask at -1e30, probabilities rounded to v's type
    before P.V and the final ``acc / max(l, 1e-30)``, so a row with no
    visible key gives 0 and its lse is -1e30. Returns ``(out [B, Lq, H, D]
    in q's type, lse [B, H, Lq] fp32)``."""
    b, lq, lk, h, hkv, d = _check(q, k, v, dropout_rate)
    dt = q.dtype
    scale = _scale(d, sm_scale)
    qs = (q.float() * scale).to(dt).float().transpose(1, 2)   # [b,h,lq,d]
    kf = _heads_first(k, h // hkv)
    vf = _heads_first(v, h // hkv)
    valid = _visible(lq, lk, causal, q.device)
    s = torch.where(valid, qs @ kf.transpose(-1, -2), _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(dt).float() @ vf) / l
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).to(dt).contiguous(), lse


_FWD_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                 ctypes.c_void_p)


def _check_aligned(who, *tensors):
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{who}: inputs must be 16-byte aligned (the kernel "
                         f"reads them in 16-byte vectors)")


def flash_attention_fwd(q, k, v, causal: bool, sm_scale=None,
                        dropout_rate: float = 0.0, block_q=None,
                        block_k=None):
    """Flash-attention forward: ``(out [B, Lq, H, D], lse [B, H, Lq])``.

    A CUDA tensor launches the kernel on the current stream (one launch
    per call, counted in ``flash_attention_fwd.launches``); a CPU tensor
    runs ``flash_attention_fwd_reference``. Raises on ``dropout_rate > 0``,
    explicit block sizes, a head size other than 64 or 128, a query head
    count that is not a multiple of the KV head count, a type other than
    bf16/fp32, and non-contiguous or misaligned input."""
    b, lq, lk, h, hkv, d = _check(q, k, v, dropout_rate, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    _check_aligned("flash_attention_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, lq, lk, h, hkv, d,
            int(q.dtype == torch.bfloat16), int(bool(causal)),
            _scale(d, sm_scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed "
                           f"(cudaError {rc})")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _check_bwd(q, k, v, out, lse, dout):
    b, lq, lk, h, hkv, d = _check(q, k, v, who="flash_attention_bwd")
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} must be [B, Lq, "
                             f"H, D] = {tuple(q.shape)} of {q.dtype}, got "
                             f"{tuple(t.shape)} of {t.dtype}")
    if tuple(lse.shape) != (b, h, lq) or lse.dtype != torch.float32:
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
    """``rowsum(dO * O)`` in fp32 as ``[B, H, Lq]`` (flash_attention.py:526,
    outside the kernel there too)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, dout, causal: bool,
                                  sm_scale=None):
    """The backward kernel's math in fp32 torch, written out at the
    kernel's rounding points (not autograd of the forward): ``qs = q *
    scale`` rounded to the input type, ``p = exp(qs.K^T - lse)`` zeroed
    where masked, ``dp = dO.V^T``, ``ds = p * (dp - delta)`` rounded to the
    input type, ``dq = ds.K * scale``, ``dk = ds^T.q * scale`` with the
    unscaled q, ``dv = round(p)^T.dO``, per q head; then each KV head's dk
    and dv are the fp32 sums over its group of q heads, rounded once.

    Where this differs from the JAX package: ``_flash_bwd`` rounds each q
    head's dk and dv to the input type before its fp32 group sum
    (flash_attention.py:591-599, :679-684), so in bf16 a grouped KV
    head's gradient carries ``group`` roundings there and one here. With
    one q head per KV head, and in fp32, the two agree up to summation
    order. Returns ``(dq [B, Lq, H, D], dk, dv [B, Lk, Hkv, D])`` in the
    input type."""
    b, lq, lk, h, hkv, d = _check_bwd(q, k, v, out, lse, dout)
    dt = q.dtype
    group = h // hkv
    scale = _scale(d, sm_scale)
    qf = q.float().transpose(1, 2)                            # [b,h,lq,d]
    qs = (q.float() * scale).to(dt).float().transpose(1, 2)
    kf = _heads_first(k, group)                               # [b,h,lk,d]
    vf = _heads_first(v, group)
    do = dout.float().transpose(1, 2)
    valid = _visible(lq, lk, causal, q.device)
    p = torch.where(valid, torch.exp(qs @ kf.transpose(-1, -2)
                                     - lse[..., None]), 0.0)
    dp = do @ vf.transpose(-1, -2)
    ds = (p * (dp - _delta(out, dout)[..., None])).to(dt).float()
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf).reshape(b, hkv, group, lk, d).sum(2) \
        * scale
    dv = (p.to(dt).float().transpose(-1, -2) @ do) \
        .reshape(b, hkv, group, lk, d).sum(2)
    return tuple(x.transpose(1, 2).to(dt).contiguous() for x in (dq, dk, dv))


_BWD_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool,
                        sm_scale=None):
    """Flash-attention backward: ``(dq, dk, dv)`` in the inputs' layouts
    and type, from the forward's inputs and outputs and the output's
    gradient ``dout``.

    A CUDA tensor launches the kernel on the current stream (one counted
    launch per call in ``flash_attention_bwd.launches``; the kernel's dq
    goes through an fp32 scratch and a small conversion launch behind it);
    a CPU tensor runs ``flash_attention_bwd_reference``. ``delta =
    rowsum(dO*O)`` is a torch expression here, as the JAX package computes
    it outside its kernel. Raises on what the kernel does not take, as the
    forward does, and on mismatched shapes or types."""
    b, lq, lk, h, hkv, d = _check_bwd(q, k, v, out, lse, dout)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                             causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    _check_aligned("flash_attention_bwd", q, k, v, dout)
    delta = _delta(out, dout)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.load("flash_attention_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, lq, lk, h, hkv,
            d, int(q.dtype == torch.bfloat16), int(bool(causal)),
            _scale(d, sm_scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed "
                           f"(cudaError {rc})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention under autograd (the counterpart of the JAX
    package's ``custom_vjp`` ``_flash``): ``forward`` runs
    ``flash_attention_fwd`` and saves ``(q, k, v, out, lse)``,
    ``backward`` runs ``flash_attention_bwd``. ``apply(q, k, v, causal)
    -> out [B, Lq, H, D]``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.causal)
        return dq, dk, dv, None
