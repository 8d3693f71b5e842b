"""Flash attention over the packed qkv layout (the "pair" path).

Counterpart of ``paddle_tpu/kernels/pallas/flash_pair.py`` at dropout rate
0. Two kernels, CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use
and bound with ``ctypes``:

* ``flash_pair_fwd(qkv, num_heads, causal)`` (``csrc/flash_pair_fwd.cu``)
  takes the fused projection output ``[B, L, 3*H*D]`` (columns ``[q heads
  | k heads | v heads]``) and returns the packed context ``[B, L, H*D]``
  in the input type and the per-row log-sum-exp ``[B, H, L]`` in fp32.
* ``flash_pair_bwd(qkv, out, lse, dout, num_heads, causal)``
  (``csrc/flash_pair_bwd.cu``) returns ``d(qkv)`` ``[B, L, 3*H*D]`` in the
  packed layout: the one-pass backward of ``_pair_bwd``, fused and split
  forms alike (they compute the same function).

``FlashPairPacked`` ties them together under autograd. On a CUDA tensor a
wrapper launches its kernel; on a CPU tensor it computes its ``_reference``,
the same math in plain torch. There is no other path: anything the kernels
do not take raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_pair_fwd", "flash_pair_fwd_reference", "flash_pair_bwd",
           "flash_pair_bwd_reference", "FlashPairPacked",
           "pair_layout_supported"]

_NEG_INF = -1e30
_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 128)


def _heads_per_block(head_dim: int) -> int:
    """How many adjacent heads fill a 128-wide column block (2 at d=64, 1
    at d=128)."""
    return max(1, 128 // head_dim)


def pair_layout_supported(head_dim: int, num_heads: int,
                          seq_len: int = 0) -> bool:
    """The pair path's shape gate, as in the JAX package: whole head
    blocks fill the 128-wide column quantum. Any sequence length."""
    hpb = _heads_per_block(head_dim)
    return ((hpb * head_dim) % 128 == 0 and head_dim % 8 == 0
            and num_heads % hpb == 0)


def _check(qkv: torch.Tensor, num_heads: int, dropout_rate: float,
           who: str = "flash_pair_fwd") -> int:
    if dropout_rate > 0.0:
        raise NotImplementedError(
            f"{who}: in-kernel dropout comes with slice 4 (ROADMAP Queue 2, "
            f"items 1-2); call it with dropout_rate=0")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"{who}: qkv must be [B, L, 3*H*D] with "
                         f"H={num_heads}, got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // (3 * num_heads)
    if d not in _HEAD_DIMS or not pair_layout_supported(d, num_heads):
        raise ValueError(f"{who}: head_dim {d} with {num_heads} "
                         f"heads is not supported (head_dim in {_HEAD_DIMS}, "
                         f"num_heads a multiple of max(1, 128 // head_dim))")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{who}: dtype {qkv.dtype} is not "
                        f"supported (bfloat16 or float32)")
    if not qkv.is_contiguous():
        raise ValueError(f"{who}: qkv must be contiguous")
    return d


def flash_pair_fwd_reference(qkv: torch.Tensor, num_heads: int,
                             causal: bool, dropout_rate: float = 0.0):
    """The kernel's math in fp32 torch: q * scale rounded to the input
    type before Q.K^T, probabilities rounded to v's type before P.V, the
    mask at -1e30 and the final ``acc / max(l, 1e-30)``. Returns
    ``(out [B, L, H*D] in qkv's type, lse [B, H, L] fp32)``."""
    d = _check(qkv, num_heads, dropout_rate)
    b, L, _ = qkv.shape
    dt = qkv.dtype
    x = qkv.reshape(b, L, 3, num_heads, d).permute(0, 2, 3, 1, 4)  # [b,3,H,L,d]
    q = (x[:, 0].float() * (1.0 / math.sqrt(d))).to(dt).float()
    k = x[:, 1].float()
    v = x[:, 2].float()
    s = q @ k.transpose(-1, -2)                               # [b,H,L,L]
    if causal:
        valid = torch.ones(L, L, dtype=torch.bool,
                           device=qkv.device).tril()
        s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(dt).float() @ v) / l
    lse = (m + torch.log(l))[..., 0]
    out = o.transpose(1, 2).reshape(b, L, num_heads * d).to(dt)
    return out, lse


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def flash_pair_fwd(qkv: torch.Tensor, num_heads: int, causal: bool,
                   dropout_rate: float = 0.0):
    """Packed flash-attention forward: ``(out [B, L, H*D], lse [B, H, L])``.

    A CUDA tensor launches the kernel on the current stream (one launch
    per call, counted in ``flash_pair_fwd.launches``); a CPU tensor runs
    ``flash_pair_fwd_reference``. Raises on ``dropout_rate > 0``, a head
    size other than 64 or 128, a type other than bf16/fp32 and
    non-contiguous input."""
    d = _check(qkv, num_heads, dropout_rate)
    if qkv.device.type == "cpu":
        return flash_pair_fwd_reference(qkv, num_heads, causal)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_pair_fwd: unsupported device {qkv.device}")
    if qkv.data_ptr() % 16:
        raise ValueError("flash_pair_fwd: qkv must be 16-byte aligned (the "
                         "kernel reads it in 16-byte vectors)")
    b, L, _ = qkv.shape
    out = torch.empty(b, L, num_heads * d, dtype=qkv.dtype,
                      device=qkv.device)
    lse = torch.empty(b, num_heads, L, dtype=torch.float32,
                      device=qkv.device)
    lib = _build.load("flash_pair_fwd", _ARGTYPES)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_pair_fwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, L, num_heads,
            d, int(qkv.dtype == torch.bfloat16), int(bool(causal)),
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"flash_pair_fwd: kernel launch failed "
                           f"(cudaError {rc})")
    flash_pair_fwd.launches += 1
    return out, lse


flash_pair_fwd.launches = 0


def _check_bwd(qkv, out, lse, dout, num_heads):
    d = _check(qkv, num_heads, 0.0, who="flash_pair_bwd")
    b, L, _ = qkv.shape
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != (b, L, num_heads * d) or t.dtype != qkv.dtype:
            raise ValueError(f"flash_pair_bwd: {name} must be [B, L, H*D] = "
                             f"{(b, L, num_heads * d)} of {qkv.dtype}, got "
                             f"{tuple(t.shape)} of {t.dtype}")
    if tuple(lse.shape) != (b, num_heads, L) or lse.dtype != torch.float32:
        raise ValueError(f"flash_pair_bwd: lse must be [B, H, L] = "
                         f"{(b, num_heads, L)} float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not all(t.is_contiguous() for t in (out, lse, dout)):
        raise ValueError("flash_pair_bwd: out, lse and dout must be "
                         "contiguous")
    if len({t.device for t in (qkv, out, lse, dout)}) != 1:
        raise ValueError("flash_pair_bwd: all inputs must be on one device")
    return d


def _delta(out: torch.Tensor, dout: torch.Tensor, num_heads: int):
    """``rowsum(dO * O)`` in fp32 as ``[B, H, L]`` (flash_pair.py:451-455,
    outside the kernel there too)."""
    b, L, hd = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(b, L, num_heads, hd // num_heads).sum(-1) \
        .transpose(1, 2).contiguous()


def flash_pair_bwd_reference(qkv: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             num_heads: int, causal: bool):
    """The backward kernel's math in fp32 torch, written out as the Pallas
    ``_bwd_tile_core`` has it (not autograd of the forward): ``qs = q *
    scale`` rounded to the input type, ``p = exp(qs.K^T - lse)`` zeroed
    where masked, ``dp = dO.V^T``, ``ds = p * (dp - delta)`` rounded to the
    input type, ``dq = ds.K * scale``, ``dk = ds^T.q * scale`` with the
    unscaled q, ``dv = round(p)^T.dO``. Returns ``d(qkv)`` ``[B, L,
    3*H*D]`` in qkv's type."""
    d = _check_bwd(qkv, out, lse, dout, num_heads)
    b, L, _ = qkv.shape
    dt = qkv.dtype
    scale = 1.0 / math.sqrt(d)
    x = qkv.reshape(b, L, 3, num_heads, d).permute(0, 2, 3, 1, 4)  # [b,3,H,L,d]
    q = x[:, 0].float()
    k = x[:, 1].float()
    v = x[:, 2].float()
    qs = (q * scale).to(dt).float()
    s = qs @ k.transpose(-1, -2)                              # [b,H,L,L]
    p = torch.exp(s - lse[..., None])
    if causal:
        valid = torch.ones(L, L, dtype=torch.bool,
                           device=qkv.device).tril()
        p = torch.where(valid, p, 0.0)
    do = dout.reshape(b, L, num_heads, d).transpose(1, 2).float()
    dp = do @ v.transpose(-1, -2)
    ds = (p * (dp - _delta(out, dout, num_heads)[..., None])).to(dt).float()
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    dv = p.to(dt).float().transpose(-1, -2) @ do
    dqkv = torch.stack([dq, dk, dv], dim=1)                   # [b,3,H,L,d]
    return dqkv.permute(0, 3, 1, 2, 4).reshape(b, L, 3 * num_heads * d) \
        .to(dt)


_BWD_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def flash_pair_bwd(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                   dout: torch.Tensor, num_heads: int, causal: bool):
    """Packed flash-attention backward: ``d(qkv)`` ``[B, L, 3*H*D]`` in
    qkv's type from the forward's inputs and outputs and the output's
    gradient ``dout``.

    A CUDA tensor launches the kernel on the current stream (one counted
    launch per call in ``flash_pair_bwd.launches``; the kernel's dq goes
    through an fp32 scratch and a small conversion launch behind it); a
    CPU tensor runs ``flash_pair_bwd_reference``. ``delta = rowsum(dO*O)``
    is a torch expression here, as the JAX package computes it outside its
    kernel. Raises on what the kernel does not take: a head size other than
    64 or 128, a type other than bf16/fp32, mismatched shapes or types,
    non-contiguous or misaligned input."""
    d = _check_bwd(qkv, out, lse, dout, num_heads)
    if qkv.device.type == "cpu":
        return flash_pair_bwd_reference(qkv, out, lse, dout, num_heads,
                                        causal)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_pair_bwd: unsupported device {qkv.device}")
    if qkv.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("flash_pair_bwd: qkv and dout must be 16-byte "
                         "aligned (the kernel reads them in 16-byte vectors)")
    b, L, _ = qkv.shape
    delta = _delta(out, dout, num_heads)
    dq_acc = torch.zeros(b, L, num_heads * d, dtype=torch.float32,
                         device=qkv.device)
    dqkv = torch.empty_like(qkv)
    lib = _build.load("flash_pair_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_pair_bwd(
            qkv.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq_acc.data_ptr(), dqkv.data_ptr(), b, L,
            num_heads, d, int(qkv.dtype == torch.bfloat16), int(bool(causal)),
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"flash_pair_bwd: kernel launch failed "
                           f"(cudaError {rc})")
    flash_pair_bwd.launches += 1
    return dqkv


flash_pair_bwd.launches = 0


class FlashPairPacked(torch.autograd.Function):
    """Packed flash attention under autograd (the counterpart of the JAX
    package's ``custom_vjp`` ``flash_pair``): ``forward`` runs
    ``flash_pair_fwd`` and saves ``(qkv, out, lse)``, ``backward`` runs
    ``flash_pair_bwd`` and returns ``d(qkv)``. ``apply(qkv, num_heads,
    causal) -> out [B, L, H*D]``."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal):
        out, lse = flash_pair_fwd(qkv, num_heads, causal)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads = num_heads
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        dqkv = flash_pair_bwd(qkv, out, lse, dout.contiguous(),
                              ctx.num_heads, ctx.causal)
        return dqkv, None, None
