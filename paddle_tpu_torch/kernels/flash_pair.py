"""Flash-attention forward over the packed qkv layout (the "pair" path).

Counterpart of ``paddle_tpu/kernels/pallas/flash_pair.py`` (forward,
dropout rate 0). The kernel is ``csrc/flash_pair_fwd.cu``: CUDA C++ for
``sm_90a``, built with ``nvcc`` at first use and bound with ``ctypes``.

``flash_pair_fwd(qkv, num_heads, causal)`` takes the fused projection
output ``[B, L, 3*H*D]`` (columns ``[q heads | k heads | v heads]``) and
returns the packed context ``[B, L, H*D]`` in the input type and the
per-row log-sum-exp ``[B, H, L]`` in fp32 (the backward of the training
slice consumes it). On a CUDA tensor it launches the kernel; on a CPU
tensor it computes ``flash_pair_fwd_reference``, the same math in plain
torch. There is no other path: anything the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_pair_fwd", "flash_pair_fwd_reference",
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


def _check(qkv: torch.Tensor, num_heads: int, dropout_rate: float) -> int:
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash_pair_fwd: in-kernel dropout comes with the training "
            "slice (ROADMAP Queue 2, item 1); call it with dropout_rate=0")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"flash_pair_fwd: qkv must be [B, L, 3*H*D] with "
                         f"H={num_heads}, got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // (3 * num_heads)
    if d not in _HEAD_DIMS or not pair_layout_supported(d, num_heads):
        raise ValueError(f"flash_pair_fwd: head_dim {d} with {num_heads} "
                         f"heads is not supported (head_dim in {_HEAD_DIMS}, "
                         f"num_heads a multiple of max(1, 128 // head_dim))")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"flash_pair_fwd: dtype {qkv.dtype} is not "
                        f"supported (bfloat16 or float32)")
    if not qkv.is_contiguous():
        raise ValueError("flash_pair_fwd: qkv must be contiguous")
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
