"""Attention functionals (counterpart of ``paddle_tpu/nn/functional/attention.py``).

Routing mirrors the JAX package: the packed flash kernels run when the
shape gate passes (sequence >= 128, head_dim >= 64, the pair layout) and
the tensor lies on the accelerator, forward and backward under autograd
(``FlashPairPacked``); otherwise attention is the plain softmax chain of
``scaled_dot_product_attention``, which is what the JAX package runs off
the TPU or below the kernel's tile minimum. Attention dropout is not
ported yet (slice 3): a positive rate in training mode raises.
"""
from __future__ import annotations

import math

import torch

from ...kernels.flash_pair import FlashPairPacked, pair_layout_supported

__all__ = ["flash_path_available", "pair_layout_supported",
           "flash_attention_qkv_packed", "scaled_dot_product_attention"]


_DROPOUT_WAITS = ("attention dropout comes with slice 3 (ROADMAP Queue 2, "
                  "items 1-2 and 8); train at dropout 0 or call eval()")


def flash_path_available(seq_len: int, head_dim: int, sample=None) -> bool:
    """The gate for the flash kernel: tile minimums, then placement on
    CUDA (``sample``'s device when given, else whether CUDA exists)."""
    if seq_len < 128 or head_dim < 64:
        return False
    if sample is not None:
        return sample.device.type == "cuda"
    return torch.cuda.is_available()


def scaled_dot_product_attention(query, key, value, dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """Softmax attention on ``[B, L, H, D]`` inputs, the counterpart of the
    JAX package's ``_sdpa_fwd`` for the no-mask, no-dropout case: logits in
    the input type scaled by ``1/sqrt(D)``, the causal mask at the type's
    lowest value, softmax, then the weighted sum of values."""
    if training and dropout_p > 0.0:
        raise NotImplementedError(_DROPOUT_WAITS)
    d = query.shape[-1]
    qt, kt, vt = (t.transpose(1, 2) for t in (query, key, value))
    logits = (qt @ kt.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=logits.device).tril(kl - ql)
        logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    return (probs @ vt).transpose(1, 2)


def flash_attention_qkv_packed(qkv, num_heads: int, dropout: float = 0.0,
                               causal: bool = True, training: bool = True):
    """Attention on the fused projection output ``[B, L, 3*H*D]`` -> the
    packed context ``[B, L, H*D]``. Through the flash kernels
    (``FlashPairPacked``: the forward kernel, and the backward kernel when
    a gradient is taken) when the gate passes; else the heads are split and
    sent through ``scaled_dot_product_attention``. A positive dropout rate
    in training mode raises (slice 3)."""
    if training and dropout > 0.0:
        raise NotImplementedError(_DROPOUT_WAITS)
    b, L, width = qkv.shape
    d = width // (3 * num_heads)
    if flash_path_available(L, d, qkv):
        if not pair_layout_supported(d, num_heads, L):
            raise NotImplementedError(
                f"head_dim {d} with {num_heads} heads needs the flat-layout "
                f"flash kernel, not ported yet (ROADMAP Queue 2, item 4)")
        return FlashPairPacked.apply(qkv.contiguous(), num_heads, causal)
    hd = num_heads * d
    q, k, v = (qkv[:, :, i * hd:(i + 1) * hd].reshape(b, L, num_heads, d)
               for i in range(3))
    out = scaled_dot_product_attention(q, k, v, is_causal=causal)
    return out.reshape(b, L, hd)
