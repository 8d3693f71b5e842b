"""Attention functionals (counterpart of ``paddle_tpu/nn/functional/attention.py``).

Routing mirrors the JAX package. When the shape gate passes (sequence >=
128, head_dim >= 64) and the tensor lies on the accelerator:

* ``flash_attention_qkv_packed`` runs the packed flash kernels
  (``FlashPairPacked``) when the pair layout takes the head size, and
  otherwise splits the heads and goes through
  ``scaled_dot_product_attention``;
* ``flash_attention`` and ``scaled_dot_product_attention`` with no mask
  run the ``[B, L, H, D]`` flash kernels with grouped-query attention
  (``FlashAttention``),

forward and backward under autograd. Otherwise attention is the plain
softmax chain of ``scaled_dot_product_attention``, which is what the JAX
package runs off the TPU or below the kernel's tile minimum. Attention
dropout is not ported yet (slice 4): a positive rate in training mode
raises; so do the structured masks (``kv_lens``, segment ids) and an
additive ``attn_mask``.
"""
from __future__ import annotations

import math

import torch

from ...kernels.flash_attention import FlashAttention
from ...kernels.flash_pair import FlashPairPacked, pair_layout_supported

__all__ = ["flash_path_available", "pair_layout_supported",
           "flash_attention_qkv_packed", "flash_attention",
           "scaled_dot_product_attention"]


_DROPOUT_WAITS = ("attention dropout comes with slice 4 (ROADMAP Queue 2, "
                  "items 1-2 and 8); train at dropout 0 or call eval()")


def flash_path_available(seq_len: int, head_dim: int, sample=None) -> bool:
    """The gate for the flash kernels: tile minimums, then placement on
    CUDA (``sample``'s device when given, else whether CUDA exists)."""
    if seq_len < 128 or head_dim < 64:
        return False
    if sample is not None:
        return sample.device.type == "cuda"
    return torch.cuda.is_available()


def _flash_blhd(query, key, value, causal):
    return FlashAttention.apply(query.contiguous(), key.contiguous(),
                                value.contiguous(), bool(causal))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, kv_lens=None,
                                 q_segments=None, kv_segments=None):
    """Softmax attention on ``[B, L, H, D]`` queries against ``[B, L, Hkv,
    D]`` keys and values (``H`` a multiple of ``Hkv``: grouped-query
    attention, each KV head serving ``H / Hkv`` consecutive q heads).

    With no mask, on CUDA, past the tile minimums: the flash kernels
    (``FlashAttention``), as the JAX package routes this call to its Pallas
    kernel. Otherwise the counterpart of the JAX package's ``_sdpa_fwd``:
    KV heads repeated to the q heads, logits in the input type scaled by
    ``1/sqrt(D)``, the causal mask (aligned bottom-right) at the type's
    lowest value, softmax, then the weighted sum of values. Dropout,
    ``attn_mask``, ``kv_lens`` and segment ids raise."""
    if training and dropout_p > 0.0:
        raise NotImplementedError(_DROPOUT_WAITS)
    if attn_mask is not None:
        raise NotImplementedError(
            "scaled_dot_product_attention: an additive attn_mask is not "
            "ported yet (ROADMAP Queue 1, item 2)")
    if kv_lens is not None or q_segments is not None \
            or kv_segments is not None:
        raise NotImplementedError(
            "scaled_dot_product_attention: kv_lens and segment ids (the "
            "flash kernel's padding and packed-sequence masks) are not "
            "ported yet (ROADMAP Queue 2, item 4)")
    b, lq, h, d = query.shape
    if flash_path_available(lq, d, query):
        return _flash_blhd(query, key, value, is_causal)
    if key.shape[2] != h:
        rep = h // key.shape[2]
        key = key.repeat_interleave(rep, dim=2)
        value = value.repeat_interleave(rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (query, key, value))
    logits = (qt @ kt.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=logits.device).tril(kl - ql)
        logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    return (probs @ vt).transpose(1, 2)


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, training: bool = True):
    """``paddle.nn.functional.flash_attention`` on ``[B, L, H, D]`` queries
    and ``[B, L, Hkv, D]`` keys and values (grouped-query attention when
    ``Hkv < H``). Through the flash kernels (``FlashAttention``: the
    forward kernel, and the backward kernel when a gradient is taken) when
    the gate passes; else ``scaled_dot_product_attention``. A positive
    dropout rate in training mode raises (slice 4)."""
    if training and dropout > 0.0:
        raise NotImplementedError(_DROPOUT_WAITS)
    if flash_path_available(query.shape[1], query.shape[3], query):
        return _flash_blhd(query, key, value, causal)
    return scaled_dot_product_attention(query, key, value,
                                        is_causal=causal, training=training)


def flash_attention_qkv_packed(qkv, num_heads: int, dropout: float = 0.0,
                               causal: bool = True, training: bool = True):
    """Attention on the fused projection output ``[B, L, 3*H*D]`` -> the
    packed context ``[B, L, H*D]``. Through the packed flash kernels
    (``FlashPairPacked``) when the gate passes and the pair layout takes
    the head size; else the heads are split and sent through
    ``scaled_dot_product_attention`` (which reaches the ``[B, L, H, D]``
    flash kernels on the card, as the JAX package's fallback does). A
    positive dropout rate in training mode raises (slice 4)."""
    if training and dropout > 0.0:
        raise NotImplementedError(_DROPOUT_WAITS)
    b, L, width = qkv.shape
    d = width // (3 * num_heads)
    if flash_path_available(L, d, qkv) \
            and pair_layout_supported(d, num_heads, L):
        return FlashPairPacked.apply(qkv.contiguous(), num_heads, causal)
    hd = num_heads * d
    q, k, v = (qkv[:, :, i * hd:(i + 1) * hd].reshape(b, L, num_heads, d)
               for i in range(3))
    out = scaled_dot_product_attention(q, k, v, is_causal=causal)
    return out.reshape(b, L, hd)
