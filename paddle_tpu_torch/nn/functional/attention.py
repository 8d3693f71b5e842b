"""Attention functionals (counterpart of ``paddle_tpu/nn/functional/attention.py``).

Routing mirrors the JAX package. When the shape gate passes (sequence >=
128, lifted inside ``flash_at_any_length``; head_dim >= 64) and the tensor
lies on the accelerator:

* ``flash_attention_qkv_packed`` runs the packed flash kernels
  (``FlashPairPacked``) when the pair layout takes the head size, and
  otherwise splits the heads and goes through the ``[B, L, H, D]`` route;
* ``flash_attention`` and ``scaled_dot_product_attention`` without an
  additive ``attn_mask`` run the ``[B, L, H, D]`` flash kernels
  (``FlashAttention``), with grouped-query attention, ``kv_lens`` and
  segment ids: the JAX package's four ops ``flash_attn_pallas{,_lens,
  _segs,_segs_lens}``,

forward and backward under autograd. Otherwise attention is the plain
softmax chain of ``scaled_dot_product_attention``, which is what the JAX
package runs off the TPU, below the kernel's tile minimum, or whenever an
additive ``attn_mask`` is given (lengths and segment ids then become an
additive mask combined with it).

Attention dropout draws one seed per call from the caller's ``generator``
(a CPU ``torch.Generator``) or, without one, from the global chain
(``core.random``: ``seed``), and keys a Philox mask on (b, q head, q
position, key position) (``kernels/philox.py``): the kernels drop
in-kernel, the plain chain multiplies by the same keep factors, so the
card and the CPU agree, and the packed and the ``[B, L, H, D]`` routes
drop the same elements.

Every route's output is tagged ``attn_context`` (``core.remat``), as the
JAX package tags each attention op's output: the selective recompute
policy and the health plane's activation taps see it.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch

from ...core.dispatch import apply_op, register_op
from ...core.random import next_seed
from ...core.remat import ATTN_CONTEXT, tag_activation
from ...kernels import philox
from ...kernels.flash_attention import FlashAttention
from ...kernels.flash_pair import FlashPairPacked, pair_layout_supported

__all__ = ["flash_path_available", "flash_at_any_length",
           "pair_layout_supported",
           "flash_attention_qkv_packed", "flash_attention",
           "scaled_dot_product_attention"]


# The gate's sequence minimum: the JAX package's, whose Pallas kernels
# tile 128 rows. ``flash_at_any_length`` lowers it to 1 for its callers.
_seq_min = 128


@contextmanager
def flash_at_any_length():
    """Within it the flash gate takes every sequence length: the Hopper
    kernels have no 128-row minimum (a sequence shorter than a tile is one
    ragged tile). The speculative drafters run their ``[1, ctx_len]``
    windows inside it (``serving.spec``), so a window of 64 goes through
    the kernels; everything else keeps the reference's routing."""
    global _seq_min
    saved, _seq_min = _seq_min, 1
    try:
        yield
    finally:
        _seq_min = saved


def flash_path_available(seq_len: int, head_dim: int, sample=None) -> bool:
    """The gate for the flash kernels: tile minimums (the sequence's is
    lifted inside ``flash_at_any_length``), then placement on CUDA
    (``sample``'s device when given, else whether CUDA exists)."""
    if seq_len < _seq_min or head_dim < 64:
        return False
    if sample is not None:
        return sample.device.type == "cuda"
    return torch.cuda.is_available()


def _draw_seed(rate: float, generator):
    """One Philox seed from ``generator`` (the global chain when None) for
    a dropout at ``rate``; None at rate 0."""
    return next_seed(generator) if rate > 0.0 else None


def _structured_to_additive(query, key, kv_lens, q_segments, kv_segments):
    """``[B]`` lengths / ``[B, L]`` segment ids -> an additive fp32 ``[B,
    1, Lq, Lk]`` mask: 0 where the pair is attended, -1e30 where not (the
    JAX package's ``_structured_to_additive``)."""
    b, lq, lk = query.shape[0], query.shape[1], key.shape[1]
    dev = query.device

    def shaped(x, shape, name):
        t = torch.as_tensor(x, device=dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"scaled_dot_product_attention: {name} must be "
                             f"{list(shape)}, got {list(t.shape)}")
        return t

    valid = None
    if kv_lens is not None:
        lens = shaped(kv_lens, (b,), "kv_lens")
        cols = torch.arange(lk, device=dev)[None, :] < lens[:, None]
        valid = cols[:, None, :].expand(b, lq, lk)
    if q_segments is not None:
        sq = shaped(q_segments, (b, lq), "q_segments")
        sk = shaped(kv_segments, (b, lk), "kv_segments")
        seg_ok = sq[:, :, None] == sk[:, None, :]
        valid = seg_ok if valid is None else valid & seg_ok
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(valid, zero, -1e30)[:, None]


def _attend(query, key, value, attn_mask, causal, rate, seed, kv_lens=None,
            q_segments=None, kv_segments=None):
    """The routing of ``scaled_dot_product_attention`` once the dropout
    seed is drawn."""
    if (q_segments is None) != (kv_segments is None):
        raise ValueError("scaled_dot_product_attention: q_segments and "
                         "kv_segments must be given together")
    if attn_mask is None and flash_path_available(query.shape[1],
                                                  query.shape[3], query):
        return tag_activation(
            FlashAttention.apply(query.contiguous(), key.contiguous(),
                                 value.contiguous(), bool(causal), rate,
                                 seed, kv_lens, q_segments, kv_segments),
            ATTN_CONTEXT)
    if attn_mask is not None and attn_mask.dtype == torch.bool:
        raise TypeError("scaled_dot_product_attention: attn_mask is additive "
                        "(added to the logits), got a bool mask")
    if kv_lens is not None or q_segments is not None:
        # lengths and segments as an additive mask, combined with the
        # user's: dropping either would attend padding keys
        structured = _structured_to_additive(query, key, kv_lens, q_segments,
                                             kv_segments)
        attn_mask = structured if attn_mask is None \
            else structured + attn_mask.float()
    return tag_activation(_plain_attention(query, key, value, causal, rate,
                                           seed, attn_mask), ATTN_CONTEXT)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None,
                                 kv_lens=None, q_segments=None,
                                 kv_segments=None, *, generator=None):
    """Softmax attention on ``[B, L, H, D]`` queries against ``[B, L, Hkv,
    D]`` keys and values (``H`` a multiple of ``Hkv``: grouped-query
    attention, each KV head serving ``H / Hkv`` consecutive q heads).

    ``kv_lens`` ``[B]``: per-sequence key counts (the structured form of a
    ``[B, 1, 1, L]`` padding mask; queries past a length still attend the
    valid keys). ``q_segments`` / ``kv_segments`` ``[B, Lq]`` / ``[B,
    Lk]``: packed-sequence ids, only same-segment pairs attend (both or
    neither). ``attn_mask``: an additive float mask broadcast against the
    ``[B, H, Lq, Lk]`` logits.

    With no ``attn_mask``, on CUDA, past the tile minimums: the flash
    kernels (``FlashAttention``) with the lengths, segment ids and
    in-kernel dropout, as the JAX package routes this call to its Pallas
    kernels. Otherwise the counterpart of the JAX package's ``_sdpa_fwd``,
    on the card as well when an ``attn_mask`` is given (that is the JAX
    routing, not a fallback): KV heads repeated to the q heads, logits in
    the input type scaled by ``1/sqrt(D)``, plus ``attn_mask`` and the
    lengths and segments as a -1e30 additive mask, the causal mask
    (aligned bottom-right) at the type's lowest value, softmax, then the
    weighted sum of values.

    In training at ``dropout_p > 0`` one seed is drawn from ``generator``
    (a CPU ``torch.Generator``; the global chain without one) and both
    routes drop the elements of ``philox.attention_keep`` at that seed.

    The positional order is the JAX package's; ``name`` is accepted and
    ignored there as here, and ``generator`` (the port's) is keyword-only
    after it."""
    return apply_op("sdpa", (query, key, value, attn_mask, kv_lens,
                             q_segments, kv_segments),
                    dict(dropout_p=dropout_p, is_causal=is_causal,
                         training=training, generator=generator))


def _sdpa_fwd(query, key, value, attn_mask, kv_lens, q_segments,
              kv_segments, dropout_p=0.0, is_causal=False, training=True,
              generator=None):
    rate = float(dropout_p) if training else 0.0
    seed = _draw_seed(rate, generator)
    return _attend(query, key, value, attn_mask, is_causal, rate, seed,
                   kv_lens, q_segments, kv_segments)


register_op("sdpa", _sdpa_fwd)


def _plain_attention(query, key, value, causal, rate: float = 0.0,
                     seed=None, attn_mask=None):
    """The JAX package's ``_sdpa_fwd`` softmax chain on ``[B, L, H, D]``:
    KV heads repeated to the q heads, logits in the input type scaled by
    ``1/sqrt(D)``, plus the additive ``attn_mask`` in the logits' type,
    the causal mask (aligned bottom-right) at the type's lowest value,
    softmax, at ``rate > 0`` each probability times its keep factor
    (``philox.attention_keep(seed, ...)``: the kernels' mask), then the
    weighted sum of values."""
    b, lq, h, d = query.shape
    if key.shape[2] != h:
        rep = h // key.shape[2]
        key = key.repeat_interleave(rep, dim=2)
        value = value.repeat_interleave(rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (query, key, value))
    logits = (qt @ kt.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if attn_mask is not None:
        logits = logits + attn_mask.to(logits.dtype)
    if causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=logits.device).tril(kl - ql)
        logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    if rate > 0.0:
        keep = philox.attention_keep(seed, b, h, lq, key.shape[1], rate,
                                     probs.device)
        probs = probs * torch.where(keep, philox.keep_scale(rate),
                                    0.0).to(probs.dtype)
    return (probs @ vt).transpose(1, 2)


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    fixed_seed_offset=None, rng_name: str = "",
                    training: bool = True, name=None, use_pallas=None, *,
                    generator=None):
    """``paddle.nn.functional.flash_attention`` on ``[B, L, H, D]`` queries
    and ``[B, L, Hkv, D]`` keys and values (grouped-query attention when
    ``Hkv < H``), with the JAX package's positional order.

    ``use_pallas`` picks the route as there: None takes the gate (the
    flash kernels, ``FlashAttention``: the forward kernel, and the
    backward kernel when a gradient is taken, when it passes; else
    ``scaled_dot_product_attention``'s plain chain); True takes the kernel
    route (the kernels' plain versions on a CPU tensor); False takes the
    ``scaled_dot_product_attention`` route. ``return_softmax=True`` returns
    ``(out, None)``: the probabilities are not kept, as in the JAX package.
    ``fixed_seed_offset``, ``rng_name`` and ``name`` are accepted and
    ignored, as there. In training at ``dropout > 0`` one seed is drawn
    from ``generator`` (keyword-only: a CPU ``torch.Generator``; the global
    chain without one) and the probabilities drop in-kernel."""
    out = apply_op("flash_attn_pallas", (query, key, value),
                   dict(dropout=dropout, causal=causal, training=training,
                        use_pallas=use_pallas, generator=generator))
    return (out, None) if return_softmax else out


def _flash_attention_fwd(query, key, value, dropout=0.0, causal=False,
                         training=True, use_pallas=None, generator=None):
    rate = float(dropout) if training else 0.0
    seed = _draw_seed(rate, generator)
    if use_pallas:
        out = tag_activation(
            FlashAttention.apply(query.contiguous(), key.contiguous(),
                                 value.contiguous(), bool(causal), rate,
                                 seed), ATTN_CONTEXT)
    else:
        # None: the gate inside the sdpa route; False: the sdpa route,
        # which is the same routing
        out = _attend(query, key, value, None, causal, rate, seed)
    return out


register_op("flash_attn_pallas", _flash_attention_fwd)


def flash_attention_qkv_packed(qkv, num_heads: int, dropout: float = 0.0,
                               causal: bool = True, training: bool = True,
                               generator=None):
    """Attention on the fused projection output ``[B, L, 3*H*D]`` -> the
    packed context ``[B, L, H*D]``. Through the packed flash kernels
    (``FlashPairPacked``) when the gate passes and the pair layout takes
    the head size; else the heads are split and take the ``[B, L, H, D]``
    route of ``scaled_dot_product_attention`` (the flash kernels on the
    card, as the JAX package's fallback reaches its Pallas kernel; the
    plain chain below the gate).

    In training at ``dropout > 0`` one seed is drawn from ``generator`` (a
    CPU ``torch.Generator``; the global chain without one) and every route
    drops the same elements under it."""
    return apply_op("flash_attn_qkv_packed", (qkv,),
                    dict(num_heads=num_heads, dropout=dropout, causal=causal,
                         training=training, generator=generator))


def _flash_qkv_packed_fwd(qkv, num_heads, dropout=0.0, causal=True,
                          training=True, generator=None):
    rate = float(dropout) if training else 0.0
    seed = _draw_seed(rate, generator)
    b, L, width = qkv.shape
    d = width // (3 * num_heads)
    if flash_path_available(L, d, qkv) and pair_layout_supported(
            d, num_heads, L):
        return tag_activation(
            FlashPairPacked.apply(qkv.contiguous(), num_heads, causal, rate,
                                  seed), ATTN_CONTEXT)
    hd = num_heads * d
    q, k, v = (qkv[:, :, i * hd:(i + 1) * hd].reshape(b, L, num_heads, d)
               for i in range(3))
    return _attend(q, k, v, None, causal, rate, seed).reshape(b, L, hd)


register_op("flash_attn_qkv_packed", _flash_qkv_packed_fwd)
