"""Transformer layers (counterpart of ``paddle_tpu/nn/layers_transformer.py``),
batch-first ``[B, L, D]``.

Attention routes as in the JAX package: ``MultiHeadAttention`` calls
``F.scaled_dot_product_attention`` on ``[B, L, H, Dh]``; with no
``attn_mask`` that is the flash kernels on the card (past the gate:
``L >= 128``, ``Dh >= 64``), with their in-kernel attention dropout, and
with a mask (made additive by ``_convert_attention_mask``) the softmax
chain. The encoder layer's three ``nn.Dropout``s run the dropout kernel.
"""
from __future__ import annotations

import collections
import copy
import math

import torch

from ..core.dtype import convert_dtype
from ..core.tensor import wrap_outputs
from ..ops import concat, full, reshape, triu, zeros
from . import functional as F
from .layer import Layer, LayerList
from .layers_common import Dropout, Linear
from .layers_norm_act_loss import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True keeps) -> additive (0 kept, -1e9 dropped; -1e4 in
    fp16); an additive mask cast to ``dtype``."""
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        big_neg = -1e4 if convert_dtype(dtype) == torch.float16 else -1e9
        return (1.0 - attn_mask.astype(dtype)) * big_neg
    return attn_mask.astype(dtype)


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])
    # fixed [B, max_length, H, Dh] buffers written at ``pos``: a decode loop
    # over it keeps its shapes (the concat Cache grows every token)
    StaticDecodeCache = collections.namedtuple("StaticDecodeCache",
                                               ["k", "v", "pos"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.need_weights = need_weights
        self.dropout = dropout
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        """``[B, L, D]`` -> ``[B, L, H, Dh]``."""
        return reshape(x, [x.shape[0], x.shape[1], self.num_heads,
                           self.head_dim])

    def gen_cache(self, key, value=None, type=None, max_length=None):
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        b = key.shape[0]
        if type == MultiHeadAttention.StaticDecodeCache:
            if max_length is None:
                raise ValueError(
                    "gen_cache(type=StaticDecodeCache) needs max_length= "
                    "(the preallocated buffer's fixed decode horizon)")
            shape = [b, int(max_length), self.num_heads, self.head_dim]
            return self.StaticDecodeCache(zeros(shape, key.dtype),
                                          zeros(shape, key.dtype), 0)
        shape = [b, 0, self.num_heads, self.head_dim]
        return self.Cache(zeros(shape, key.dtype), zeros(shape, key.dtype))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        if isinstance(cache, self.StaticDecodeCache):
            return self._forward_static_decode(query, key, value, attn_mask,
                                               cache)
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = concat([cache.k, k], axis=1)
                v = concat([cache.v, v], axis=1)
                cache = self.Cache(k, v)
        mask = _convert_attention_mask(attn_mask, "float32")
        out = F.scaled_dot_product_attention(
            q, k, v, mask, self.dropout if self.training else 0.0)
        out = reshape(out, [out.shape[0], out.shape[1], self.embed_dim])
        out = self.out_proj(out)
        if cache is not None and not isinstance(cache, self.StaticCache):
            return (out, None, cache) if self.need_weights else (out, cache)
        if self.need_weights:
            return out, None
        return out

    def _forward_static_decode(self, query, key, value, attn_mask, cache):
        """Write this chunk's K/V at ``cache.pos`` into the fixed buffers
        and attend causally over every cached position up to each query's
        own (fp32 logits and softmax, inference only, as the JAX
        package's). The cache comes back with ``pos`` advanced."""
        if attn_mask is not None:
            raise ValueError(
                "StaticDecodeCache implies causal masking over the cache "
                "cursor; an explicit attn_mask is not supported")
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        pos = int(cache.pos)
        with torch.no_grad():
            k_buf = cache.k.as_subclass(torch.Tensor).clone()
            v_buf = cache.v.as_subclass(torch.Tensor).clone()
            s = q.shape[1]
            k_buf[:, pos:pos + s] = k.as_subclass(torch.Tensor).to(
                k_buf.dtype)
            v_buf[:, pos:pos + s] = v.as_subclass(torch.Tensor).to(
                v_buf.dtype)
            qv = q.as_subclass(torch.Tensor)
            m = k_buf.shape[1]
            scores = torch.einsum("bqnd,bknd->bnqk", qv.float(),
                                  k_buf.float()) / math.sqrt(self.head_dim)
            key_pos = torch.arange(m, device=qv.device)[None, None, None, :]
            q_pos = (pos + torch.arange(s, device=qv.device))[
                None, None, :, None]
            scores = torch.where(key_pos <= q_pos, scores,
                                 torch.full_like(scores, -1e30))
            ctx = torch.einsum("bnqk,bknd->bqnd", torch.softmax(scores, -1),
                               v_buf.float()).to(qv.dtype)
        out = self.out_proj(wrap_outputs(ctx.reshape(
            qv.shape[0], s, self.embed_dim)))
        new_cache = self.StaticDecodeCache(wrap_outputs(k_buf),
                                           wrap_outputs(v_buf), pos + s)
        if self.need_weights:
            return out, None, new_cache
        return out, new_cache


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src, type=None, max_length=None):
        return self.self_attn.gen_cache(src, type=type, max_length=max_length)


class TransformerEncoder(Layer):
    """``num_layers`` deep copies of ``encoder_layer`` (the first is the
    layer itself), then ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src, type=None, max_length=None):
        return [layer.gen_cache(src, type=type, max_length=max_length)
                for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache = None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        # the cross-attention's static cache holds K/V over ``memory``
        static_cache = None if cache is None else cache[1]
        tgt = self.cross_attn(tgt, memory, memory, memory_mask, static_cache)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if cache is None:
            return tgt
        return tgt, (incremental_cache, static_cache)

    def gen_cache(self, memory, type=None, max_length=None):
        incremental = self.self_attn.gen_cache(memory, type=type,
                                               max_length=max_length)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False, type=None, max_length=None):
        return [layer.gen_cache(memory, type=type, max_length=max_length)
                for layer in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        mask = full([length, length], 0.0, "float32")
        upper = triu(full([length, length], float("-inf"), "float32"),
                     diagonal=1)
        return mask + upper
