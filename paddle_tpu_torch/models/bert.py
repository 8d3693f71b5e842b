"""BERT encoder with MLM + NSP pretraining heads (counterpart of
``paddle_tpu/models/bert.py``; BASELINE.md config 2).

Post-LN transformer encoder per the original BERT recipe. On the packed
path each layer runs: the fused qkv projection, attention on it through the
pair flash kernels (bidirectional, head_dim 64: two heads a 128-wide
block in the JAX package's terms) with in-kernel attention dropout, the
output projection, then the fused residual epilogue ``LayerNorm(x +
dropout(attn))`` (``F.add_dropout_ln``: the fused kernels where the width
is a multiple of 128), the tanh-GELU FFN and a second fused epilogue. The
embeddings' sum goes through a LayerNorm and the dropout kernel. Every
dropout draws its seed from the model's generator.

Padded batches (``seq_lens`` ``[B]``, the valid-token count of each row,
or an additive ``attn_mask``) take the JAX package's other branch: the qkv
projection is viewed as ``[B, S, 3, H, D]`` and its q, k, v go to
``F.scaled_dot_product_attention`` with ``kv_lens=seq_lens``, which on the
card runs the ``[B, L, H, D]`` flash kernels with the lengths and
in-kernel dropout (an ``attn_mask`` takes the plain softmax chain, as in
the JAX package). Positions past a length still compute (their queries
attend the valid keys); the loss ignores them through the -100 labels.

Parameter names are the JAX package's, so ``convert.load_paddle_state``
maps them one to one (``torch.nn.Linear`` weights transposed; the tied
``word_embeddings`` is an ``nn.Embedding``, kept as it is).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.random import check_model_generator, make_generator
from ..nn import Dropout
from ..nn import functional as F
from .gpt import DROPOUT_STREAM, _lm_head_ce

__all__ = ["BertConfig", "bert_base", "bert_tiny", "BertEmbeddings",
           "BertLayer", "BertModel", "BertForPreTraining"]


@dataclass
class BertConfig:
    vocab_size: int = 30528            # 30522 padded to a multiple of 64
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02


def bert_base(**overrides) -> BertConfig:
    """BERT-base (110 M parameters): the defaults of ``BertConfig``."""
    return BertConfig(**overrides)


def bert_tiny(**overrides) -> BertConfig:
    """Tiny config for tests (the JAX package's ``bert_tiny``)."""
    cfg = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position_embeddings=128)
    cfg.update(overrides)
    return BertConfig(**cfg)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, generator=None):
        super().__init__()
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.layer_norm = nn.LayerNorm(h, eps=config.layer_norm_epsilon)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)[None, :]
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + type_embedding(token_type_ids,
                                       self.token_type_embeddings.weight)
        return self.dropout(self.layer_norm(emb))


def type_embedding(token_type_ids, weight):
    """The token-type rows of ``weight`` (``[type_vocab_size, hidden]``) as
    the product of a one-hot matrix with it: the lookup's values bit for
    bit, and a gradient summed by a GEMM in a fixed order. torch's
    embedding backward sums a row's lookups on CUDA in an order that can
    change between identical calls when a few rows take every token (two
    rows over a 64 x 512 batch), and the captured step is held bit for bit
    to the eager one."""
    one_hot = torch.nn.functional.one_hot(token_type_ids, weight.shape[0])
    return one_hot.to(weight.dtype) @ weight


class BertLayer(nn.Module):
    """Post-LN encoder block (attention -> add & norm -> FFN -> add &
    norm): the packed path without masks, the ``[B, L, H, D]`` path with
    ``seq_lens`` or ``attn_mask``."""

    def __init__(self, config: BertConfig, generator=None):
        super().__init__()
        h = config.hidden_size
        eps = config.layer_norm_epsilon
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.qkv_proj = nn.Linear(h, 3 * h)
        self.out_proj = nn.Linear(h, h)
        self.attn_norm = nn.LayerNorm(h, eps=eps)
        self.fc_in = nn.Linear(h, config.intermediate_size)
        self.fc_out = nn.Linear(config.intermediate_size, h)
        self.ffn_norm = nn.LayerNorm(h, eps=eps)
        self.hidden_dropout_p = config.hidden_dropout_prob
        self.attn_dropout_p = config.attention_dropout_prob
        self.generator = generator

    def forward(self, x, attn_mask=None, seq_lens=None):
        qkv = self.qkv_proj(x)
        if attn_mask is None and seq_lens is None:
            # packed path: attention reads the projection output in place
            attn = F.flash_attention_qkv_packed(
                qkv, self.num_heads, dropout=self.attn_dropout_p,
                causal=False, training=self.training,
                generator=self.generator)
        else:
            b, s, h = x.shape
            q, k, v = qkv.reshape(b, s, 3, self.num_heads,
                                  self.head_dim).unbind(2)
            attn = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout_p,
                training=self.training, kv_lens=seq_lens,
                generator=self.generator).reshape(b, s, h)
        x = F.add_dropout_ln(x, self.out_proj(attn), self.attn_norm.weight,
                             self.attn_norm.bias, p=self.hidden_dropout_p,
                             epsilon=self.attn_norm.eps,
                             training=self.training, generator=self.generator)
        ffn = self.fc_out(nn.functional.gelu(self.fc_in(x),
                                             approximate="tanh"))
        return F.add_dropout_ln(x, ffn, self.ffn_norm.weight,
                                self.ffn_norm.bias, p=self.hidden_dropout_p,
                                epsilon=self.ffn_norm.eps,
                                training=self.training,
                                generator=self.generator)


class BertModel(nn.Module):
    """Embeddings, the encoder layers and the pooler: ``forward`` returns
    ``(sequence output [B, S, H], pooled [B, H])``. ``generator`` (a CPU
    ``torch.Generator``) feeds every dropout; training at a positive rate
    without one raises."""

    def __init__(self, config: BertConfig, generator=None):
        super().__init__()
        self.config = config
        self.generator = generator
        self.embeddings = BertEmbeddings(config, generator)
        self.encoder = nn.ModuleList(BertLayer(config, generator)
                                     for _ in range(config.num_layers))
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None,
                seq_lens=None):
        # seq_lens ([B] int): per-sequence valid-token counts, the
        # structured (flash-kernel) form of a [B, 1, 1, S] padding attn_mask
        check_model_generator(self, self.generator,
                              self.config.hidden_dropout_prob,
                              self.config.attention_dropout_prob)
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.encoder:
            x = layer(x, attn_mask, seq_lens)
        return x, torch.tanh(self.pooler(x[:, 0]))


class BertForPreTraining(nn.Module):
    """MLM (decoder tied to ``word_embeddings``, plus ``decoder_bias``) and
    NSP heads on ``BertModel``.

    ``forward(input_ids, token_type_ids, attn_mask, masked_lm_labels,
    next_sentence_labels, seq_lens)`` (a padded batch passes ``seq_lens``
    [B] or an additive ``attn_mask``) returns ``(mlm_logits [B, S, V],
    nsp_logits [B, 2])`` without labels; with ``masked_lm_labels`` ([B, S],
    -100 off the masked positions) the loss: the fp32 head + cross-entropy
    over every position (``_lm_head_ce`` with the bias; the ``[B, S, V]``
    logits are not returned), plus the NSP cross-entropy when
    ``next_sentence_labels`` is given.

    ``device`` defaults to the GPU (raises without CUDA; ``device="cpu"``
    for the plain path). Weights are drawn on the CPU from a generator
    seeded with ``seed`` as the JAX package initialises them: every matrix
    of ``BertModel`` N(0, initializer_range), the heads' ``transform`` and
    ``nsp_head`` weights XavierUniform (``nn.Linear``'s default there),
    biases 0, LayerNorm 1; then moved and cast to ``dtype``; the dropouts
    draw from ``self.generator``, seeded with ``seed ^ DROPOUT_STREAM``."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.generator = make_generator(seed ^ DROPOUT_STREAM)
        self.bert = BertModel(config, self.generator)
        h = config.hidden_size
        self.transform = nn.Linear(h, h)
        self.transform_norm = nn.LayerNorm(h, eps=config.layer_norm_epsilon)
        self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size))
        self.nsp_head = nn.Linear(h, 2)
        self._init_weights(make_generator(seed))
        self.to(device=dev, dtype=convert_dtype(dtype))

    # the heads' matrices keep nn.Linear's default init in the JAX package
    # (BertModel._init_weights covers only BertModel's parameters)
    _XAVIER = ("transform.weight", "nsp_head.weight")

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator):
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name in self._XAVIER:
                fan_out, fan_in = p.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                p.uniform_(-bound, bound, generator=gen)
            elif p.ndim >= 2:
                p.normal_(0.0, std, generator=gen)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None,
                masked_lm_labels=None, next_sentence_labels=None,
                seq_lens=None):
        seq_out, pooled = self.bert(input_ids, token_type_ids, attn_mask,
                                    seq_lens)
        x = self.transform_norm(nn.functional.gelu(self.transform(seq_out),
                                                   approximate="tanh"))
        nsp_logits = self.nsp_head(pooled)
        word = self.bert.embeddings.word_embeddings.weight
        if masked_lm_labels is None:
            mlm_logits = nn.functional.linear(x, word, self.decoder_bias)
            return mlm_logits, nsp_logits
        loss = _lm_head_ce(x, word, masked_lm_labels, self.decoder_bias)
        if next_sentence_labels is not None:
            loss = loss + nn.functional.cross_entropy(
                nsp_logits.float(), next_sentence_labels.reshape(-1).long())
        return loss
