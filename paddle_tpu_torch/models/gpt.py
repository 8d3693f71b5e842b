"""GPT decoder-only LM (counterpart of ``paddle_tpu/models/gpt.py``).

Pre-LN transformer decoder with learned position embeddings, a tanh-GELU
MLP of 4x width and an LM head tied to the token embedding: the GPT-3
recipe, built from ``torch.nn`` layers. Ported so far: the uncached
forward (attention through the packed flash kernels on the GPU, forward
and backward), the loss (``GPTForCausalLM.forward(ids, labels)``, the JAX
package's ``lm_head_ce``), training at the config's dropout (the
embedding and residual dropouts through the dropout kernel, the attention
dropout inside the pair kernels, every mask from the model's generator),
and the paged-KV cached forward that ``serving.DecodeEngine`` drives.
Recompute, the scanned layer stack and tensor parallelism come later.

Layouts follow the JAX package at every public function: the fused
projection is ``[B, L, 3*H*D]`` with columns ``[q heads | k heads | v
heads]``, the attention context ``[B, L, H*D]``. ``torch.nn.Linear`` keeps
its weight as ``[out, in]`` where the JAX package keeps ``[in, out]``;
``convert.py`` transposes between them.
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

__all__ = ["GPTConfig", "gpt_tiny", "GPTAttention", "GPTMLP", "GPTBlock",
           "GPTModel", "GPTForCausalLM"]

# dropout generators are seeded apart from the init generator of the same
# seed: seed ^ this
DROPOUT_STREAM = 0x5DEECE66D


@dataclass
class GPTConfig:
    vocab_size: int = 50304            # 50257 padded to a multiple of 128
    hidden_size: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 2048
    intermediate_size: int = 0         # 0 -> 4 * hidden
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    scan_layers: bool = False
    recompute_granularity: str = "none"

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.scan_layers:
            raise NotImplementedError(
                "scan_layers: the scanned block stack is not ported yet "
                "(ROADMAP Queue 1, item 3)")
        if self.recompute_granularity != "none":
            raise NotImplementedError(
                "activation recompute is not ported yet (ROADMAP Queue 1, "
                "item 5)")


def gpt_tiny(**overrides) -> GPTConfig:
    """Tiny config for tests."""
    cfg = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_position_embeddings=128)
    cfg.update(overrides)
    return GPTConfig(**cfg)


def _paged_kv_update(kv_cache, k, v):
    """Paged-cache write + gather.

    ``kv_cache`` is ``(pool_k, pool_v, table, pos, write_end)``: per-layer
    ``[NB, BS, n_kv, hd]`` pools, a ``[B, mbs]`` int64 block table, the
    write cursor (a ``[B]`` tensor of per-slot cursors for decode, or an
    int for one slot's chunk) and the exclusive end of VALID new positions
    (same form). ``k``/``v`` are this call's projections ``[B, S, n_kv,
    hd]``.

    Each position p is written to ``(table[b, p // BS], p % BS)``;
    positions at or past ``write_end`` (padded chunk tails) or beyond the
    table width go to trash block 0, so padding never touches a live or
    shared block. The write is an in-place ``index_put_`` on the pools,
    where the JAX package donates the pools to its executable and XLA
    updates them in place; duplicate trash indices are harmless. The read
    gathers every row's blocks back into a contiguous ``[B, mbs*BS, n_kv,
    hd]`` view; the caller's causal mask hides the stale tail.
    """
    pool_k, pool_v, table, pos, write_end = kv_cache
    b, s = k.shape[:2]
    bs_blk = pool_k.shape[1]
    mbs = table.shape[1]
    ar = torch.arange(s, device=k.device)
    if torch.is_tensor(pos) and pos.dim() == 1:    # per-slot cursors
        wpos = pos[:, None] + ar[None, :]
        end = write_end[:, None]
    else:                                         # one slot's chunk
        wpos = (pos + ar)[None, :].expand(b, s)
        end = write_end
    lidx = torch.div(wpos, bs_blk, rounding_mode="floor")
    phys = torch.gather(table, 1, lidx.clamp(max=mbs - 1))
    phys = torch.where((wpos < end) & (lidx < mbs), phys, 0)   # -> trash
    off = wpos % bs_blk
    pool_k.index_put_((phys, off), k.to(pool_k.dtype))
    pool_v.index_put_((phys, off), v.to(pool_v.dtype))
    nkv, hd = pool_k.shape[2], pool_k.shape[3]
    k_view = pool_k[table].reshape(b, mbs * bs_blk, nkv, hd)
    v_view = pool_v[table].reshape(b, mbs * bs_blk, nkv, hd)
    return k_view, v_view


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, generator=None):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        self.qkv_proj = nn.Linear(config.hidden_size, 3 * config.hidden_size)
        self.out_proj = nn.Linear(config.hidden_size, config.hidden_size)
        self.dropout_p = config.attention_dropout_prob
        self.generator = generator

    def forward(self, x, kv_cache=None):
        if kv_cache is not None:
            return self._forward_cached(x, kv_cache)
        # packed path: the fused projection feeds the kernel directly and
        # the context comes back [b, s, h], no head split/merge
        out = F.flash_attention_qkv_packed(self.qkv_proj(x), self.num_heads,
                                           dropout=self.dropout_p,
                                           causal=True,
                                           training=self.training,
                                           generator=self.generator)
        return self.out_proj(out)

    def _forward_cached(self, x, kv_cache):
        """Paged KV-cache attention (serving): write this call's K/V at the
        cursor through the block table and attend each query over every
        cached position <= its own, softmax in fp32. ``kv_cache`` is
        ``(pool_k, pool_v, table, pos, write_end)``; see
        ``_paged_kv_update``."""
        if len(kv_cache) != 5:
            raise NotImplementedError(
                "the contiguous (k_buf, v_buf, pos) cache comes with "
                "generate() (ROADMAP Queue 1, item 7)")
        b, s, h = x.shape
        nh, hd = self.num_heads, self.head_dim
        q, k, v = self.qkv_proj(x).reshape(b, s, 3, nh, hd).unbind(2)
        pos = kv_cache[3]
        k_buf, v_buf = _paged_kv_update(kv_cache, k, v)
        ar = torch.arange(s, device=x.device)
        if torch.is_tensor(pos) and pos.dim() == 1:
            q_pos = (pos[:, None] + ar)[:, None, :, None]
        else:
            q_pos = (pos + ar)[None, None, :, None]
        m = k_buf.shape[1]
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(),
                              k_buf.float()) / math.sqrt(hd)
        key_pos = torch.arange(m, device=x.device)[None, None, None, :]
        scores = torch.where(key_pos <= q_pos, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs,
                           v_buf.float()).to(q.dtype)
        return self.out_proj(ctx.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.fc_in = nn.Linear(config.hidden_size, config.intermediate_size)
        self.fc_out = nn.Linear(config.intermediate_size, config.hidden_size)

    def forward(self, x):
        return self.fc_out(nn.functional.gelu(self.fc_in(x),
                                              approximate="tanh"))


class GPTBlock(nn.Module):
    """Pre-LN decoder block; the residual dropout after attention and after
    the MLP on the uncached path (the cached path serves: no dropout)."""

    def __init__(self, config: GPTConfig, generator=None):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln_1 = nn.LayerNorm(config.hidden_size, eps=eps)
        self.attn = GPTAttention(config, generator)
        self.ln_2 = nn.LayerNorm(config.hidden_size, eps=eps)
        self.mlp = GPTMLP(config)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)

    def forward(self, x, kv_cache=None):
        if kv_cache is not None:
            x = x + self.attn(self.ln_1(x), kv_cache=kv_cache)
            return x + self.mlp(self.ln_2(x))
        x = x + self.dropout(self.attn(self.ln_1(x)))
        return x + self.dropout(self.mlp(self.ln_2(x)))


class GPTModel(nn.Module):
    """Embeddings (with the embedding dropout), blocks and the final
    LayerNorm. ``generator`` (a CPU ``torch.Generator``) feeds every
    dropout; training at a positive rate without one raises."""

    def __init__(self, config: GPTConfig, generator=None):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size)
        self.wpe = nn.Embedding(config.max_position_embeddings,
                                config.hidden_size)
        self.generator = generator
        self.drop = Dropout(config.hidden_dropout_prob, generator=generator)
        self.h = nn.ModuleList(GPTBlock(config, generator)
                               for _ in range(config.num_layers))
        self.ln_f = nn.LayerNorm(config.hidden_size,
                                 eps=config.layer_norm_epsilon)

    def forward(self, input_ids, kv_caches=None, start_pos=None,
                write_end=None):
        """Hidden states ``[B, S, hidden]`` after the final LayerNorm.

        With ``kv_caches`` (one ``(pool_k, pool_v, table)`` per block) the
        blocks run the paged cached attention at ``start_pos`` (an int, or
        a ``[B]`` tensor of per-row cursors), writing K/V in place below
        ``write_end`` (default ``start_pos + S``)."""
        cfg = self.config
        b, s = input_ids.shape
        ar = torch.arange(s, device=input_ids.device)
        if kv_caches is None:
            check_model_generator(self, self.generator,
                                  cfg.hidden_dropout_prob,
                                  cfg.attention_dropout_prob)
            x = self.drop(self.wte(input_ids) + self.wpe(ar[None, :]))
            for block in self.h:
                x = block(x)
            return self.ln_f(x)
        p0 = 0 if start_pos is None else start_pos
        if torch.is_tensor(p0) and p0.dim() == 1:
            raw = p0[:, None] + ar[None, :]        # per-row cursors
        else:
            raw = (p0 + ar)[None, :]
        # clamp for the LEARNED table: a padded chunk tail can step past
        # it; valid positions are engine-validated < max_pos, so the clamp
        # only ever touches lanes whose writes go to the trash block
        pos_ids = raw.clamp(max=cfg.max_position_embeddings - 1)
        we = write_end if write_end is not None else p0 + s
        x = self.wte(input_ids) + self.wpe(pos_ids)
        for block, (pk, pv, table) in zip(self.h, kv_caches):
            x = block(x, kv_cache=(pk, pv, table, p0, we))
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """LM head on GPTModel.

    ``device`` defaults to the GPU (``core.device.resolve_device``: raises
    without CUDA; pass ``device="cpu"`` for the plain CPU path). Weights
    follow the GPT-3 init recipe, drawn from a ``torch.Generator`` seeded
    with ``seed``, then cast to ``dtype``. Every dropout draws its seeds
    from ``self.generator``, a CPU generator seeded with ``seed ^
    DROPOUT_STREAM`` (reseed it to replay a run's masks)."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.generator = make_generator(seed ^ DROPOUT_STREAM)
        self.gpt = GPTModel(config, self.generator)
        if config.tie_word_embeddings:
            self.lm_head = None                  # reuse wte
        else:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False)
        self._init_weights(make_generator(seed))
        self.to(device=dev, dtype=convert_dtype(dtype))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator):
        """GPT-2/3 init: every matrix ~ N(0, std), the residual-out
        projections scaled by 1/sqrt(2L); biases zero, LayerNorm ones."""
        cfg = self.config
        std = cfg.initializer_range
        resid = std / math.sqrt(2.0 * cfg.num_layers)
        for name, p in self.named_parameters():
            if p.ndim >= 2:
                scale = resid if name.endswith(("out_proj.weight",
                                                "fc_out.weight")) else std
                p.normal_(0.0, scale, generator=gen)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)

    @property
    def head_weight(self) -> torch.Tensor:
        """The LM head's ``[vocab, hidden]`` weight (tied: ``wte``)."""
        return self.gpt.wte.weight if self.lm_head is None \
            else self.lm_head.weight

    def forward(self, input_ids, labels=None):
        """Logits ``[B, S, vocab]`` in the parameter type; with ``labels``
        ``(None, loss)``: the next-token cross-entropy from the SHIFTED
        hidden states (``hidden[:, :-1]`` against ``labels[:, 1:]``, as the
        JAX package slices them) through ``_lm_head_ce``. The logits are
        not returned on the loss path."""
        hidden = self.gpt(input_ids)
        if labels is not None:
            return None, _lm_head_ce(hidden[:, :-1], self.head_weight,
                                     labels[:, 1:])
        return nn.functional.linear(hidden, self.head_weight)


def _lm_head_ce(hidden, weight, labels, bias=None, ignore_index: int = -100):
    """LM head + next-token cross-entropy (the JAX package's
    ``lm_head_ce``, ``paddle_tpu/models/gpt.py:34``): ``hidden [B, S, H]``
    (already shifted) against a ``[vocab, H]`` head weight, fp32 logits
    (plus ``bias [vocab]`` in fp32 where given: BERT's MLM decoder bias,
    ``has_bias``), ``logsumexp`` minus the gold logit per token, tokens
    labelled ``ignore_index`` zeroed, and the sum over ``max(n_valid, 1)``.

    The head runs on both operands upcast to fp32, which gives the same
    products and fp32 accumulation as the JAX op's bf16 inputs with
    ``preferred_element_type=float32``; it is the step's largest matrix
    product (PERF.md records its share)."""
    logits = hidden.float() @ weight.float().T
    if bias is not None:
        logits = logits + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    gold = logits.gather(-1, safe[..., None])[..., 0]
    per_tok = torch.where(valid, lse - gold, 0.0)
    n = valid.sum().clamp_min(1).to(per_tok.dtype)
    return per_tok.sum() / n


def _lm_head_logits(hidden_last, head_weight):
    """fp32 LM-head matmul over ``[B, hidden]`` last hidden states against
    a ``[vocab, hidden]`` head weight: the one definition the serving
    engine and any generation loop share, so greedy tokens cannot drift
    apart between them."""
    return hidden_last.float() @ head_weight.float().T


def _pick_token(logits):
    """Greedy pick over ``[B, V]`` logits (the first maximum, as
    ``jnp.argmax``). Sampling is not ported yet."""
    return torch.argmax(logits, dim=-1)
