"""GPT decoder-only LM (counterpart of ``paddle_tpu/models/gpt.py``).

Pre-LN transformer decoder with learned position embeddings, a tanh-GELU
MLP of 4x width and an LM head tied to the token embedding: the GPT-3
recipe, built from ``torch.nn`` layers. Ported so far: the uncached
forward (attention through the packed flash kernels on the GPU, forward
and backward), the loss (``GPTForCausalLM.forward(ids, labels)``, the JAX
package's ``lm_head_ce``), training at the config's dropout (the
embedding and residual dropouts through the dropout kernel, the attention
dropout inside the pair kernels, every mask from the model's generator),
the cached forward over a paged KV pool (``serving.DecodeEngine``) or
contiguous per-row buffers, the early-exit drafter's ``layer_subset``, and
``generate()`` (greedy or temperature +
top-k sampling; its one-token step is a fixed-shape program,
``core/programs.py``: a CUDA graph on the card), and activation recompute
in training (``recompute_granularity`` "full", "dots" or "selective" on
every ``recompute_interval``-th block, ``distributed.fleet.recompute``;
the tags of ``core.remat`` sit where the JAX package puts them). Every
cursor of the cached path may be device data, so a captured step reads it
at replay. The scanned layer stack and tensor parallelism come later.

Layouts follow the JAX package at every public function: the fused
projection is ``[B, L, 3*H*D]`` with columns ``[q heads | k heads | v
heads]``, the attention context ``[B, L, H*D]``. ``torch.nn.Linear`` keeps
its weight as ``[out, in]`` where the JAX package keeps ``[in, out]``;
``convert.py`` transposes between them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
from torch import nn

from ..core.amp_state import amp_op
from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.programs import ProgramRegistry, leaf_addresses, serving_mode
from ..core.random import check_model_generator, make_generator, next_seed
from ..core.remat import (ATTN_OUT, ATTN_QKV, MLP_HIDDEN,
                          normalize_granularity, tag_activation)
from ..distributed.fleet.recompute import recompute
from ..kernels.philox import sample_uniform
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
    remat: str = "none"                # legacy alias of recompute_granularity
    # activation recompute: "none" | "selective" | "dots" | "full" on every
    # recompute_interval-th block (core.remat.normalize_granularity)
    recompute_granularity: str = "none"
    recompute_interval: int = 1

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.scan_layers:
            raise NotImplementedError(
                "scan_layers: the scanned block stack is not ported yet "
                "(ROADMAP Queue 1, item 3)")
        if self.recompute_granularity == "none" and self.remat != "none":
            self.recompute_granularity = self.remat   # legacy spelling
        self.recompute_granularity, self.recompute_interval = \
            normalize_granularity(self.recompute_granularity,
                                  self.recompute_interval)


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
    int or 0-d tensor for one slot's chunk) and the exclusive end of VALID
    new positions (same form); no cursor is read on the host. ``k``/``v``
    are this call's projections ``[B, S, n_kv, hd]``.

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


def _contiguous_kv_update(kv_cache, k, v):
    """Contiguous-cache write (``generate()``): ``kv_cache`` is ``(k_buf,
    v_buf, pos)`` with ``[B, M, n_kv, hd]`` buffers, each batch row owning
    one row, and ``pos`` an int, a 0-d tensor (one cursor for the batch)
    or a ``[B]`` tensor (a cursor per row). This call's ``[B, S, n_kv,
    hd]`` K/V land in place at ``pos .. pos + S``; the buffers come back
    whole, and the caller's causal mask hides what lies past a query."""
    k_buf, v_buf, pos = kv_cache
    b, s = k.shape[:2]
    ar = torch.arange(s, device=k.device)
    if torch.is_tensor(pos) and pos.dim() == 1:    # per-row cursors
        idx = (torch.arange(b, device=k.device)[:, None], pos[:, None] + ar)
        k_buf.index_put_(idx, k.to(k_buf.dtype))
        v_buf.index_put_(idx, v.to(v_buf.dtype))
    else:
        k_buf.index_copy_(1, pos + ar, k.to(k_buf.dtype))
        v_buf.index_copy_(1, pos + ar, v.to(v_buf.dtype))
    return k_buf, v_buf


def _kv_update(kv_cache, k, v):
    """Write this call's K/V into either cache layout and return the
    ``[B, M, n_kv, hd]`` keys and values to attend, with the cursor:
    paged ``(pool_k, pool_v, table, pos, write_end)`` or contiguous
    ``(k_buf, v_buf, pos)``."""
    if len(kv_cache) == 5:
        return (*_paged_kv_update(kv_cache, k, v), kv_cache[3])
    return (*_contiguous_kv_update(kv_cache, k, v), kv_cache[2])


def _layer_cache(cache, pos, write_end):
    """One block's cache argument from a model-level cache entry: a paged
    ``(pool_k, pool_v, table)`` gains the cursor and the end of valid
    positions, a contiguous ``(k_buf, v_buf)`` the cursor."""
    return (*cache, pos, write_end) if len(cache) == 3 else (*cache, pos)


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
        qkv = tag_activation(self.qkv_proj(x), ATTN_QKV)
        out = F.flash_attention_qkv_packed(qkv, self.num_heads,
                                           dropout=self.dropout_p,
                                           causal=True,
                                           training=self.training,
                                           generator=self.generator)
        return tag_activation(self.out_proj(out), ATTN_OUT)

    def _forward_cached(self, x, kv_cache):
        """KV-cache attention (serving and ``generate()``): write this
        call's K/V at the cursor and attend each query over every cached
        position <= its own, softmax in fp32. ``kv_cache`` is paged,
        ``(pool_k, pool_v, table, pos, write_end)`` (``_paged_kv_update``),
        or contiguous, ``(k_buf, v_buf, pos)``
        (``_contiguous_kv_update``)."""
        b, s, h = x.shape
        nh, hd = self.num_heads, self.head_dim
        q, k, v = self.qkv_proj(x).reshape(b, s, 3, nh, hd).unbind(2)
        k_buf, v_buf, pos = _kv_update(kv_cache, k, v)
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
        return self.fc_out(nn.functional.gelu(
            tag_activation(self.fc_in(x), MLP_HIDDEN), approximate="tanh"))


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


def _run_blocks(model, blocks, x, layer_subset):
    """The uncached forward's block loop, shared by GPT and LLaMA: every
    block, or those whose index lies in ``layer_subset``, in order. In
    training with grad enabled, block ``i`` with ``i % recompute_interval
    == 0`` runs under ``recompute`` with the config's granularity as its
    policy (none: no block does)."""
    cfg = model.config
    gran = cfg.recompute_granularity
    use_rc = gran != "none" and model.training and torch.is_grad_enabled()
    for i, block in enumerate(blocks):
        if layer_subset is not None and i not in layer_subset:
            continue
        if use_rc and i % cfg.recompute_interval == 0:
            x = recompute(block, x, policy=gran)
        else:
            x = block(x)
    return x


def _enable_recompute(config, granularity, interval):
    """``enable_recompute``'s body: set the config's granularity and
    interval (``normalize_granularity``)."""
    config.recompute_granularity, config.recompute_interval = \
        normalize_granularity(granularity, interval)


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
                write_end=None, layer_subset=None):
        """Hidden states ``[B, S, hidden]`` after the final LayerNorm.

        With ``kv_caches`` (one ``(pool_k, pool_v, table)`` per block:
        paged, or one ``(k_buf, v_buf)``: contiguous) the blocks run the
        cached attention at ``start_pos`` (an int, a 0-d tensor, or a
        ``[B]`` tensor of per-row cursors), writing K/V in place (paged:
        below ``write_end``, default ``start_pos + S``).

        ``layer_subset`` (a set of block indices; uncached path only) runs
        just those blocks: the early-exit drafter's shallow pass over the
        same weights (``serving.spec.EarlyExitDrafter``)."""
        cfg = self.config
        b, s = input_ids.shape
        ar = torch.arange(s, device=input_ids.device)
        if kv_caches is None:
            check_model_generator(self, self.generator,
                                  cfg.hidden_dropout_prob,
                                  cfg.attention_dropout_prob)
            x = self.drop(self.wte(input_ids) + self.wpe(ar[None, :]))
            return self.ln_f(_run_blocks(self, self.h, x, layer_subset))
        if layer_subset is not None:
            raise ValueError("layer_subset runs on the uncached path only")
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
        for block, cache in zip(self.h, kv_caches):
            x = block(x, kv_cache=_layer_cache(cache, p0, we))
        return self.ln_f(x)

    def enable_recompute(self, granularity="selective", interval: int = 1):
        """Turn activation recompute on or off after construction:
        granularity "none" | "selective" | "dots" | "full" (True gives
        "full", False and None "none"), on every ``interval``-th block."""
        _enable_recompute(self.config, granularity, interval)
        return self


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

    def enable_recompute(self, granularity="selective", interval: int = 1):
        """See ``GPTModel.enable_recompute``."""
        self.gpt.enable_recompute(granularity, interval)
        return self

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

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 1.0, do_sample: bool = False,
                 top_k: int = 0, eos_token_id=None, seed=None,
                 max_length=None, use_engine: bool = False):
        """KV-cache decoding: ``[B, s0 + max_new_tokens]`` int64 token ids
        on the model's device, the prompt first (the JAX package's
        ``generate``).

        The prefill writes the prompt's K/V into contiguous ``[B, M, nh,
        hd]`` buffers (M = ``max_length``, else prompt + new tokens), then
        one-token steps decode the rest; after its EOS a row emits EOS, and
        the loop stops once every row has. Greedy by default;
        ``do_sample=True`` draws from softmax(logits / temperature),
        optionally cut to the ``top_k`` largest (``_pick_token``);
        ``seed=None`` draws the sampling seed from the global chain, so
        ``paddle_tpu_torch.seed`` makes it reproducible. On the card the
        step is a CUDA graph, captured once per (batch, M, sampling) and
        replayed. ``use_engine=True`` routes through
        ``serving.generate_via_engine`` (the paged engine): the same greedy
        tokens."""
        cfg = self.config
        if max_length and max_length > cfg.max_position_embeddings:
            # the LEARNED position table clamps past its end
            raise ValueError(
                f"max_length {max_length} exceeds the learned position "
                f"table ({cfg.max_position_embeddings}); positions past it "
                f"would silently clamp")
        if use_engine:
            from ..serving.engine import generate_via_engine
            return generate_via_engine(
                self, input_ids, max_new_tokens=max_new_tokens,
                temperature=temperature, do_sample=do_sample, top_k=top_k,
                eos_token_id=eos_token_id, seed=seed, max_length=max_length)
        return _generate_with_cache(
            self, self.gpt, cfg.num_layers, cfg.num_heads,
            cfg.hidden_size // cfg.num_heads, cfg.max_position_embeddings,
            input_ids=input_ids, max_new_tokens=max_new_tokens,
            temperature=temperature, do_sample=do_sample, top_k=top_k,
            eos_token_id=eos_token_id, seed=seed, max_length=max_length)


@amp_op("lm_head_ce")
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


def _pick_token(logits, key=None, do_sample: bool = False,
                temperature: float = 1.0, top_k: int = 0):
    """Greedy argmax or a temperature + top-k categorical draw over ``[B,
    V]`` fp32 logits: the JAX package's ``_pick_token``, shared by the
    engine and ``generate()``.

    Greedy is the first maximum (as ``jnp.argmax``) and reads no key.
    Sampling scales to ``lg = logits / max(temperature, 1e-6)``, masks
    ``lg < kth`` to -1e30 where ``kth`` is the ``top_k``-th largest value
    (every logit equal to it is kept: the JAX tie rule; ``top_k`` of 0 or
    at least V keeps all), and takes the Gumbel-max draw (what
    ``jax.random.categorical`` computes): ``argmax(lg + g)`` with ``g =
    -log(-log(u))``, ``u`` from ``philox.sample_uniform`` under ``key``,
    an int64 tensor ``(seed, step)`` on the logits' device, row b drawing
    from Philox row b. The same key gives the same draw on the card and on
    the CPU; the key is data, so a captured program draws under whatever
    seed and step it holds at replay."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    lg = logits / max(float(temperature), 1e-6)
    v = lg.shape[-1]
    if 0 < top_k < v:
        # the value of the k-th largest (topk's values are sort's): a
        # threshold, so ties with it stay in
        kth = torch.topk(lg, int(top_k), dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, -1e30, lg)
    u = sample_uniform(key, lg.shape[0], v)
    g = -torch.log(-torch.log(u))
    return torch.argmax(lg + g.to(lg.dtype), dim=-1)


def _resolve_decode_horizon(s0: int, max_new_tokens: int, max_length,
                            max_pos: int, seed, do_sample: bool):
    """The ``generate()`` front door shared by the eager loop and
    ``serving.generate_via_engine`` (the JAX package's): validate the token
    budget, size the KV horizon to the decode (``max_length``, else prompt
    + new tokens capped at the position horizon), and derive the sampling
    seed. Un-seeded sampling draws the seed from the global chain
    (``core.random.next_seed``), so ``paddle_tpu_torch.seed`` reproduces
    it; greedy reads no seed and never advances the chain."""
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    m = int(max_length or min(s0 + max_new_tokens, max_pos))
    if s0 + max_new_tokens > m:
        raise ValueError(f"prompt {s0} + max_new_tokens {max_new_tokens} "
                         f"exceeds max_length {m}")
    if seed is None:
        seed = next_seed() if do_sample else 0
    return m, _check_seed(seed)


def _check_seed(seed) -> int:
    """A sampling seed as an int: it keys Philox from an int64 tensor, so
    it must be a non-negative int64."""
    seed = int(seed)
    if not 0 <= seed < 1 << 63:
        raise ValueError(f"seed {seed} is not a non-negative int64")
    return seed


def _as_ids(input_ids, device) -> torch.Tensor:
    """``[B, S]`` token ids (a tensor, an array or nested lists) as int64
    on ``device``."""
    if not torch.is_tensor(input_ids):
        input_ids = torch.from_numpy(np.asarray(input_ids))
    ids = input_ids.to(device=device, dtype=torch.int64)
    if ids.dim() != 2:
        raise ValueError(f"input_ids must be [batch, seq], got shape "
                         f"{tuple(ids.shape)}")
    return ids


# generate() programs kept per model: the bound of the JAX package's
# lm._gen_cache
GEN_PROGRAMS = 8


def _gen_registry(lm) -> ProgramRegistry:
    """The model's ``generate()`` programs (made at first use, anew when
    the model moved to another device)."""
    dev = lm.head_weight.device
    reg = lm.__dict__.get("_gen_programs")
    if reg is None or reg.device != dev:
        reg = ProgramRegistry(dev, partial(serving_mode, lm),
                              limit=GEN_PROGRAMS)
        lm._gen_programs = reg
    return reg


class _GenState:
    """The static buffers of one ``generate()`` step program: per-layer
    contiguous K/V ``[B, M, n_kv, hd]``, the last token, the cursor, the
    EOS flags, the sampling key ``(seed, step)``, the EOS id and the
    output ``[B, M]`` (prompt, then generated tokens at their positions)."""

    def __init__(self, b, m, num_layers, n_kv_heads, head_dim, dtype,
                 device):
        def z(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.caches = [(z(b, m, n_kv_heads, head_dim, dtype=dtype),
                        z(b, m, n_kv_heads, head_dim, dtype=dtype))
                       for _ in range(num_layers)]
        self.tok, self.pos, self.done = z(b), z(), z(b, dtype=torch.bool)
        self.key, self.eos, self.out = z(2), z(), z(b, m)


def _generate_with_cache(lm, backbone, num_layers: int, n_kv_heads: int,
                         head_dim: int, max_pos: int, input_ids,
                         max_new_tokens, temperature, do_sample, top_k,
                         eos_token_id, seed, max_length):
    """The cached decode loop shared by GPT and LLaMA (the JAX package's
    ``_generate_with_cache``): see ``GPTForCausalLM.generate`` for the
    contract. ``backbone(ids, kv_caches=, start_pos=)`` takes one ``(k_buf,
    v_buf)`` per block and returns hidden states.

    The prefill runs eagerly (the prompt's shape varies). The one-token
    step is one program (``core/programs.py``) keyed on ``(B, M,
    sampling)``, at most ``GEN_PROGRAMS`` of them kept on the model: it
    reads the last token, the cursor, the key and the EOS flags from its
    buffers and advances them itself, so the host only replays it, and
    reads the flags once a step to stop early when an EOS id is given."""
    head = lm.head_weight
    ids = _as_ids(input_ids, head.device)
    b, s0 = ids.shape
    m, seed = _resolve_decode_horizon(s0, max_new_tokens, max_length,
                                      max_pos, seed, do_sample)
    if max_new_tokens == 0:
        return ids
    eos = -1 if eos_token_id is None else int(eos_token_id)

    def pick(logits, key):
        return _pick_token(logits, key, do_sample, temperature, top_k)

    def build():
        st = _GenState(b, m, num_layers, n_kv_heads, head_dim, head.dtype,
                       head.device)

        def step():
            if do_sample:
                st.key[1:].add_(1)           # this step's draw
            hidden = backbone(st.tok[:, None], kv_caches=st.caches,
                              start_pos=st.pos)
            nxt = pick(_lm_head_logits(hidden[:, -1], head), st.key)
            nxt = torch.where(st.done, st.eos, nxt)   # finished rows: EOS
            st.done.logical_or_(nxt == st.eos)
            st.out.index_copy_(1, (st.pos + 1).reshape(1), nxt[:, None])
            st.tok.copy_(nxt)
            st.pos.add_(1)
        return step, st

    reg = _gen_registry(lm)
    reg.validate(leaf_addresses(lm))
    sampling = (float(temperature), int(top_k)) if do_sample else None
    prog = reg.get((b, m, sampling), build)
    st = prog.state
    with serving_mode(lm):
        for kb, vb in st.caches:
            kb.zero_()
            vb.zero_()
        st.key.copy_(torch.tensor([seed, 0]))
        hidden = backbone(ids, kv_caches=st.caches, start_pos=0)
        tok0 = pick(_lm_head_logits(hidden[:, -1], head), st.key)
        st.out[:, :s0] = ids
        st.out[:, s0:] = max(eos, 0)
        st.out[:, s0] = tok0
        st.tok.copy_(tok0)
        st.pos.fill_(s0)
        st.eos.fill_(eos)
        torch.eq(tok0, eos, out=st.done)
    for _ in range(max_new_tokens - 1):
        prog()
        if eos >= 0 and bool(st.done.all()):
            break            # every row emitted EOS: the fill is EOS
    return st.out[:, :s0 + max_new_tokens].clone()
