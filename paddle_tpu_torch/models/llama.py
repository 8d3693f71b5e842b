"""LLaMA decoder family (counterpart of ``paddle_tpu/models/llama.py``):
RoPE + RMSNorm + SwiGLU + grouped-query attention.

Ported so far: the uncached forward (attention through the ``[B, L, H, D]``
flash kernels on the GPU, forward and backward, with GQA), the loss
(``LlamaForCausalLM.forward(ids, labels)``) for training, and the
paged-KV cached forward that ``serving.DecodeEngine`` drives. Recompute,
``layer_subset``, tensor parallelism and ``generate()`` come later and
raise naming their ROADMAP item.

``torch.nn.Linear`` keeps its weight as ``[out, in]`` where the JAX package
keeps ``[in, out]``; ``convert.py`` transposes between them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.random import make_generator
from ..nn import RMSNorm
from ..nn import functional as F
from .gpt import _lm_head_ce, _paged_kv_update

__all__ = ["LlamaConfig", "llama_7b", "llama_tiny", "rope", "LlamaAttention",
           "LlamaMLP", "LlamaBlock", "LlamaModel", "LlamaForCausalLM",
           "shard_llama_tp"]


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 0          # 0 -> = num_heads (MHA); < heads -> GQA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    recompute_granularity: str = "none"

    def __post_init__(self):
        if self.num_kv_heads == 0:
            self.num_kv_heads = self.num_heads
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {self.num_heads} is not a multiple "
                             f"of num_kv_heads {self.num_kv_heads}")
        if self.recompute_granularity != "none":
            raise _unported("activation recompute", "Queue 1, item 5")


def llama_7b(**overrides) -> LlamaConfig:
    """LLaMA-7B's widths: vocab 32000, hidden 4096, FFN 11008, 32 blocks of
    32 heads of 128."""
    cfg = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
               num_layers=32, num_heads=32)
    cfg.update(overrides)
    return LlamaConfig(**cfg)


def llama_tiny(**overrides) -> LlamaConfig:
    """Tiny config for tests."""
    cfg = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4, num_kv_heads=2,
               max_position_embeddings=128)
    cfg.update(overrides)
    return LlamaConfig(**cfg)


def rope(q, k, pos=None, theta: float = 10000.0):
    """Rotary embedding on q, k ``[B, S, H, D]`` in the interleaved-pair
    form (pairs ``x[..., ::2]``, ``x[..., 1::2]``, not ``rotate_half``),
    computed in fp32 and cast back: the JAX package's ``_rope_fwd``. ``pos``
    offsets the positions: None (0), a scalar (the chunk starts there), or
    a ``[B]`` tensor (each serving slot at its own depth)."""
    s, d = q.shape[1], q.shape[3]
    ar = torch.arange(s, dtype=torch.float32, device=q.device)
    if pos is None:
        p = ar                                            # [S]
    elif torch.is_tensor(pos) and pos.dim() == 1:
        p = pos.to(torch.float32)[:, None] + ar           # [B, S]
    else:
        p = float(pos) + ar
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=q.device) / d)
    ang = p[..., None] * inv                    # [S, D/2] or [B, S, D/2]
    if ang.dim() == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]

    def rot(x):
        xf = x.float()
        x1, x2 = xf[..., ::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return out.reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        hidden = config.hidden_size
        self.num_heads = config.num_heads
        self.num_kv = config.num_kv_heads
        self.head_dim = hidden // config.num_heads
        self.theta = config.rope_theta
        kv = self.num_kv * self.head_dim
        self.q_proj = nn.Linear(hidden, hidden, bias=False)
        self.k_proj = nn.Linear(hidden, kv, bias=False)
        self.v_proj = nn.Linear(hidden, kv, bias=False)
        self.o_proj = nn.Linear(hidden, hidden, bias=False)

    def _qkv(self, x, pos=None):
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.num_kv, self.head_dim)
        v = self.v_proj(x).view(b, s, self.num_kv, self.head_dim)
        q, k = rope(q, k, pos, self.theta)
        return q, k, v

    def forward(self, x, kv_cache=None):
        if kv_cache is not None:
            return self._forward_cached(x, kv_cache)
        b, s, h = x.shape
        q, k, v = self._qkv(x)
        # GQA below the functional API: the kernels map q heads onto their
        # KV head, so repeated K/V never exists; the context comes back
        # [b, s, H, D], which o_proj reads without a copy
        out = F.flash_attention(q, k, v, causal=True, training=self.training)
        return self.o_proj(out.reshape(b, s, h))

    def _forward_cached(self, x, kv_cache):
        """Paged KV-cache attention (serving): RoPE at the absolute (per-row)
        positions, this call's K/V written at the cursor through the block
        table, and each query attending every cached position <= its own
        with the q heads folded onto their KV head (``bqkgd,bmkd->bkgqm``),
        softmax in fp32. ``kv_cache`` is ``(pool_k, pool_v, table, pos,
        write_end)`` over ``[NB, BS, n_kv, hd]`` pools; see
        ``gpt._paged_kv_update``."""
        if len(kv_cache) != 5:
            raise _unported("the contiguous (k_buf, v_buf, pos) cache, which "
                            "comes with generate(),", "Queue 1, item 7")
        b, s, h = x.shape
        nkv, hd = self.num_kv, self.head_dim
        pos = kv_cache[3]
        q, k, v = self._qkv(x, pos)
        k_buf, v_buf = _paged_kv_update(kv_cache, k, v)
        ar = torch.arange(s, device=x.device)
        if torch.is_tensor(pos) and pos.dim() == 1:
            q_pos = (pos[:, None] + ar)[:, None, None, :, None]
        else:
            q_pos = (pos + ar)[None, None, None, :, None]
        m = k_buf.shape[1]
        qg = q.reshape(b, s, nkv, self.num_heads // nkv, hd)
        scores = torch.einsum("bqkgd,bmkd->bkgqm", qg.float(),
                              k_buf.float()) / math.sqrt(hd)
        key_pos = torch.arange(m, device=x.device)[None, None, None, None, :]
        scores = torch.where(key_pos <= q_pos, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bkgqm,bmkd->bqkgd", probs,
                           v_buf.float()).to(q.dtype)
        return self.o_proj(ctx.reshape(b, s, h))


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        hidden, inter = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(hidden, inter, bias=False)
        self.up_proj = nn.Linear(hidden, inter, bias=False)
        self.down_proj = nn.Linear(inter, hidden, bias=False)

    def forward(self, x):
        return self.down_proj(nn.functional.silu(self.gate_proj(x))
                              * self.up_proj(x))


class LlamaBlock(nn.Module):
    """Pre-RMSNorm decoder block."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, epsilon=eps)
        self.self_attn = LlamaAttention(config)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                epsilon=eps)
        self.mlp = LlamaMLP(config)

    def forward(self, x, kv_cache=None):
        x = x + self.self_attn(self.input_layernorm(x), kv_cache=kv_cache)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size)
        self.layers = nn.ModuleList(LlamaBlock(config)
                                    for _ in range(config.num_layers))
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps)

    def forward(self, input_ids, kv_caches=None, start_pos=None,
                write_end=None, layer_subset=None):
        """Hidden states ``[B, S, hidden]`` after the final RMSNorm.

        With ``kv_caches`` (one ``(pool_k, pool_v, table)`` per block) the
        blocks run the paged cached attention at ``start_pos`` (an int, or
        a ``[B]`` tensor of per-row cursors), writing K/V in place below
        ``write_end`` (default ``start_pos + S``)."""
        if layer_subset is not None:
            raise _unported("layer_subset (the early-exit drafter's shallow "
                            "pass)", "Queue 1, item 7")
        x = self.embed_tokens(input_ids)
        if kv_caches is None:
            for block in self.layers:
                x = block(x)
            return self.norm(x)
        p0 = 0 if start_pos is None else start_pos
        we = write_end if write_end is not None \
            else p0 + input_ids.shape[1]
        for block, (pk, pv, table) in zip(self.layers, kv_caches):
            x = block(x, kv_cache=(pk, pv, table, p0, we))
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """LM head on LlamaModel (untied by default).

    ``device`` defaults to the GPU (``core.device.resolve_device``: raises
    without CUDA; pass ``device="cpu"`` for the plain CPU path). The model
    is built on its device in its type and its weights are drawn there,
    from a generator on that device seeded with ``seed``: a 7B model never
    passes through host memory. The same seed gives other weights on the
    card than on the CPU; carry weights between them with
    ``load_state_dict`` or ``convert.load_paddle_state``. The init is the
    JAX package's: every matrix (embedding and head included) ~ N(0,
    std), ``o_proj``/``down_proj`` scaled by 1/sqrt(2L), RMSNorm weights
    ones."""

    def __init__(self, config: LlamaConfig, *, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        with torch.device("meta"):       # shapes only: nothing allocated
            self.model = LlamaModel(config)
            self.lm_head = None if config.tie_word_embeddings else \
                nn.Linear(config.hidden_size, config.vocab_size, bias=False)
        self.to(dtype=convert_dtype(dtype))
        self.to_empty(device=dev)
        self._init_weights(make_generator(seed, dev))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator):
        cfg = self.config
        std = cfg.initializer_range
        resid = std / math.sqrt(2.0 * cfg.num_layers)
        for name, p in self.named_parameters():
            if p.ndim >= 2:
                scale = resid if name.endswith(("o_proj.weight",
                                                "down_proj.weight")) else std
                p.normal_(0.0, scale, generator=gen)
            else:
                p.fill_(1.0)

    @property
    def head_weight(self) -> torch.Tensor:
        """The LM head's ``[vocab, hidden]`` weight (tied: the embedding)."""
        return self.model.embed_tokens.weight if self.lm_head is None \
            else self.lm_head.weight

    def forward(self, input_ids, labels=None):
        """Logits ``[B, S, vocab]`` in the parameter type; with ``labels``
        ``(None, loss)``: the next-token cross-entropy from the SHIFTED
        hidden states (``hidden[:, :-1]`` against ``labels[:, 1:]``) through
        ``_lm_head_ce``, as the JAX package computes it."""
        hidden = self.model(input_ids)
        if labels is not None:
            return None, _lm_head_ce(hidden[:, :-1], self.head_weight,
                                     labels[:, 1:])
        return nn.functional.linear(hidden, self.head_weight)

    def enable_recompute(self, granularity="selective", interval: int = 1):
        raise _unported("activation recompute", "Queue 1, item 5")

    def generate(self, *args, **kwargs):
        raise _unported("generate() (the contiguous-cache decode loop)",
                        "Queue 1, item 7")


def shard_llama_tp(model, mesh=None, axis: str = "model"):
    """Tensor-parallel placement of the JAX package; not ported."""
    raise _unported("tensor parallelism (shard_llama_tp)", "Queue 1, item 10")
