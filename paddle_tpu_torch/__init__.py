"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu``.

The JAX package stays the reference; this package does the same work on
an NVIDIA H100. Plain tensor code is PyTorch, and every Pallas kernel of
the JAX package on a ported path is a hand-written Hopper kernel
(``kernels/``, CUDA sources in ``csrc/``), built with ``nvcc`` at first
use. Entry points run on the GPU unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs instead.

Ported so far: GPT inference and training at its dropout
(``models.GPTForCausalLM``: attention through the packed flash-attention
forward and backward kernels with in-kernel dropout, the dropout kernel,
the loss), BERT pretraining (``models.BertForPreTraining``: the pair
kernels bidirectional at head_dim 64, the fused add-dropout-LayerNorm
kernels, MLM + NSP losses), LLaMA inference and training
(``models.LlamaForCausalLM``: RoPE, RMSNorm, SwiGLU, grouped-query
attention through the ``[B, L, H, D]`` flash kernels), ``optimizer.AdamW``
with fp32 masters, ``jit.TrainStep`` (eager steps), and the serving
engine over GPT or LLaMA (``serving.DecodeEngine``: paged or row cache,
speculative decoding with three drafters, int8 weight-only serving through
``quantization.Int8Linear``; its steps CUDA graphs on the card). Every dropout draws
its seed from the model's CPU generator and its bits from one Philox
stream keyed on the element, so the card and the CPU drop the same
elements. ``seed``, ``get_rng_state`` and ``set_rng_state`` drive the
global chain that ``F.dropout``, ``nn.Dropout`` and the attention
functionals draw from when no generator is given (``core/random.py``).
``convert.load_paddle_state`` carries weights over from a ``paddle_tpu``
model. Training takes the JAX package's single-card knobs: activation
recompute on GPT and LLaMA (``recompute_granularity`` "full", "dots" or
"selective", ``distributed.fleet.recompute``), gradient accumulation and
a ``GradScaler`` in ``TrainStep``, ``nn.ClipGradBy*`` as ``grad_clip``,
``regularizer.L2Decay`` and AdamW's ``apply_decay_param_fun``, and
``amp.auto_cast`` / ``amp.decorate``. ``monitor`` is the telemetry plane
(metrics, JSONL records, spans, goodput and MFU, model health), wired into
``TrainStep`` and ``DecodeEngine``; ``PADDLE_MONITOR=path`` turns it on at
import.
"""
from . import (amp, core, distributed, jit, kernels, models, monitor, nn,
               optimizer, quantization, regularizer, serving)
from .core.random import get_rng_state, seed, set_rng_state
from .jit import TrainStep
from .models import (BertConfig, BertForPreTraining, GPTConfig,
                     GPTForCausalLM, LlamaConfig, LlamaForCausalLM, bert_base,
                     llama_7b)
from .serving import DecodeEngine

__all__ = ["amp", "core", "distributed", "jit", "kernels", "models",
           "monitor", "nn",
           "optimizer", "quantization", "regularizer", "serving",
           "BertConfig", "BertForPreTraining", "bert_base", "GPTConfig",
           "GPTForCausalLM", "LlamaConfig", "LlamaForCausalLM", "llama_7b",
           "DecodeEngine", "TrainStep", "seed", "get_rng_state",
           "set_rng_state"]

monitor._maybe_enable_from_env()
