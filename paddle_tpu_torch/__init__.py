"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu``.

The JAX package stays the reference; this package does the same work on
an NVIDIA H100. Plain tensor code is PyTorch, and every Pallas kernel of
the JAX package on a ported path is a hand-written Hopper kernel
(``kernels/``, CUDA sources in ``csrc/``), built with ``nvcc`` at first
use. Entry points run on the GPU unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs instead.

Ported so far: GPT inference and training at dropout 0
(``models.GPTForCausalLM``: attention through the packed flash-attention
forward and backward kernels, the loss), LLaMA inference and training
(``models.LlamaForCausalLM``: RoPE, RMSNorm, SwiGLU, grouped-query
attention through the ``[B, L, H, D]`` flash kernels), ``optimizer.AdamW``
with fp32 masters, ``jit.TrainStep`` (eager steps), and the paged serving
engine over either model (``serving.DecodeEngine``).
``convert.load_paddle_state`` carries weights over from a ``paddle_tpu``
model.
"""
from . import core, jit, kernels, models, nn, optimizer, serving
from .jit import TrainStep
from .models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                     LlamaForCausalLM, llama_7b)
from .serving import DecodeEngine

__all__ = ["core", "jit", "kernels", "models", "nn", "optimizer", "serving",
           "GPTConfig", "GPTForCausalLM", "LlamaConfig", "LlamaForCausalLM",
           "llama_7b", "DecodeEngine", "TrainStep"]
