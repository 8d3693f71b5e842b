"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu``.

The JAX package stays the reference; this package does the same work on
an NVIDIA H100. Plain tensor code is PyTorch, and every Pallas kernel of
the JAX package on a ported path is a hand-written Hopper kernel
(``kernels/``, CUDA sources in ``csrc/``), built with ``nvcc`` at first
use. Entry points run on the GPU unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs instead.

Ported so far: GPT inference (``models.GPTForCausalLM``: the scoring
forward through the flash-attention kernel) and the paged serving engine
(``serving.DecodeEngine``). ``convert.load_paddle_state`` carries weights
over from a ``paddle_tpu`` model.
"""
from . import core, kernels, models, nn, serving
from .models import GPTConfig, GPTForCausalLM
from .serving import DecodeEngine

__all__ = ["core", "kernels", "models", "nn", "serving", "GPTConfig",
           "GPTForCausalLM", "DecodeEngine"]
