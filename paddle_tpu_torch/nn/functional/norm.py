"""Normalisation functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): ``layer_norm`` and the fused
residual epilogue ``add_dropout_ln``."""
from __future__ import annotations

import torch

from ...core.random import next_seed
from ...kernels.fused_residual import FusedAddDropoutLN
from .common import dropout

__all__ = ["layer_norm", "add_dropout_ln"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """``paddle.nn.functional.layer_norm`` over the trailing
    ``normalized_shape`` axes (an XLA op in the JAX package, not a
    kernel)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return torch.nn.functional.layer_norm(x, tuple(normalized_shape), weight,
                                          bias, epsilon)


def add_dropout_ln(x, sub, weight, bias, p: float = 0.0,
                   epsilon: float = 1e-12, training: bool = True,
                   generator=None):
    """``LayerNorm(x + dropout(sub))`` over the last axis: the transformer
    sublayer's residual epilogue (BERT's post-LN blocks).

    Where the JAX package fuses it (the width a multiple of 128), this is
    ``FusedAddDropoutLN``: the fused kernels on a CUDA tensor, their plain
    version on a CPU tensor, one seed drawn from ``generator`` when it
    drops. Elsewhere it is the composition ``layer_norm(x + dropout(sub))``.
    Either way the card and the CPU draw the same seeds and drop the same
    elements. Without ``generator`` the seed comes from the global chain
    (``core.random``: ``seed``)."""
    rate = float(p) if training else 0.0
    if x.shape[-1] % 128 == 0:
        seed = next_seed(generator) if rate > 0.0 else 0
        return FusedAddDropoutLN.apply(x, sub, weight, bias, seed, rate,
                                       float(epsilon))
    h = x + dropout(sub, p=rate, training=rate > 0.0, generator=generator)
    return layer_norm(h, x.shape[-1], weight, bias, epsilon=epsilon)
