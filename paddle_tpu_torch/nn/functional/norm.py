"""Normalisation functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): ``layer_norm``, ``normalize`` and
the fused residual epilogue ``add_dropout_ln``, dispatched through
``core.dispatch``. The batch-statistics norms (``batch_norm``,
``instance_norm``, ``group_norm``, ``local_response_norm``) wait for the
convolution slice (ROADMAP Queue 1, item 2's rest)."""
from __future__ import annotations

import torch

from ...core.dispatch import register_op
from ...core.random import next_seed
from ...kernels.fused_residual import FusedAddDropoutLN
from ...ops._helpers import _op
from .common import _dropout_fwd

__all__ = ["layer_norm", "normalize", "add_dropout_ln"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5, name=None):
    """``paddle.nn.functional.layer_norm`` over the trailing
    ``normalized_shape`` axes (an XLA op in the JAX package, not a
    kernel)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return _op("layer_norm", x, weight, bias,
               normalized_shape=tuple(int(s) for s in normalized_shape),
               epsilon=float(epsilon))


register_op("layer_norm", lambda x, w=None, b=None, normalized_shape=(),
            epsilon=1e-5: torch.nn.functional.layer_norm(
                x, normalized_shape, w, b, epsilon))


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x`` over its ``p``-norm along ``axis`` (at least ``epsilon``)."""
    return _op("normalize", x, p=float(p), axis=int(axis),
               epsilon=float(epsilon))


register_op("normalize", lambda x, p=2.0, axis=1, epsilon=1e-12: x / (
    torch.clamp_min(torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True)
                    ** (1.0 / p), epsilon)))


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
    return _op("fused_add_dropout_ln", x, sub, weight, bias, p=float(p),
               epsilon=float(epsilon), training=bool(training),
               generator=generator)


def _add_dropout_ln_fwd(x, sub, weight, bias, p=0.0, epsilon=1e-12,
                        training=True, generator=None):
    rate = float(p) if training else 0.0
    if x.shape[-1] % 128 == 0:
        seed = next_seed(generator) if rate > 0.0 else 0
        return FusedAddDropoutLN.apply(x, sub, weight, bias, seed, rate,
                                       float(epsilon))
    h = x + _dropout_fwd(sub, p=rate, training=rate > 0.0,
                         generator=generator)
    return torch.nn.functional.layer_norm(h, (x.shape[-1],), weight, bias,
                                          epsilon)


register_op("fused_add_dropout_ln", _add_dropout_ln_fwd)
