"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
dropout.

``dropout`` draws from an explicit CPU ``torch.Generator`` where it is
given one and from the global chain (``core.random``: ``seed``) where it
is not. Each call draws one seed (``core.random.next_seed``) and hands it
to ``DropoutFunction``, whose wrapper launches the dropout kernel on a CUDA
tensor and runs the kernel's plain version on a CPU tensor: the two drop
the same elements for the same seed, so a run on the card and one on the
CPU from the same generator state agree. The backward regenerates the
mask from the seed.
"""
from __future__ import annotations

import torch

from ...core.random import default_generator, next_seed
from ...kernels.dropout import DropoutFunction

__all__ = ["dropout"]


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", generator=None):
    """``paddle.nn.functional.dropout``: each element of ``x`` (or each
    slice along the axes not in ``axis``) is zeroed with probability ``p``.

    ``mode="upscale_in_train"`` scales the kept elements by ``1 / (1 - p)``
    in training and leaves eval alone; ``"downscale_in_infer"`` keeps them
    unscaled in training and multiplies by ``1 - p`` in eval. Without
    ``axis`` the mask comes from the dropout kernel (``DropoutFunction``);
    with ``axis`` it has the shape of ``x`` cut to 1 off ``axis`` and is
    drawn with ``torch.bernoulli`` from ``generator`` (an XLA op in the JAX
    package too, not a kernel). ``generator`` (a CPU ``torch.Generator``)
    overrides the global chain, which a call without one draws from."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    p = float(p)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p must be in [0, 1], got {p}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    upscale = mode == "upscale_in_train"
    if p == 1.0:
        return x * 0.0
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
        keep = torch.bernoulli(torch.full(shape, 1.0 - p),
                               generator=default_generator(generator)
                               ).to(x.device, x.dtype)
        return x * keep / (1.0 - p) if upscale else x * keep
    return DropoutFunction.apply(x.contiguous(), next_seed(generator), p,
                                 upscale)
