"""Common layers the port adds to ``torch.nn`` (counterpart of
``paddle_tpu/nn/layers_common.py``)."""
from __future__ import annotations

from torch import nn

from . import functional as F

__all__ = ["Dropout"]


class Dropout(nn.Module):
    """``paddle.nn.Dropout(p, axis, mode)``: ``F.dropout`` in training mode,
    identity (or ``x * (1 - p)`` for ``downscale_in_infer``) in eval.

    Unlike ``torch.nn.Dropout`` it holds the CPU ``torch.Generator`` its
    masks come from (``generator``; models hand their own to every layer
    that drops), so two runs from the same generator state drop the same
    elements on the card and on the CPU."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"
