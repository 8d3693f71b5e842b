"""Normalisation layers the port adds to ``torch.nn`` (counterpart of
``paddle_tpu/nn/layers_norm_act_loss.py``)."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["RMSNorm", "rms_norm"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """The JAX package's ``_rms_norm_fwd``: the mean of squares in fp32,
    ``x * 1/sqrt(var + eps)`` in fp32, times the weight in fp32, then cast
    back to x's type (``torch.nn.RMSNorm`` rounds at other points)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + epsilon))
    return (out * weight.float()).to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis with a learned scale initialised to
    ones (the LLaMA family's norm)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, epsilon={self.epsilon}"
