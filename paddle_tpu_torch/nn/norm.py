"""``rms_norm``, the RMSNorm op (counterpart of the JAX package's
``_rms_norm_fwd`` in ``paddle_tpu/nn/layers_norm_act_loss.py``); the
layer is ``layers_norm_act_loss.RMSNorm``."""
from __future__ import annotations

import torch

from ..core.amp_state import amp_op
from ..core.dispatch import register_op

__all__ = ["rms_norm"]


@amp_op("rms_norm")
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """The JAX package's ``_rms_norm_fwd``: the mean of squares in fp32,
    ``x * 1/sqrt(var + eps)`` in fp32, times the weight in fp32, then cast
    back to x's type (``torch.nn.RMSNorm`` rounds at other points)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + epsilon))
    return (out * weight.float()).to(x.dtype)


register_op("rms_norm", rms_norm)
