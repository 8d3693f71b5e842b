"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``): the three
clips an optimizer takes as ``grad_clip``. Each is called on a list of
``(param, grad)`` pairs and returns a new list; nothing is written in
place. The port has no sparse gradients, so there is no SelectedRows
branch."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient element to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    @torch.no_grad()
    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max)) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient by ``min(clip_norm / max(norm, 1e-12), 1)``,
    its own L2 norm taken in its own type, with the constants rounded to
    that type first (the JAX package's weakly typed Python floats).

    The three constants are made once per device and type and kept: a
    tensor made from host values at each call would be a host-to-device
    copy in every step, which a captured step may not hold."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)
        self._consts = {}

    def _constants(self, g):
        key = (g.device, g.dtype)
        c = self._consts.get(key)
        if c is None:
            c = self._consts[key] = tuple(
                torch.tensor(v, dtype=g.dtype, device=g.device)
                for v in (self.clip_norm, 1e-12, 1.0))
        return c

    @torch.no_grad()
    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            clip, tiny, one = self._constants(g)
            norm = g.square().sum().sqrt()
            scale = torch.minimum(clip / torch.maximum(norm, tiny), one)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``:
    the global norm is the root of the sum, in fp32 and in list order, of
    each gradient's squares summed in fp32; the scale is applied in fp32
    and the product cast back to the gradient's type."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @torch.no_grad()
    def __call__(self, params_grads):
        if not params_grads:
            return params_grads
        total = None
        for _, g in params_grads:
            sq = g.float().square().sum()
            total = sq if total is None else total + sq
        scale = self.clip_norm / total.sqrt().clamp_min(self.clip_norm)
        return [(p, (g.float() * scale).to(g.dtype)) for p, g in params_grads]
