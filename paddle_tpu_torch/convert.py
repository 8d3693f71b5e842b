"""Carry weights from a ``paddle_tpu`` model into the port.

Input is ``{name: numpy array}`` as a ``paddle_tpu`` model's
``named_parameters()`` gives it; output is the port model's
``state_dict``. The port's modules carry the JAX package's parameter
names, so names map one to one. What changes:

* Paddle's ``Linear.weight`` is ``[in, out]`` and torch's ``[out, in]``:
  the weight of every ``torch.nn.Linear`` of the target is transposed, and
  nothing else is. Which weights those are is read from the target's
  module types, not from their names: a square weight (LLaMA's
  ``q_proj``/``o_proj``) would pass the shape check untransposed. The
  packed qkv projection keeps its
  column order ``[q heads | k heads | v heads]`` (it becomes the row order
  of the transposed weight, which is what ``F.linear`` produces as output
  columns).
* A tied LM head has no ``lm_head.weight`` on either side (the head reads
  ``gpt.wte.weight``); a source ``lm_head.weight`` for a tied target is a
  leftover and raises.
* Arrays arrive as float32 (numpy has no bfloat16; convert bf16 with
  ``astype(np.float32)`` first) and are cast to the target's type.

Any source name the target lacks, any target name the source lacks, and
any shape mismatch raises ``ValueError``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["convert_paddle_state", "load_paddle_state"]


def _linear_weight_names(model: torch.nn.Module) -> set:
    """State-dict names of the weights of ``model``'s ``nn.Linear``s."""
    return {f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules()
            if isinstance(mod, torch.nn.Linear)}


def convert_paddle_state(params: Mapping[str, np.ndarray],
                         model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``paddle_tpu`` parameter arrays -> a state dict for ``model``, on
    the model's device and in its types."""
    target = model.state_dict()
    leftover = sorted(set(params) - set(target))
    missing = sorted(set(target) - set(params))
    if leftover or missing:
        raise ValueError(f"convert: unmapped source names {leftover}, "
                         f"target names without a source {missing}")
    linear = _linear_weight_names(model)
    out = {}
    for name, ref in target.items():
        arr = np.asarray(params[name], dtype=np.float32)
        if name in linear:
            arr = arr.T
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"convert: {name} has shape {tuple(arr.shape)} "
                             f"after layout change, target wants "
                             f"{tuple(ref.shape)}")
        out[name] = torch.tensor(arr).to(device=ref.device, dtype=ref.dtype)
    return out


def load_paddle_state(model: torch.nn.Module,
                      params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Convert ``params`` and load them into ``model`` (strict)."""
    model.load_state_dict(convert_paddle_state(params, model), strict=True)
    return model
