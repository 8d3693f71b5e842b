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

``load_paddle_layer_state`` carries a JAX ``nn.Layer``'s
``state_dict()`` into a Paddle-API ``Layer`` of the port with no
transpose: both hold ``Linear.weight`` as ``[in, out]`` under the same
structured names.

``convert_paddle_optimizer_state`` carries a ``paddle_tpu`` optimizer's
``state_dict()`` over the same way: moments and fp32 masters take their
parameter's layout change, the scheduler's state and the step count pass
as they are, so a run started in the JAX package resumes in the port.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["convert_paddle_state", "load_paddle_state",
           "load_paddle_layer_state", "convert_paddle_optimizer_state"]


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


def load_paddle_layer_state(layer: torch.nn.Module,
                            jax_state: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a JAX ``Layer.state_dict()`` (its Tensors, or numpy arrays)
    into the port's ``layer`` in place, by name, with no transpose, cast to
    each target's type. A missing key, an unexpected key or a shape
    mismatch raises ``ValueError``."""
    target = layer.state_dict()
    leftover = sorted(set(jax_state) - set(target))
    missing = sorted(set(target) - set(jax_state))
    if leftover or missing:
        raise ValueError(f"load_paddle_layer_state: unexpected keys "
                         f"{leftover}, missing keys {missing}")
    with torch.no_grad():
        for name, ref in target.items():
            src = jax_state[name]
            arr = np.asarray(src.numpy() if hasattr(src, "numpy") else src)
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"load_paddle_layer_state: {name} has shape "
                                 f"{tuple(arr.shape)}, the layer's is "
                                 f"{tuple(ref.shape)}")
            torch.Tensor.copy_(ref, torch.as_tensor(np.ascontiguousarray(
                arr)).to(ref.dtype))
    return layer


def convert_paddle_optimizer_state(state: Mapping[str, Any],
                                   names: Mapping[str, str],
                                   model: torch.nn.Module,
                                   optimizer) -> Dict[str, Any]:
    """A ``paddle_tpu`` optimizer's ``state_dict()`` (tensors as numpy
    arrays) -> a state for ``optimizer.set_state_dict`` of the port.

    ``names`` maps each JAX checkpoint key (the JAX optimizer's
    ``_param_keys()``: layer-assigned names with ``__<index>``
    disambiguators, or ``param_{i}``) to the structured name of its
    parameter (``named_parameters()``: the same in both packages); the
    port's parameter of that name in ``model`` gives the port's key
    (``optimizer._param_keys()``). Each moment ``{key}_{state}`` and each
    master is transposed where the parameter is an ``nn.Linear`` weight,
    as ``convert_paddle_state`` does the weight; ``LR_Scheduler`` and
    ``_step_count`` pass as they are. Values arrive as float32 arrays
    (numpy has no bfloat16) and leave as CPU float32 tensors;
    ``set_state_dict`` casts them into the live states. A key of ``names``
    whose parameter the port's optimizer does not hold, a state the
    optimizer does not keep, or a shape that does not fit raises
    ``ValueError``."""
    by_name = dict(model.named_parameters())
    port_keys = {id(p): k for p, k in zip(optimizer._parameter_list,
                                          optimizer._param_keys())}
    linear = _linear_weight_names(model)

    def port(jax_key: str, arr) -> tuple:
        name = names.get(jax_key)
        p = by_name.get(name)
        if p is None or id(p) not in port_keys:
            raise ValueError(f"convert: optimizer key {jax_key!r} (parameter "
                             f"{name!r}) has no parameter in the port's "
                             f"optimizer")
        a = np.asarray(arr, dtype=np.float32)
        if name in linear:
            a = a.T
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"convert: {jax_key}'s state has shape "
                             f"{tuple(a.shape)} after layout change, "
                             f"{name} is {tuple(p.shape)}")
        return port_keys[id(p)], torch.tensor(a)

    out: Dict[str, Any] = {"master_weights": {},
                           "LR_Scheduler": dict(state.get("LR_Scheduler")
                                                or {}),
                           "_step_count": int(state.get("_step_count", 0))}
    for jax_key, arr in state.get("master_weights", {}).items():
        key, t = port(jax_key, arr)
        out["master_weights"][key] = t
    for k, arr in state.items():
        if k in ("master_weights", "LR_Scheduler", "_step_count"):
            continue
        for st in optimizer._state_names:
            if k.endswith("_" + st) and k[:-len(st) - 1] in names:
                key, t = port(k[:-len(st) - 1], arr)
                out[f"{key}_{st}"] = t
                break
        else:
            raise ValueError(f"convert: optimizer state {k!r} is no "
                             f"{optimizer._state_names} of a key in names")
    return out
