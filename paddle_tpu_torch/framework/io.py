"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework/io.py``).

The file is ``torch.save`` of the object with every tensor as a plain
host tensor tagged with its Paddle metadata (``stop_gradient``, whether
it was a ``Parameter``, its ``name``), read back with
``weights_only=True``; the format is the port's own, not the JAX
package's pickle. ``load`` puts tensors on the default place
(``return_numpy=True`` gives numpy arrays)."""
from __future__ import annotations

import os
from typing import Any

import torch

from ..core.device import get_default_place
from ..core.tensor import Parameter, Tensor

__all__ = ["save", "load"]

_TAG = "__paddle_tensor__"


def _pack(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        t = torch.Tensor.detach(obj).as_subclass(torch.Tensor).cpu()
        return {_TAG: t.clone(), "stop_gradient": not obj.requires_grad,
                "is_parameter": isinstance(obj, Parameter),
                "name": getattr(obj, "name", "") or ""}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def _unpack(obj: Any, return_numpy: bool = False) -> Any:
    if isinstance(obj, dict) and _TAG in obj:
        t = obj[_TAG]
        if return_numpy:
            return t.float().numpy() if t.dtype == torch.bfloat16 \
                else t.numpy()
        t = t.to(get_default_place().device)
        if obj["is_parameter"]:
            return Parameter(t, not obj["stop_gradient"],
                             name=obj["name"] or None)
        out = Tensor(t, stop_gradient=obj["stop_gradient"],
                     place=get_default_place())
        out.name = obj["name"]
        return out
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, return_numpy) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs):
    """Write ``obj`` (a state dict, a tensor, or nested dicts, lists and
    tuples of tensors and plain values) to ``path`` (``protocol`` is
    accepted and torch's own pickle protocol used: ``weights_only``
    loading reads that one)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    torch.save(_pack(obj), path)


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """Read what ``save`` wrote."""
    return _unpack(torch.load(path, map_location="cpu", weights_only=True),
                   return_numpy)
