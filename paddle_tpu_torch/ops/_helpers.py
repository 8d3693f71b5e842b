"""Shared plumbing for op definitions (counterpart of
``paddle_tpu/ops/_helpers.py``): each public op is a torch forward
registered with ``core.dispatch`` and a thin wrapper that calls
``apply_op``; the factories stamp out the elementwise families."""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op, register_op

__all__ = ["_op", "make_unary", "make_binary", "as_tuple_axis",
           "static_int_list"]


def _op(name, *tensors, **attrs):
    return apply_op(name, tensors, attrs)


def make_unary(name, fn):
    """A one-input elementwise op ``name(x)`` over the torch ``fn``."""
    register_op(name, fn)

    def wrapper(x, name=None):
        return apply_op(op_name, (x,), None)

    op_name = name
    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = f"Elementwise {name}."
    return wrapper


def make_binary(name, fn):
    """A two-input elementwise op ``name(x, y)`` with broadcasting."""
    register_op(name, fn)

    def wrapper(x, y, name=None):
        return apply_op(op_name, (x, y), None)

    op_name = name
    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = f"Elementwise {name} with numpy broadcasting."
    return wrapper


def as_tuple_axis(axis):
    """An axis argument (None, int, list, tuple or Tensor) as None, an int
    or a tuple of ints."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        return tuple(int(v) for v in axis.detach().cpu().reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def static_int_list(v):
    """A shape-like argument (int, list of ints or 0-d Tensors, Tensor) as a
    tuple of ints."""
    if isinstance(v, torch.Tensor):
        return tuple(int(x) for x in v.detach().cpu().reshape(-1).tolist())
    if isinstance(v, (list, tuple, torch.Size)):
        return tuple(int(x.item()) if isinstance(x, torch.Tensor) else int(x)
                     for x in v)
    return (int(v),)


def dims(axis, ndim):
    """A reduction's ``dim`` for torch: all axes for None."""
    if axis is None:
        return tuple(range(ndim))
    return axis

