"""Comparison and logical ops (counterpart of ``paddle_tpu/ops/logic.py``)."""
from __future__ import annotations

import torch

from ..core.dispatch import register_op
from ..core.tensor import wrap_outputs
from ._helpers import _op, make_binary, make_unary

__all__ = [
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_not",
    "logical_xor", "allclose", "isclose", "equal_all", "is_empty",
    "is_tensor",
]

equal = make_binary("equal", torch.eq)
not_equal = make_binary("not_equal", torch.ne)
less_than = make_binary("less_than", torch.lt)
less_equal = make_binary("less_equal", torch.le)
greater_than = make_binary("greater_than", torch.gt)
greater_equal = make_binary("greater_equal", torch.ge)
logical_and = make_binary("logical_and", torch.logical_and)
logical_or = make_binary("logical_or", torch.logical_or)
logical_xor = make_binary("logical_xor", torch.logical_xor)
logical_not = make_unary("logical_not", torch.logical_not)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return _op("isclose", x, y, rtol=float(rtol), atol=float(atol),
               equal_nan=bool(equal_nan))


register_op("isclose", torch.isclose)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool ``Tensor``."""
    return _op("allclose", x, y, rtol=float(rtol), atol=float(atol),
               equal_nan=bool(equal_nan))


register_op("allclose", lambda x, y, rtol=1e-5, atol=1e-8, equal_nan=False:
            torch.isclose(x, y, rtol, atol, equal_nan).all())


def equal_all(x, y, name=None):
    return _op("equal_all", x, y)


register_op("equal_all", lambda x, y: torch.tensor(
    x.shape == y.shape and bool(torch.equal(x, y)), device=x.device))


def is_empty(x, name=None):
    return wrap_outputs(torch.tensor(x.numel() == 0, device=x.device))


def is_tensor(x):
    return isinstance(x, torch.Tensor)
