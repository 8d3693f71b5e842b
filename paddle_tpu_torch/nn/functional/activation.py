"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``), each a torch forward
registered with ``core.dispatch``. ``rrelu`` and ``gumbel_softmax`` draw
on the port's global chain (``paddle.seed``)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import register_op
from ...core.random import default_generator
from ...ops._helpers import _op, make_unary

__all__ = [
    "relu", "relu6", "relu_", "elu", "selu", "celu", "gelu", "sigmoid",
    "tanh", "silu", "swish", "mish", "hardswish", "hardsigmoid", "hardtanh",
    "hardshrink", "softshrink", "tanhshrink", "softsign", "softplus",
    "leaky_relu", "prelu", "rrelu", "log_sigmoid", "maxout", "softmax",
    "log_softmax", "gumbel_softmax", "glu", "thresholded_relu",
]

relu = make_unary("relu", torch.relu)
relu6 = make_unary("relu6", TF.relu6)
sigmoid = make_unary("sigmoid", torch.sigmoid)
tanh = make_unary("tanh", torch.tanh)
silu = make_unary("silu", TF.silu)
mish = make_unary("mish", TF.mish)
softsign = make_unary("softsign", TF.softsign)
log_sigmoid = make_unary("log_sigmoid", TF.logsigmoid)
tanhshrink = make_unary("tanhshrink", TF.tanhshrink)


def _relu_in_place(x):
    return torch.relu_(x)


register_op("relu_", _relu_in_place)


def relu_(x):
    """ReLU in place on ``x``; returns ``x``."""
    return _op("relu_", x)


def elu(x, alpha=1.0, name=None):
    return _op("elu", x, alpha=float(alpha))


register_op("elu", lambda x, alpha=1.0: TF.elu(x, alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _op("selu", x, scale=float(scale), alpha=float(alpha))


register_op("selu", lambda x, scale=1.0507, alpha=1.6733:
            scale * torch.where(x > 0, x, alpha * torch.expm1(x)))


def celu(x, alpha=1.0, name=None):
    return _op("celu", x, alpha=float(alpha))


register_op("celu", lambda x, alpha=1.0: TF.celu(x, alpha))


def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=True`` is the tanh form."""
    return _op("gelu", x, approximate=bool(approximate))


register_op("gelu", lambda x, approximate=False:
            TF.gelu(x, approximate="tanh" if approximate else "none"))


def swish(x, name=None):
    return silu(x)


def hardswish(x, name=None):
    return _op("hardswish", x)


register_op("hardswish", lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return _op("hardsigmoid", x, slope=float(slope), offset=float(offset))


register_op("hardsigmoid", lambda x, slope=1 / 6, offset=0.5:
            torch.clamp(x * slope + offset, 0.0, 1.0))


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _op("hardtanh", x, min=float(min), max=float(max))


register_op("hardtanh", lambda x, min=-1.0, max=1.0: torch.clamp(x, min, max))


def hardshrink(x, threshold=0.5, name=None):
    return _op("hardshrink", x, threshold=float(threshold))


register_op("hardshrink", lambda x, threshold=0.5: torch.where(
    torch.abs(x) > threshold, x, torch.zeros_like(x)))


def softshrink(x, threshold=0.5, name=None):
    return _op("softshrink", x, threshold=float(threshold))


register_op("softshrink", lambda x, threshold=0.5: TF.softshrink(x, threshold))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _op("softplus", x, beta=float(beta), threshold=float(threshold))


register_op("softplus", lambda x, beta=1.0, threshold=20.0:
            TF.softplus(x, beta, threshold))


def leaky_relu(x, negative_slope=0.01, name=None):
    return _op("leaky_relu", x, negative_slope=float(negative_slope))


register_op("leaky_relu", lambda x, negative_slope=0.01:
            TF.leaky_relu(x, negative_slope))


def prelu(x, weight, data_format="NCHW", name=None):
    return _op("prelu", x, weight, data_format=str(data_format))


def _prelu_fwd(x, w, data_format="NCHW"):
    if w.numel() == 1:
        alpha = w.reshape(())
    else:
        shape = [1] * x.dim()
        shape[1 if data_format.startswith("NC") else x.dim() - 1] = w.numel()
        alpha = w.reshape(shape)
    return torch.where(x >= 0, x, alpha * x)


register_op("prelu", _prelu_fwd)


def rrelu(x, lower=1 / 8, upper=1 / 3, training=True, name=None):
    """Randomized leaky ReLU: slopes drawn from U(lower, upper) in
    training, their mean in eval."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2)
    a = torch.empty(tuple(x.shape)).uniform_(lower, upper,
                                             generator=default_generator())
    return _op("rrelu_t", x, a.to(x.device))


register_op("rrelu_t", lambda x, a: torch.where(x >= 0, x, a.to(x.dtype) * x))


def thresholded_relu(x, threshold=1.0, name=None):
    return _op("thresholded_relu", x, threshold=float(threshold))


register_op("thresholded_relu", lambda x, threshold=1.0: torch.where(
    x > threshold, x, torch.zeros_like(x)))


def maxout(x, groups, axis=1, name=None):
    return _op("maxout", x, groups=int(groups), axis=int(axis))


def _maxout_fwd(x, groups=1, axis=1):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = tuple(x.shape[:ax]) + (c // groups, groups) + tuple(
        x.shape[ax + 1:])
    return torch.amax(x.reshape(shape), dim=ax + 1)


register_op("maxout", _maxout_fwd)


def softmax(x, axis=-1, dtype=None, name=None):
    out = _op("softmax", x, axis=int(axis))
    return out if dtype is None else out.astype(dtype)


register_op("softmax", lambda x, axis=-1: torch.softmax(x, axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    out = _op("log_softmax", x, axis=int(axis))
    return out if dtype is None else out.astype(dtype)


register_op("log_softmax", lambda x, axis=-1: torch.log_softmax(x, axis))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.rand(tuple(x.shape), generator=default_generator())
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return _op("gumbel_softmax", x, g.to(x.device),
               temperature=float(temperature), hard=bool(hard),
               axis=int(axis))


def _gumbel_softmax_fwd(x, g, temperature=1.0, hard=False, axis=-1):
    y = torch.softmax((x + g.to(x.dtype)) / temperature, axis)
    if hard:
        onehot = torch.zeros_like(y).scatter_(
            axis, torch.argmax(y, axis, keepdim=True), 1.0)
        y = (onehot - y).detach() + y
    return y


register_op("gumbel_softmax", _gumbel_softmax_fwd)


def glu(x, axis=-1, name=None):
    return _op("glu", x, axis=int(axis))


register_op("glu", lambda x, axis=-1: TF.glu(x, axis))
