"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer/api.py``).

An initializer is called with a shape and a ``torch.dtype`` and returns a
CPU tensor of that type. The random ones draw in fp32 on the port's global
chain (a CPU ``torch.Generator``: ``paddle.seed``), so one seed gives the
same parameters on the card as on the CPU; ``Layer.create_parameter``
moves them to the layer's place. The JAX package draws other bits (numpy
on its host chain): the two agree in distribution, not value by value.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.dtype import convert_dtype
from ...core.random import default_generator

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform", "KaimingNormal",
           "Assign", "Orthogonal", "calculate_fan", "calculate_gain",
           "set_global_initializer"]

_global_weight_init = None
_global_bias_init = None


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=convert_dtype(dtype))


def _sample(draw, shape, dtype):
    """``draw(empty fp32 CPU tensor, generator)`` filled in place, cast."""
    t = torch.empty(tuple(shape), dtype=torch.float32)
    draw(t, default_generator())
    return t.to(convert_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _sample(lambda t, g: t.uniform_(self.low, self.high,
                                               generator=g), shape, dtype)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return _sample(lambda t, g: t.normal_(self.mean, self.std,
                                              generator=g), shape, dtype)


class TruncatedNormal(Initializer):
    """Normal draws redrawn until within two standard deviations."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        def trunc(t, g):
            t.normal_(0.0, 1.0, generator=g)
            bad = t.abs() > 2.0
            while bool(bad.any()):
                t[bad] = torch.randn(int(bad.sum()), generator=g)
                bad = t.abs() > 2.0
            t.mul_(self.std).add_(self.mean)
        return _sample(trunc, shape, dtype)


def calculate_fan(shape):
    """(fan_in, fan_out): Linear weights are ``[in, out]``, conv kernels
    ``[out, in/groups, *spatial]`` (Paddle's layouts)."""
    shape = tuple(shape)
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) <= 1:
        return (shape[0], shape[0]) if shape else (1, 1)
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = calculate_fan(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        return _sample(lambda t, g: t.uniform_(-limit, limit, generator=g),
                       shape, dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = calculate_fan(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        return _sample(lambda t, g: t.normal_(0.0, std, generator=g),
                       shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi = self.fan_in or calculate_fan(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _sample(lambda t, g: t.uniform_(-limit, limit, generator=g),
                       shape, dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi = self.fan_in or calculate_fan(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        std = gain / math.sqrt(fi)
        return _sample(lambda t, g: t.normal_(0.0, std, generator=g),
                       shape, dtype)


class Assign(Initializer):
    """The given values (an array, list or tensor), reshaped to the shape."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        v = self.value
        arr = v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        return torch.as_tensor(np.ascontiguousarray(arr).reshape(
            tuple(shape))).to(convert_dtype(dtype))


class Orthogonal(Initializer):
    """A (semi-)orthogonal matrix times ``gain``: the Q of a Gaussian
    draw's QR, signs fixed by R's diagonal (rows flattened past the first
    axis)."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        def ortho(t, g):
            rows = t.shape[0]
            cols = t.numel() // rows if rows else 0
            a = torch.randn(max(rows, cols), min(rows, cols), generator=g)
            q, r = torch.linalg.qr(a)
            q = q * torch.sign(torch.diagonal(r))
            if rows < cols:
                q = q.T
            t.copy_(self.gain * q.reshape(t.shape))
        return _sample(ortho, shape, dtype)


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def _resolve_initializer(attr, is_bias, default_initializer):
    """A ``ParamAttr``, an initializer, or None -> the initializer to use:
    the attribute's, else ``default_initializer``, else the global one,
    else ``XavierUniform`` for weights and zeros for biases."""
    init = None
    if isinstance(attr, Initializer):
        init = attr
    elif attr is not None and not isinstance(attr, (bool, str)):
        init = getattr(attr, "initializer", None)
    if init is None:
        init = default_initializer
    if init is None:
        init = (_global_bias_init or Constant(0.0)) if is_bias \
            else (_global_weight_init or XavierUniform())
    return init
