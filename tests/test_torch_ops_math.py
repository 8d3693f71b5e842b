"""The port's math ops (``paddle_tpu_torch.ops.math``, also the
``Tensor`` methods) against the JAX package's: one parametrised table of
public op names resolved with ``getattr`` on both packages, numpy inputs
from a seed, the forward at rtol 1e-4 / atol 1e-5 and the gradient
against the JAX tape at 1e-4. The other op tables are in
``test_torch_ops_manipulation.py`` and ``test_torch_ops_linalg.py``."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp

from _torch_op_parity import (ATOL, RTOL, _on_cpu,  # noqa: F401
                              f, i, run_case)


X = f(3, 4)
Y = f(3, 4, seed=1)
POS = f(3, 4, lo=0.5)
UNIT = f(3, 4, lo=-0.5) * 1.8          # inside (-0.9, 0.9)

CASES = [
    # binary elementwise
    ("add", (X, Y), {}, (0, 1)), ("subtract", (X, Y), {}, (0, 1)),
    ("multiply", (X, Y), {}, (0, 1)), ("divide", (X, POS), {}, (0, 1)),
    ("floor_divide", (X * 4, POS), {}, ()), ("remainder", (X * 4, POS), {}, ()),
    ("mod", (X * 4, POS), {}, ()), ("pow", (POS, 2.5), {}, (0,)),
    ("pow", (POS, Y), {}, (0, 1)), ("maximum", (X, Y), {}, (0, 1)),
    ("minimum", (X, Y), {}, (0, 1)), ("fmax", (X, Y), {}, ()),
    ("fmin", (X, Y), {}, ()), ("atan2", (X, Y), {}, (0, 1)),
    ("heaviside", (X, Y), {}, ()), ("logaddexp", (X, Y), {}, (0, 1)),
    ("hypot", (X, Y), {}, (0, 1)), ("copysign", (X, Y), {}, (0,)),
    ("gcd", (i(3, 4, high=20), i(3, 4, high=20, seed=1)), {}, ()),
    ("lcm", (i(3, 4, high=9) + 1, i(3, 4, high=9, seed=1) + 1), {}, ()),
    ("bitwise_and", (i(5, high=64), i(5, high=64, seed=2)), {}, ()),
    ("bitwise_or", (i(5, high=64), i(5, high=64, seed=2)), {}, ()),
    ("bitwise_xor", (i(5, high=64), i(5, high=64, seed=2)), {}, ()),
    ("bitwise_not", (i(5, high=64),), {}, ()),
    ("ldexp", (X, i(3, 4, high=4)), {}, (0,)),
    # unary elementwise
    *[(n, (X,), {}, (0,)) for n in (
        "exp", "expm1", "abs", "neg", "sign", "square", "sin", "cos", "tan",
        "tanh", "atan", "sinh", "cosh", "asinh", "erf", "trunc", "frac",
        "floor", "ceil", "round", "rad2deg", "deg2rad", "stanh", "sgn")],
    *[(n, (POS,), {}, (0,)) for n in (
        "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
        "digamma", "lgamma")],
    *[(n, (UNIT,), {}, (0,)) for n in ("asin", "acos", "atanh", "erfinv")],
    ("acosh", (POS + 1.0,), {}, (0,)),
    ("logit", (f(3, 4, lo=0.1) * 0.8,), {}, (0,)),
    ("isnan", (X,), {}, ()), ("isinf", (X,), {}, ()),
    ("isfinite", (X,), {}, ()),
    ("nan_to_num", (np.array([1.0, np.nan, np.inf, -np.inf], np.float32),),
     {"posinf": 9.0, "neginf": -9.0}, ()),
    ("clip", (X,), {"min": -0.5, "max": 0.7}, (0,)),
    ("lerp", (X, Y, 0.3), {}, (0, 1)),
    ("lerp", (X, Y, f(3, 4, seed=5, lo=0.0)), {}, (0, 1, 2)),
    ("scale", (X,), {"scale": 2.0, "bias": 0.5}, (0,)),
    ("scale", (X,), {"scale": 2.0, "bias": 0.5, "bias_after_scale": False},
     (0,)),
    ("real", (X,), {}, ()), ("imag", (X,), {}, ()),
    # reductions
    *[(n, (X,), kw, (0,)) for n in ("sum", "mean", "amax", "amin",
                                    "logsumexp", "nansum", "nanmean")
      for kw in ({}, {"axis": 1}, {"axis": [0, 1], "keepdim": True})],
    ("max", (X,), {"axis": 0}, (0,)), ("min", (X,), {"axis": -1}, (0,)),
    ("prod", (POS,), {"axis": 1}, (0,)), ("prod", (POS,), {}, (0,)),
    ("std", (X,), {"axis": 1}, (0,)), ("var", (X,), {}, (0,)),
    ("std", (X,), {"axis": 0, "unbiased": False, "keepdim": True}, (0,)),
    ("median", (f(3, 5),), {"axis": 1}, ()), ("median", (f(3, 4),), {}, ()),
    ("all", (X > 0,), {"axis": 1}, ()), ("any", (X > 0,), {}, ()),
    ("count_nonzero", (np.where(X > 0, X, 0),), {"axis": 1}, ()),
    # scans
    ("cumsum", (X,), {"axis": 1}, (0,)), ("cumsum", (X,), {}, (0,)),
    ("cumprod", (POS,), {"dim": 0}, (0,)),
    ("logcumsumexp", (X,), {"axis": 1}, (0,)),
    ("cummax", (X,), {"axis": 1}, ()), ("cummin", (X,), {"axis": 0}, ()),
    # products
    ("matmul", (f(2, 3, 4), f(4, 5, seed=1)), {}, (0, 1)),
    ("matmul", (f(3, 4), f(5, 4, seed=1)), {"transpose_y": True}, (0, 1)),
    ("matmul", (f(4, 3), f(4, 5, seed=1)), {"transpose_x": True}, (0, 1)),
    ("dot", (f(2, 4), f(2, 4, seed=1)), {}, (0, 1)),
    ("inner", (f(2, 4), f(3, 4, seed=1)), {}, (0, 1)),
    ("outer", (f(3), f(4, seed=1)), {}, (0, 1)),
    ("addmm", (f(3, 5), f(3, 4, seed=1), f(4, 5, seed=2)),
     {"beta": 0.5, "alpha": 2.0}, (0, 1, 2)),
    ("kron", (f(2, 2), f(2, 3, seed=1)), {}, (0, 1)),
    ("trace", (f(4, 4),), {"offset": 1}, (0,)),
    ("diff", (f(3, 5),), {"axis": 1}, (0,)),
    ("take", (X, i(5, high=12)), {}, (0,)),
    ("renorm", (f(3, 4),), {"p": 2.0, "axis": 0, "max_norm": 1.0}, (0,)),
    ("multiplex", ([f(3, 2), f(3, 2, seed=1)], i(3, 1, high=2)), {}, ()),
]


@pytest.mark.parametrize("name,args,kwargs,grad", CASES,
                         ids=[f"{c[0]}-{k}" for k, c in enumerate(CASES)])
def test_math_op(name, args, kwargs, grad):
    run_case(name, args, kwargs, grad)


@pytest.mark.parametrize("name", ["exp", "sqrt", "sum", "mean", "tanh",
                                  "abs", "cumsum", "square"])
def test_math_method(name):
    """The op as a ``Tensor`` method gives the function's result."""
    x = tp.to_tensor(POS)
    torch.testing.assert_close(getattr(x, name)(), getattr(tp, name)(x))


def test_increment_is_in_place():
    a, b = jp.to_tensor(X), tp.to_tensor(X)
    assert tp.increment(b, 2.0) is b
    jp.increment(a, 2.0)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL)
