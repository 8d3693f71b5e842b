"""Math ops (counterpart of ``paddle_tpu/ops/math.py``): elementwise
unary and binary ops, reductions, scans and products, each a torch
forward registered with ``core.dispatch``. Integer results are torch's
int64 where the JAX package's are int32 (XLA runs without 64-bit
mode)."""
from __future__ import annotations

import torch

from ..core.dispatch import register_op
from ._helpers import _op, as_tuple_axis, dims, make_binary, make_unary

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "maximum", "minimum", "fmax", "fmin", "atan2",
    "heaviside", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "abs", "neg", "sign", "floor", "ceil", "round", "trunc", "frac",
    "reciprocal", "square", "sin", "cos", "tan", "tanh", "asin", "acos",
    "atan", "sinh", "cosh", "asinh", "acosh", "atanh", "erf", "erfinv",
    "digamma", "lgamma", "clip", "lerp", "scale", "stanh", "rad2deg",
    "deg2rad", "angle", "conj", "real", "imag", "sum", "mean", "max", "min",
    "amax", "amin", "prod", "std", "var", "median", "nansum", "nanmean",
    "logsumexp", "all", "any", "count_nonzero", "cumsum", "cumprod",
    "cummax", "cummin", "logcumsumexp", "matmul", "dot", "inner", "outer",
    "addmm", "kron", "trace", "diff", "isnan", "isinf", "isfinite",
    "nan_to_num", "logit", "multiplex", "increment", "gcd", "lcm",
    "logaddexp", "hypot", "ldexp", "copysign", "sgn", "take", "renorm",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
]

add = make_binary("add", torch.add)
subtract = make_binary("subtract", torch.sub)
multiply = make_binary("multiply", torch.mul)
divide = make_binary("divide", torch.true_divide)
floor_divide = make_binary("floor_divide", torch.floor_divide)
remainder = make_binary("remainder", torch.remainder)
mod = remainder
maximum = make_binary("maximum", torch.maximum)
minimum = make_binary("minimum", torch.minimum)
fmax = make_binary("fmax", torch.fmax)
fmin = make_binary("fmin", torch.fmin)
atan2 = make_binary("atan2", torch.atan2)
logaddexp = make_binary("logaddexp", torch.logaddexp)
hypot = make_binary("hypot", torch.hypot)
copysign = make_binary("copysign", torch.copysign)
gcd = make_binary("gcd", torch.gcd)
lcm = make_binary("lcm", torch.lcm)
bitwise_and = make_binary("bitwise_and", torch.bitwise_and)
bitwise_or = make_binary("bitwise_or", torch.bitwise_or)
bitwise_xor = make_binary("bitwise_xor", torch.bitwise_xor)
heaviside = make_binary("heaviside", torch.heaviside)


def pow(x, y, name=None):
    """``x ** y`` (``y`` a scalar or a tensor)."""
    return _op("pow", x, y)


register_op("pow", torch.pow)


def ldexp(x, y, name=None):
    return _op("ldexp", x, y)


register_op("ldexp", lambda x, y: x * torch.pow(2.0, y.to(x.dtype)
                                               if torch.is_tensor(y) else y))

exp = make_unary("exp", torch.exp)
expm1 = make_unary("expm1", torch.expm1)
log = make_unary("log", torch.log)
log2 = make_unary("log2", torch.log2)
log10 = make_unary("log10", torch.log10)
log1p = make_unary("log1p", torch.log1p)
sqrt = make_unary("sqrt", torch.sqrt)
rsqrt = make_unary("rsqrt", torch.rsqrt)
abs = make_unary("abs", torch.abs)
neg = make_unary("neg", torch.neg)
sign = make_unary("sign", torch.sign)
sgn = sign
floor = make_unary("floor", torch.floor)
ceil = make_unary("ceil", torch.ceil)
round = make_unary("round", torch.round)
trunc = make_unary("trunc", torch.trunc)
frac = make_unary("frac", torch.frac)
reciprocal = make_unary("reciprocal", torch.reciprocal)
square = make_unary("square", torch.square)
sin = make_unary("sin", torch.sin)
cos = make_unary("cos", torch.cos)
tan = make_unary("tan", torch.tan)
tanh = make_unary("tanh", torch.tanh)
asin = make_unary("asin", torch.asin)
acos = make_unary("acos", torch.acos)
atan = make_unary("atan", torch.atan)
sinh = make_unary("sinh", torch.sinh)
cosh = make_unary("cosh", torch.cosh)
asinh = make_unary("asinh", torch.asinh)
acosh = make_unary("acosh", torch.acosh)
atanh = make_unary("atanh", torch.atanh)
erf = make_unary("erf", torch.erf)
erfinv = make_unary("erfinv", torch.erfinv)
digamma = make_unary("digamma", torch.digamma)
lgamma = make_unary("lgamma", torch.lgamma)
rad2deg = make_unary("rad2deg", torch.rad2deg)
deg2rad = make_unary("deg2rad", torch.deg2rad)
angle = make_unary("angle", torch.angle)
conj = make_unary("conj", lambda x: torch.conj(x).resolve_conj())
real = make_unary("real", lambda x: torch.real(x) if x.is_complex() else x)
imag = make_unary("imag", lambda x: torch.imag(x) if x.is_complex()
                  else torch.zeros_like(x))
isnan = make_unary("isnan", torch.isnan)
isinf = make_unary("isinf", torch.isinf)
isfinite = make_unary("isfinite", torch.isfinite)
bitwise_not = make_unary("bitwise_not", torch.bitwise_not)
stanh = make_unary("stanh", lambda x: 1.7159 * torch.tanh(0.66667 * x))


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def clip(x, min=None, max=None, name=None):
    lo, hi = _scalar(min), _scalar(max)
    return _op("clip", x, min=None if lo is None else float(lo),
               max=None if hi is None else float(hi))


register_op("clip", lambda x, min=None, max=None: torch.clamp(x, min, max))


def lerp(x, y, weight, name=None):
    if isinstance(weight, (int, float)):
        return _op("lerp_scalar", x, y, weight=float(weight))
    return _op("lerp", x, y, weight)


register_op("lerp", lambda x, y, w: x + w * (y - x))
register_op("lerp_scalar", lambda x, y, weight=0.5: x + weight * (y - x))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    return _op("scale", x, scale=float(_scalar(scale)), bias=float(bias),
               bias_after_scale=bool(bias_after_scale))


def _scale_fwd(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


register_op("scale", _scale_fwd)


def logit(x, eps=None, name=None):
    return _op("logit", x, eps=eps)


register_op("logit", lambda x, eps=None: torch.logit(x, eps))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return _op("nan_to_num", x, nan=float(nan), posinf=posinf, neginf=neginf)


register_op("nan_to_num", torch.nan_to_num)


def increment(x, value=1.0, name=None):
    """``x += value`` in place; returns ``x``."""
    with torch.no_grad():
        torch.Tensor.add_(x, value)
    return x


# ------------------------------------------------------------- reductions


def _reduction(name, fwd, doc):
    register_op(name, fwd)

    def wrapper(x, axis=None, keepdim=False, name=None):
        return _op(op_name, x, axis=as_tuple_axis(axis),
                   keepdim=bool(keepdim))

    op_name = name
    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    return wrapper


def _over(fn):
    """A torch reduction taking a tuple of dims, over every axis for
    None."""
    return lambda x, axis=None, keepdim=False: fn(
        x, dim=dims(axis, x.dim()), keepdim=keepdim)


def _one_axis(fn):
    """A torch reduction of one dim at a time (``torch.prod``,
    ``torch.median``...), applied over each axis in turn."""
    def red(x, axis=None, keepdim=False):
        if axis is None:
            out = fn(x.reshape(-1), 0)
            return out.reshape([1] * x.dim()) if keepdim else out
        axes = sorted((a % x.dim() for a in (
            axis if isinstance(axis, tuple) else (axis,))), reverse=True)
        for a in axes:
            x = fn(x, a, keepdim=True)
        if not keepdim:
            x = x.squeeze(tuple(axes))
        return x
    return red


sum = _reduction("sum", _over(torch.sum), "Sum over ``axis`` (all: None).")
mean = _reduction("mean", _over(torch.mean), "Mean over ``axis``.")
prod = _reduction("prod", _one_axis(torch.prod), "Product over ``axis``.")
max = _reduction("max", _over(torch.amax), "Maximum over ``axis``.")
min = _reduction("min", _over(torch.amin), "Minimum over ``axis``.")
amax = _reduction("amax", _over(torch.amax), "Maximum over ``axis``.")
amin = _reduction("amin", _over(torch.amin), "Minimum over ``axis``.")
nansum = _reduction("nansum", _over(torch.nansum), "Sum ignoring NaN.")
nanmean = _reduction("nanmean", _over(torch.nanmean), "Mean ignoring NaN.")
all = _reduction("all", _one_axis(torch.all), "Logical and over ``axis``.")
any = _reduction("any", _one_axis(torch.any), "Logical or over ``axis``.")


def _median(x, axis=None, keepdim=False):
    """numpy's median (the mean of the two middle values for an even
    count), as the JAX package's ``jnp.median``."""
    if axis is None:
        flat = x.reshape(-1)
        out = torch.quantile(flat.float(), 0.5).to(x.dtype)
        return out.reshape([1] * x.dim()) if keepdim else out
    return torch.quantile(x.float(), 0.5, dim=axis if isinstance(axis, int)
                          else axis[0], keepdim=keepdim).to(x.dtype)


median = _reduction("median", _median, "numpy's median over ``axis``.")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _op("std", x, axis=as_tuple_axis(axis), unbiased=bool(unbiased),
               keepdim=bool(keepdim))


register_op("std", lambda x, axis=None, unbiased=True, keepdim=False:
            torch.std(x, dim=dims(axis, x.dim()), correction=int(unbiased),
                      keepdim=keepdim))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _op("var", x, axis=as_tuple_axis(axis), unbiased=bool(unbiased),
               keepdim=bool(keepdim))


register_op("var", lambda x, axis=None, unbiased=True, keepdim=False:
            torch.var(x, dim=dims(axis, x.dim()), correction=int(unbiased),
                      keepdim=keepdim))


def logsumexp(x, axis=None, keepdim=False, name=None):
    return _op("logsumexp", x, axis=as_tuple_axis(axis),
               keepdim=bool(keepdim))


register_op("logsumexp", lambda x, axis=None, keepdim=False:
            torch.logsumexp(x, dim=dims(axis, x.dim()), keepdim=keepdim))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _op("count_nonzero", x, axis=as_tuple_axis(axis),
               keepdim=bool(keepdim))


register_op("count_nonzero", lambda x, axis=None, keepdim=False: torch.sum(
    x != 0, dim=dims(axis, x.dim()), keepdim=keepdim))


def _scan(name, fn):
    register_op(name, lambda x, axis=None: fn(
        x.reshape(-1) if axis is None else x, 0 if axis is None else axis))


_scan("cumsum", torch.cumsum)
_scan("cumprod", torch.cumprod)
_scan("logcumsumexp", torch.logcumsumexp)


def cumsum(x, axis=None, dtype=None, name=None):
    out = _op("cumsum", x, axis=None if axis is None else int(axis))
    return out if dtype is None else out.astype(dtype)


def cumprod(x, dim=None, dtype=None, name=None):
    out = _op("cumprod", x, axis=None if dim is None else int(dim))
    return out if dtype is None else out.astype(dtype)


def logcumsumexp(x, axis=None, name=None):
    return _op("logcumsumexp", x, axis=None if axis is None else int(axis))


def _cum_ext(fn):
    def fwd(x, axis=None):
        a = x.reshape(-1) if axis is None else x
        out = fn(a, 0 if axis is None else axis)
        return out.values, out.indices
    return fwd


register_op("cummax", _cum_ext(torch.cummax))
register_op("cummin", _cum_ext(torch.cummin))


def cummax(x, axis=None, dtype="int64", name=None):
    """Running maximum and the index where each was reached."""
    v, i = _op("cummax", x, axis=None if axis is None else int(axis))
    return v, i.astype(dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    v, i = _op("cummin", x, axis=None if axis is None else int(axis))
    return v, i.astype(dtype)


# ------------------------------------------------------------- products


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _op("matmul", x, y, transpose_x=bool(transpose_x),
               transpose_y=bool(transpose_y))


def _matmul_fwd(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


register_op("matmul", _matmul_fwd)


def dot(x, y, name=None):
    return _op("dot", x, y)


register_op("dot", lambda x, y: torch.sum(x * y, dim=-1))


def inner(x, y, name=None):
    return _op("inner", x, y)


register_op("inner", torch.inner)


def outer(x, y, name=None):
    return _op("outer", x, y)


register_op("outer", lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1)))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return _op("addmm", input, x, y, beta=float(beta), alpha=float(alpha))


register_op("addmm", lambda inp, x, y, beta=1.0, alpha=1.0:
            beta * inp + alpha * torch.matmul(x, y))


def kron(x, y, name=None):
    return _op("kron", x, y)


register_op("kron", torch.kron)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _op("trace", x, offset=int(offset), axis1=int(axis1),
               axis2=int(axis2))


register_op("trace", lambda x, offset=0, axis1=0, axis2=1: torch.diagonal(
    x, offset, axis1, axis2).sum(-1))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return _op("diff", x, prepend, append, n=int(n), axis=int(axis))


register_op("diff", lambda x, prepend=None, append=None, n=1, axis=-1:
            torch.diff(x, n, axis, prepend, append))


def multiplex(inputs, index, name=None):
    return _op("multiplex", list(inputs), index)


register_op("multiplex", lambda ins, idx: torch.stack(ins, 0)[
    idx.reshape(-1).long(), torch.arange(idx.numel(), device=idx.device)])


def take(x, index, mode="raise", name=None):
    return _op("take", x, index, mode=str(mode))


def _take_fwd(x, index, mode="raise"):
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = index.long()
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = torch.clamp(idx, -n, n - 1)
    idx = torch.where(idx < 0, idx + n, idx)
    return flat[idx]


register_op("take", _take_fwd)


def renorm(x, p, axis, max_norm, name=None):
    return _op("renorm", x, p=float(p), axis=int(axis),
               max_norm=float(max_norm))


def _renorm_fwd(x, p=2.0, axis=0, max_norm=1.0):
    rest = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(x) ** p, dim=rest, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


register_op("renorm", _renorm_fwd)
