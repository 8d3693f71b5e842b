"""Tensor creation ops (counterpart of ``paddle_tpu/ops/creation.py``).

New tensors land on the default place (``set_device``; the card unless
the caller chose the CPU). The random ones draw on the port's global
chain, a CPU ``torch.Generator`` (``paddle.seed``), and then move to the
place, so the same seed gives the same values on the card and on the
CPU (the JAX package's draws are other bits: parity with it is
statistical)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import get_default_place
from ..core.dispatch import register_op
from ..core.dtype import convert_dtype
from ..core.random import default_generator
from ..core.tensor import to_tensor, wrap_outputs
from ._helpers import _op, static_int_list

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
    "rand", "randn", "randint", "randint_like", "uniform", "normal",
    "standard_normal", "randperm", "bernoulli", "multinomial", "tril",
    "triu", "diag", "diagflat", "meshgrid", "assign", "clone", "numel",
    "poisson",
]


def _dev():
    return get_default_place().device


def _dt(dtype, default=torch.float32):
    return default if dtype is None else convert_dtype(dtype)


def _item(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None):
    return wrap_outputs(torch.zeros(static_int_list(shape), dtype=_dt(dtype),
                            device=_dev()))


def ones(shape, dtype=None, name=None):
    return wrap_outputs(torch.ones(static_int_list(shape), dtype=_dt(dtype),
                           device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _item(fill_value)
    if dtype is None:
        dtype = torch.bool if isinstance(fill_value, bool) else \
            torch.int64 if isinstance(fill_value, int) else torch.float32
    return wrap_outputs(torch.full(static_int_list(shape), fill_value,
                           dtype=convert_dtype(dtype), device=_dev()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like(fn):
    def make(x, dtype=None, name=None):
        return wrap_outputs(fn(x.detach(), dtype=_dt(dtype, x.dtype)))
    return make


zeros_like = _like(torch.zeros_like)
ones_like = _like(torch.ones_like)
empty_like = zeros_like


def full_like(x, fill_value, dtype=None, name=None):
    return wrap_outputs(torch.full_like(x.detach(), _item(fill_value),
                                dtype=_dt(dtype, x.dtype)))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _item(start), _item(end), _item(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = torch.int64 if all(isinstance(v, (int, np.integer))
                                   for v in (start, end, step)) \
            else torch.float32
    return wrap_outputs(torch.arange(start, end, step, dtype=convert_dtype(dtype),
                             device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    return wrap_outputs(torch.linspace(float(_item(start)), float(_item(stop)),
                               int(_item(num)), dtype=_dt(dtype),
                               device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return wrap_outputs(torch.logspace(float(start), float(stop), int(num),
                               base=float(base), dtype=_dt(dtype),
                               device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    m = int(num_rows) if num_columns is None else int(num_columns)
    return wrap_outputs(torch.eye(int(num_rows), m, dtype=_dt(dtype), device=_dev()))


# ------------------------------------------------------------------ random


def _drawn(t: torch.Tensor, dtype=None):
    """A host draw moved to the default place."""
    if dtype is not None:
        t = t.to(convert_dtype(dtype))
    return wrap_outputs(t.to(_dev()))


def rand(shape, dtype=None, name=None):
    return _drawn(torch.rand(static_int_list(shape),
                             generator=default_generator()), dtype)


def randn(shape, dtype=None, name=None):
    return _drawn(torch.randn(static_int_list(shape),
                              generator=default_generator()), dtype)


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m = mean.detach().cpu().float() if isinstance(mean, torch.Tensor) \
            else mean
        s = std.detach().cpu().float() if isinstance(std, torch.Tensor) \
            else std
        shp = torch.broadcast_shapes(getattr(m, "shape", ()),
                                     getattr(s, "shape", ()))
        z = torch.randn(shp, generator=default_generator())
        return _drawn(z * s + m)
    z = torch.randn(static_int_list(shape), generator=default_generator())
    return _drawn(z * float(std) + float(mean))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    gen = torch.Generator().manual_seed(int(seed)) if seed \
        else default_generator()
    u = torch.rand(static_int_list(shape), generator=gen)
    return _drawn(u * (float(max) - float(min)) + float(min), dtype)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return _drawn(torch.randint(int(low), int(high), static_int_list(shape),
                                generator=default_generator()),
                  dtype or "int64")


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return _drawn(torch.randint(int(low), int(high), tuple(x.shape),
                                generator=default_generator()),
                  dtype or x.dtype)


def randperm(n, dtype=None, name=None):
    return _drawn(torch.randperm(int(n), generator=default_generator()),
                  dtype or "int64")


def _host(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) \
        else torch.as_tensor(np.asarray(x))


def bernoulli(x, name=None):
    p = _host(x)
    return _drawn(torch.bernoulli(p.float(), generator=default_generator()),
                  p.dtype)


def multinomial(x, num_samples=1, replacement=False, name=None):
    return _drawn(torch.multinomial(_host(x).float(), int(num_samples),
                                    bool(replacement),
                                    generator=default_generator()))


def poisson(x, name=None):
    lam = _host(x)
    return _drawn(torch.poisson(lam.float(), generator=default_generator()),
                  lam.dtype)


# ------------------------------------------------------------------ structured


def tril(x, diagonal=0, name=None):
    return _op("tril", x, diagonal=int(diagonal))


def triu(x, diagonal=0, name=None):
    return _op("triu", x, diagonal=int(diagonal))


def diag(x, offset=0, padding_value=0, name=None):
    return _op("diag", x, offset=int(offset), padding_value=padding_value)


def diagflat(x, offset=0, name=None):
    return _op("diagflat", x, offset=int(offset))


def _diag_fwd(x, offset=0, padding_value=0):
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if padding_value:
            off = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
            out = torch.where(off, out, torch.full_like(out, padding_value))
        return out
    return torch.diagonal(x, offset, -2, -1)


register_op("tril", lambda x, diagonal=0: torch.tril(x, diagonal))
register_op("triu", lambda x, diagonal=0: torch.triu(x, diagonal))
register_op("diag", _diag_fwd)
register_op("diagflat", lambda x, offset=0: torch.diagflat(x, offset))
register_op("clone", torch.clone)
register_op("meshgrid", lambda xs: tuple(torch.meshgrid(*xs, indexing="ij")))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(_op("meshgrid", [a if isinstance(a, torch.Tensor)
                                 else to_tensor(a) for a in args]))


def assign(x, output=None):
    """A copy of ``x`` (a tensor, array or list); into ``output`` in place
    when given."""
    src = x if isinstance(x, torch.Tensor) else to_tensor(x)
    if output is not None:
        output.set_value(src)
        return output
    return clone(src)


def clone(x, name=None):
    return _op("clone", x)


def numel(x, name=None):
    return wrap_outputs(torch.tensor(x.numel(), dtype=torch.int64, device=x.device))
