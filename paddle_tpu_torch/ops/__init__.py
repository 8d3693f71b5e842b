"""The op corpus and the ``Tensor`` methods (counterpart of
``paddle_tpu/ops/__init__.py``).

``_install_tensor_methods`` puts the ops on ``core.tensor.Tensor`` with
Paddle's signatures (``x.transpose([1, 0])``, ``x.split(3)`` into three
parts, ``x.max(axis)`` the values only, ``x.astype("float16")``), the
operators through the same ops, indexing through the ``getitem`` /
``setitem`` ops, and the in-place ``*_`` methods. Where torch's own code
calls a method on a ``Tensor`` with torch's signature (``x.reshape(2,
3)``, ``x.transpose(0, 1)``, ``x.view(torch.int32)``, ``x.expand(2, 3)``,
``x.sum(dim=0)``, ``x.size()``, ``x.numel()``) the method takes that form
too; ``clone`` and ``numel`` stay torch's.

A method whose name torch gives another meaning (``split``, ``max``,
``sort``, ``gather``, ``where``, ``normal_``... : ``_CLASHES``) keeps
torch's meaning for a call in torch's form: one its arguments tell apart
(``dim=``, ``generator=``, an int where Paddle takes an index tensor),
and any call from torch's own Python code (``torch.split(x, 2)`` calls
``x.split(2, 0)``; ``torch.nn.init.normal_`` calls ``x.normal_(0, 1,
generator=g)``) or from the port's kernel wrappers (a kernel's backward
gets its saved ``Tensor`` arguments back). Anything else, the user's own
``x.split(3)``, has Paddle's meaning.
"""
from __future__ import annotations

import builtins
import sys

import torch

from ..core.dispatch import apply_op, register_op
from ..core.random import default_generator
from ..core.tensor import Tensor
from . import creation as _creation
from . import linalg
from . import logic as _logic
from . import manipulation as _manip
from . import math as _math
from .creation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403

__all__ = (list(_creation.__all__) + list(_math.__all__)
           + list(_manip.__all__) + list(_logic.__all__) + ["linalg"])


def _op(name, *tensors, **attrs):
    return apply_op(name, tensors, attrs)


# ---------------------------------------------------------------- indexing


def _plain_index(index):
    """An index with its ``Tensor`` items as plain tensors (aliases)."""
    if isinstance(index, tuple):
        return tuple(_plain_index(i) for i in index)
    if isinstance(index, Tensor):
        return index.as_subclass(torch.Tensor)
    return index


register_op("getitem", lambda x, index=None: torch.Tensor.__getitem__(
    x, index))


def _setitem_fwd(x, value, index=None):
    torch.Tensor.__setitem__(x, index, value)
    return x


register_op("setitem", _setitem_fwd)


def _tensor_getitem(self, index):
    return _op("getitem", self, index=_plain_index(index))


def _tensor_setitem(self, index, value):
    """``x[index] = value`` in place (cast to ``x``'s type); on a leaf that
    needs a gradient it raises, as Paddle does."""
    _op("setitem", self, value, index=_plain_index(index))


# ---------------------------------------------------------------- operators


def _rhs(o, like):
    """A reversed operator's left operand as a tensor beside ``like``: a
    scalar becomes a 0-d tensor of the promoted type made on the device
    (no host copy, so a CUDA-graph capture takes it)."""
    if isinstance(o, torch.Tensor):
        return o
    if isinstance(o, (bool, int, float)):
        return torch.full((), o, dtype=torch.result_type(like, o),
                          device=like.device)
    return to_tensor(o, place=like.place)  # noqa: F405


def _bool_or(logical, bitwise):
    return lambda s, o: (logical if s.dtype == torch.bool else bitwise)(s, o)


_OPERATORS = {
    "__add__": lambda s, o: add(s, o),  # noqa: F405
    "__radd__": lambda s, o: add(s, o),  # noqa: F405
    "__sub__": lambda s, o: subtract(s, o),  # noqa: F405
    "__rsub__": lambda s, o: subtract(_rhs(o, s), s),  # noqa: F405
    "__mul__": lambda s, o: multiply(s, o),  # noqa: F405
    "__rmul__": lambda s, o: multiply(s, o),  # noqa: F405
    "__truediv__": lambda s, o: divide(s, o),  # noqa: F405
    "__rtruediv__": lambda s, o: divide(_rhs(o, s), s),  # noqa: F405
    "__floordiv__": lambda s, o: floor_divide(s, o),  # noqa: F405
    "__rfloordiv__": lambda s, o: floor_divide(_rhs(o, s), s),  # noqa: F405
    "__mod__": lambda s, o: remainder(s, o),  # noqa: F405
    "__rmod__": lambda s, o: remainder(_rhs(o, s), s),  # noqa: F405
    "__pow__": lambda s, o: pow(s, o),  # noqa: F405
    "__rpow__": lambda s, o: pow(_rhs(o, s), s),  # noqa: F405
    "__matmul__": lambda s, o: matmul(s, o),  # noqa: F405
    "__rmatmul__": lambda s, o: matmul(_rhs(o, s), s),  # noqa: F405
    "__neg__": lambda s: neg(s),  # noqa: F405
    "__abs__": lambda s: abs(s),  # noqa: F405
    "__invert__": lambda s: logical_not(s) if s.dtype == torch.bool  # noqa
    else bitwise_not(s),  # noqa: F405
    "__eq__": lambda s, o: equal(s, o),  # noqa: F405
    "__ne__": lambda s, o: not_equal(s, o),  # noqa: F405
    "__lt__": lambda s, o: less_than(s, o),  # noqa: F405
    "__le__": lambda s, o: less_equal(s, o),  # noqa: F405
    "__gt__": lambda s, o: greater_than(s, o),  # noqa: F405
    "__ge__": lambda s, o: greater_equal(s, o),  # noqa: F405
    "__and__": _bool_or(logical_and, bitwise_and),  # noqa: F405
    "__or__": _bool_or(logical_or, bitwise_or),  # noqa: F405
    "__xor__": _bool_or(logical_xor, bitwise_xor),  # noqa: F405
    "__getitem__": _tensor_getitem,
    "__setitem__": _tensor_setitem,
}


# ------------------------------------------------------- torch-form methods


def _shape_args(args):
    """``f(2, 3)`` or ``f([2, 3])`` -> the shape."""
    if len(args) == 1 and not isinstance(args[0], int):
        return args[0]
    return args


def _reshape_m(self, *shape, name=None):
    return reshape(self, _shape_args(shape))  # noqa: F405


def _view_m(self, *shape, name=None):
    if len(shape) == 1 and isinstance(shape[0], torch.dtype):
        return torch.Tensor.view(self, shape[0])
    return reshape(self, _shape_args(shape))  # noqa: F405


def _transpose_m(self, *perm, name=None):
    if len(perm) == 2 and builtins.all(isinstance(p, int) for p in perm):
        return _op("swapaxes", self, a=perm[0], b=perm[1])
    return transpose(self, _shape_args(perm))  # noqa: F405


register_op("swapaxes", lambda x, a=0, b=1: torch.transpose(x, a, b))


def _expand_m(self, *shape, name=None):
    return expand(self, _shape_args(shape))  # noqa: F405


def _reduction_m(fn):
    """The reduction ``fn`` as a method: ``x.sum(axis, keepdim)``, with
    ``dtype=`` the type it accumulates in (``x`` is cast first, as torch
    does); torch's own method for a call in torch's form (``dim=``, a
    floating tensor or ``other=``, which torch's ``max`` and ``min`` take
    elementwise, or a call from torch's code: ``x.max(dim=1)`` gives
    values and indices)."""
    torch_method = getattr(torch.Tensor, fn.__name__)

    def method(self, *args, **kwargs):
        if _REDUCTION_TORCH_FORM(args, kwargs) or _torch_caller():
            return torch_method(self, *args, **kwargs)
        return _paddle(self, *args, **kwargs)

    def _paddle(self, axis=None, keepdim=False, name=None, *, dtype=None):
        if dtype is not None:
            self = cast(self, dtype)  # noqa: F405
        return fn(self, axis, keepdim)
    method.__name__ = fn.__name__
    method.__doc__ = fn.__doc__
    return method


# ------------------------------------- names torch gives another meaning

# callers whose method calls keep torch's meaning: torch's Python code and
# the port's kernel wrappers
_TORCH_MODULES = ("torch.", "paddle_tpu_torch.kernels")


def _torch_caller(depth=2):
    """Whether the code ``depth`` frames up (the caller of the method that
    asks) is torch's own or one of the port's kernel wrappers."""
    mod = sys._getframe(depth).f_globals.get("__name__", "")
    return mod == "torch" or mod.startswith(_TORCH_MODULES)


def _kw(*names):
    names = frozenset(names)
    return lambda args, kw: not names.isdisjoint(kw)


def _first(pred):
    return lambda args, kw: bool(args) and pred(args[0])


def _either(*tests):
    return lambda args, kw: builtins.any(t(args, kw) for t in tests)


def _is_int(a):
    return isinstance(a, int) and not isinstance(a, bool)


def _is_float_tensor(a):
    return isinstance(a, torch.Tensor) and a.is_floating_point()


def _never(args, kw):
    return False


_REDUCTION_TORCH_FORM = _either(_kw("dim", "other"), _first(_is_float_tensor))

# name -> what tells a torch-form call apart by its arguments (the rest
# is told apart by its caller): torch's keyword names, an int ``dim``
# where Paddle's first argument is an index tensor, a bool where Paddle
# takes an axis or a mode, a floating tensor where Paddle takes an axis
_CLASHES = {
    "split": _kw("split_size", "split_size_or_sections", "dim"),
    "sort": _kw("dim", "stable"),
    "gather": _either(_kw("dim", "sparse_grad"), _first(_is_int)),
    "index_select": _either(_kw("dim"), _first(_is_int)),
    "index_add": _either(_kw("dim", "source", "alpha"), _first(_is_int)),
    "scatter": _either(_kw("dim", "src", "value", "reduce"),
                       _first(_is_int)),
    "where": _never,
    "equal": _never,
    "std": _either(_kw("dim", "correction"), _first(
        lambda a: isinstance(a, bool))),
    "var": _either(_kw("dim", "correction"), _first(
        lambda a: isinstance(a, bool))),
    "unique": _kw("sorted", "dim"),
    "svd": _kw("some", "compute_uv"),
    "qr": _either(_kw("some"), _first(lambda a: isinstance(a, bool))),
    "triangular_solve": _never,
    "slogdet": _never,
    "histogram": _either(_kw("range", "weight", "density"),
                         _first(lambda a: isinstance(a, torch.Tensor))),
    "cov": _kw("correction"),
    "add": _kw("alpha"),
    "subtract": _kw("alpha"),
    "divide": _kw("rounding_mode"),
    "bernoulli": _either(_kw("p", "generator"), lambda args, kw: bool(args)),
    "uniform_": _kw("generator", "from", "to"),
    "normal_": _kw("generator"),
}


def _clashing(name, paddle_method):
    """``name``'s method: torch's for a call in torch's form (``_CLASHES``
    or a torch caller), else ``paddle_method``."""
    torch_method = getattr(torch.Tensor, name)
    torch_form = _CLASHES[name]

    def method(self, *args, **kwargs):
        if torch_form(args, kwargs) or _torch_caller():
            return torch_method(self, *args, **kwargs)
        return paddle_method(self, *args, **kwargs)
    method.__name__ = method.__qualname__ = name
    method.__doc__ = paddle_method.__doc__
    return method


# ---------------------------------------------------------------- in place


def _make_inplace(name, torch_fn):
    """``x.name_(*args)``: the op in place on ``x`` (its version bumped, so
    torch autograd catches a stale saved tensor); returns ``x``."""
    def body(x, *args, **kw):
        torch_fn(x, *args, **kw)
        return x
    register_op(name, body)

    def method(self, *args, **kw):
        return _op(op_name, self, *args, **kw)
    op_name = name
    method.__name__ = name
    return method


def _as_host_scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _scale_(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x.mul_(scale).add_(bias)
    return x.add_(bias).mul_(scale)


def _clip_(x, min=None, max=None):
    return x.clamp_(_as_host_scalar(min), _as_host_scalar(max))


def _draw_into(self, draw):
    """Fill ``self`` in place with a host draw from the global chain (the
    same values on the card as on the CPU)."""
    host = draw(torch.empty(tuple(self.shape), dtype=torch.float32))
    with torch.no_grad():
        torch.Tensor.copy_(self, host)
    return self


def _uniform_(self, min=-1.0, max=1.0, seed=0):
    gen = torch.Generator().manual_seed(int(seed)) if seed \
        else default_generator()
    return _draw_into(self, lambda t: t.uniform_(float(min), float(max),
                                                 generator=gen))


def _normal_(self, mean=0.0, std=1.0):
    return _draw_into(self, lambda t: t.normal_(float(mean), float(std),
                                                generator=default_generator()))


_SKIP = {"to_tensor", "is_tensor", "meshgrid", "zeros", "ones", "full",
         "empty", "arange", "linspace", "logspace", "eye", "rand", "randn",
         "randint", "uniform", "normal", "randperm", "one_hot", "einsum",
         "multi_dot", "broadcast_tensors", "standard_normal", "clone",
         "numel"}


def _install_tensor_methods():
    T = Tensor
    for nm, fn in _OPERATORS.items():
        setattr(T, nm, fn)
    table = {}
    for mod in (_math, _manip, _logic, _creation, linalg):
        for nm in mod.__all__:
            fn = getattr(mod, nm, None)
            if callable(fn):
                table.setdefault(nm, fn)
    for nm, fn in table.items():
        if nm not in _SKIP:
            setattr(T, nm, fn)
    for nm in ("sum", "mean", "max", "min", "amax", "amin", "prod", "all",
               "any", "nansum", "nanmean", "logsumexp", "median"):
        setattr(T, nm, _reduction_m(getattr(_math, nm)))
    T.reshape = _reshape_m
    T.view = _view_m
    T.transpose = _transpose_m
    T.expand = _expand_m
    T.astype = lambda s, dtype: cast(s, dtype)  # noqa: F405
    T.cast = lambda s, dtype: cast(s, dtype)  # noqa: F405
    T.mm = lambda s, o: matmul(s, o)  # noqa: F405
    T.dot = _math.dot
    for nm, fn in (("add_", torch.Tensor.add_),
                   ("subtract_", torch.Tensor.sub_),
                   ("multiply_", torch.Tensor.mul_),
                   ("divide_", torch.Tensor.div_),
                   ("scale_", _scale_), ("clip_", _clip_),
                   ("exp_", torch.Tensor.exp_), ("sqrt_", torch.Tensor.sqrt_),
                   ("rsqrt_", torch.Tensor.rsqrt_),
                   ("floor_", torch.Tensor.floor_),
                   ("ceil_", torch.Tensor.ceil_),
                   ("round_", torch.Tensor.round_),
                   ("reciprocal_", torch.Tensor.reciprocal_),
                   ("fill_", torch.Tensor.fill_),
                   ("zero_", torch.Tensor.zero_)):
        setattr(T, nm, _make_inplace(nm, fn))
    T.uniform_ = _uniform_
    T.normal_ = _normal_
    for nm in _CLASHES:
        setattr(T, nm, _clashing(nm, getattr(T, nm)))


_install_tensor_methods()
