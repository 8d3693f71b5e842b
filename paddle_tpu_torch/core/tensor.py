"""The eager Tensor (counterpart of ``paddle_tpu/core/tensor.py``).

``Tensor`` is a ``torch.Tensor`` subclass, so torch autograd, the CUDA
caching allocator, CUDA graphs and every torch function take it as it
is, and it carries Paddle's surface on top: ``stop_gradient`` (the
inverse of ``requires_grad``), ``place``, ``astype``, ``numpy``,
``gradient``, ``clear_grad``, ``set_value``, ``register_hook``,
``backward(grad_tensor, retain_graph)``, and (installed by
``paddle_tpu_torch.ops``) the op methods with Paddle's signatures.

``Parameter`` is both a ``torch.nn.Parameter`` and a ``Tensor``: a
``torch.nn.Module`` registers it, ``Module.to`` casts it in place, and
the port's optimizers, ``jit.TrainStep`` and checkpoints take it as any
parameter. Its defaults are Paddle's: ``trainable``, ``stop_gradient=
False``, a ``name``.

``shape`` stays torch's ``torch.Size`` (a tuple), where the JAX package
returns a list: torch's own Python code and the port's kernel wrappers
read ``x.shape`` as a ``torch.Size`` (``x.shape[:-1] + (n,)``, ``a.shape
== b.shape`` against plain tensors), and ``torch.Size`` cannot be
subclassed. ``list(x.shape)`` is Paddle's list. ``size`` is Paddle's
element count, an int that is also callable as torch's ``size()``.

A torch function called on a ``Tensor`` returns a ``Tensor``
(``__torch_function__``); ops dispatched through ``core.dispatch``
run their bodies on plain tensors and make their outputs ``Tensor``s.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from . import dtype as dtypes
from .device import Place, get_default_place, to_place

__all__ = ["Tensor", "Parameter", "to_tensor", "wrap_outputs"]

_DisableSubclass = torch._C.DisableTorchFunctionSubclass


class _SizeInt(int):
    """Paddle's ``x.size`` (the element count, an int) that torch code can
    still call as ``x.size()`` / ``x.size(dim)``."""

    def __call__(self, dim=None):
        return self._shape if dim is None else self._shape[dim]


def _as_plain_array(data, dtype):
    """``to_tensor``'s host conversion: Python scalars and lists follow
    Paddle's defaults (float -> float32, int -> int64, bool -> bool)."""
    arr = np.asarray(data)
    if dtype is None and arr.dtype == np.float64:
        arr = arr.astype(np.float32)    # the JAX package's default float
    return arr


def _to_torch(data, dtype=None, device=None) -> torch.Tensor:
    """``data`` (a tensor, numpy array, scalar or nested list) as a plain
    torch tensor of ``dtype`` on ``device`` (a ``torch.device``)."""
    dt = dtypes.convert_dtype(dtype) if dtype is not None else None
    if isinstance(data, torch.Tensor):
        t = data.detach()
        if type(t) is not torch.Tensor:
            t = t.as_subclass(torch.Tensor)
    else:
        arr = _as_plain_array(data, dt)
        if arr.dtype == object:
            raise TypeError(f"to_tensor: cannot convert {type(data)!r}")
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if dt is not None and t.dtype != dt:
        t = t.to(dt)
    if device is not None and t.device != device:
        t = t.to(device)
    return t


def _make(cls, data: torch.Tensor, requires_grad: bool):
    """A leaf of class ``cls`` over ``data``'s storage."""
    return torch.Tensor._make_subclass(cls, data, requires_grad)


class Tensor(torch.Tensor):
    """Paddle's eager Tensor on a ``torch.Tensor``.

    ``Tensor(data, dtype=None, place=None, stop_gradient=True, name=None)``
    is ``to_tensor``."""

    def __new__(cls, data=None, dtype=None, place=None,
                stop_gradient: bool = True, name: Optional[str] = None):
        if data is None:
            data = np.zeros([0], np.float32)
        dev = to_place(place).device if place is not None \
            else get_default_place().device
        t = _make(cls, _to_torch(data, dtype, dev), not stop_gradient)
        if name:
            t.name = name
        return t

    def __init__(self, *args, **kwargs):
        pass

    __hash__ = torch.Tensor.__hash__

    def __deepcopy__(self, memo):
        """A leaf with a copy of the values, the same ``stop_gradient``
        and a deep copy of the Paddle attributes (torch's own deep copy of
        a subclass wants ``new_empty`` to keep the class, which it does not
        under ``__torch_function__``): ``copy.deepcopy`` of a layer with
        buffers (a batch norm's ``_mean``)."""
        if id(self) in memo:
            return memo[id(self)]
        with torch.no_grad(), _DisableSubclass():
            data = torch.Tensor.clone(torch.Tensor.detach(self))
        new = _make(type(self), data, self.requires_grad)
        new.__dict__.update(copy.deepcopy(self.__dict__, memo))
        memo[id(self)] = new
        return new

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with _DisableSubclass():
            ret = func(*args, **(kwargs or {}))
        return torch._tensor._convert(ret, Tensor)

    # --------------------------------------------------------- metadata

    @property
    def name(self) -> str:
        return self.__dict__.get("_pd_name", "")

    @name.setter
    def name(self, value):
        self.__dict__["_pd_name"] = "" if value is None else str(value)

    @property
    def persistable(self) -> bool:
        return self.__dict__.get("_pd_persistable", False)

    @persistable.setter
    def persistable(self, value):
        self.__dict__["_pd_persistable"] = bool(value)

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        if self.is_leaf:
            self.requires_grad_(not value)
        elif value:
            self.detach_()
        else:
            raise RuntimeError("stop_gradient=False on a tensor an op made: "
                               "it already follows its inputs")

    @property
    def size(self):
        with _DisableSubclass():
            shape = torch.Tensor.size(self)
        n = _SizeInt(shape.numel())
        n._shape = shape
        return n

    @property
    def place(self) -> Place:
        return Place(self.device)

    def rank(self) -> int:
        return self.dim()

    def numpy(self) -> np.ndarray:
        """The values on the host (bf16 comes back as float32: numpy has no
        bfloat16)."""
        with _DisableSubclass():
            t = torch.Tensor.detach(self)
            if t.dtype == torch.bfloat16:
                t = t.float()
            return torch.Tensor.numpy(t.cpu())

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __array__(self, dtype=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self, **kwargs):
        with _DisableSubclass():
            body = torch.Tensor.__repr__(
                self.detach().as_subclass(torch.Tensor))
        return (f"Tensor(shape={list(self.shape)}, "
                f"dtype={dtypes.dtype_name(self.dtype)}, place={self.place}, "
                f"stop_gradient={self.stop_gradient},\n       {body})")

    # --------------------------------------------------------- autograd

    def gradient(self):
        """The gradient as a numpy array, or None."""
        g = self.grad
        return None if g is None else Tensor.numpy(g)

    def clear_grad(self):
        self.grad = None

    def clear_gradient(self, set_to_zero: bool = False):
        if set_to_zero and self.grad is not None:
            with torch.no_grad():
                self.grad.zero_()
        else:
            self.grad = None

    def register_hook(self, hook):
        """A backward hook on this tensor's gradient; it gets the gradient
        as a ``Tensor`` and may return a replacement. Returns a handle with
        ``remove()``."""
        def call(g):
            r = hook(g.as_subclass(Tensor) if type(g) is torch.Tensor else g)
            if isinstance(r, Tensor) and type(r) is not torch.Tensor:
                r = r.as_subclass(torch.Tensor)
            return r
        with _DisableSubclass():
            return torch.Tensor.register_hook(self, call)

    def backward(self, grad_tensor=None, retain_graph: bool = False,
                 create_graph: bool = False, inputs=None):
        """``loss.backward(grad_tensor=None, retain_graph=False)``: the
        gradients of every leaf with ``stop_gradient=False`` accumulate
        into their ``.grad``."""
        if grad_tensor is not None and not isinstance(grad_tensor,
                                                      torch.Tensor):
            grad_tensor = torch.as_tensor(np.asarray(grad_tensor),
                                          dtype=self.dtype,
                                          device=self.device)
        torch.autograd.backward(self, grad_tensor, retain_graph=retain_graph,
                                create_graph=create_graph, inputs=inputs)

    def retain_grads(self):
        self.retain_grad()

    def detach_(self):
        with _DisableSubclass():
            torch.Tensor.detach_(self)
        return self

    # --------------------------------------------------------- mutation

    def set_value(self, value):
        """Copy ``value`` (a tensor, numpy array or list) into this tensor
        in place, cast to its type; the shapes must match."""
        src = _to_torch(value, self.dtype, self.device)
        if tuple(src.shape) != tuple(self.shape):
            raise ValueError(f"set_value: shape {list(src.shape)} does not "
                             f"match {list(self.shape)}")
        with torch.no_grad(), _DisableSubclass():
            torch.Tensor.copy_(self, src)
        return self

    # --------------------------------------------------------- devices

    def to(self, *args, **kwargs):
        """``to(device)``, ``to(dtype)``, ``to(device, dtype)`` with Paddle's
        device strings, places and dtype names, or torch's arguments."""
        args = list(args)
        for i, a in enumerate(args):
            if isinstance(a, Place):
                args[i] = a.device
            elif isinstance(a, str):
                if a.split(":")[0] in ("cpu", "gpu", "cuda", "tpu", "xpu"):
                    args[i] = to_place(a).device
                else:
                    args[i] = dtypes.convert_dtype(a)
        if isinstance(kwargs.get("device"), (Place, str)):
            kwargs["device"] = to_place(kwargs["device"]).device
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = dtypes.convert_dtype(kwargs["dtype"])
        kwargs.pop("blocking", None)
        return torch.Tensor.to(self, *args, **kwargs)


class Parameter(Tensor, torch.nn.Parameter):
    """A trainable tensor (Paddle's ``EagerParamBase``): a
    ``torch.nn.Parameter`` and a ``Tensor``.

    ``Parameter(data, requires_grad=True, *, name=None, trainable=None)``
    keeps ``torch.nn.Parameter``'s positional form (torch rebuilds
    parameters by it); ``trainable`` overrides ``requires_grad``.

    As a ``torch.nn.Parameter`` does, it opts out of
    ``__torch_function__``: a torch function or a torch method that the
    Paddle surface does not override (``p.float()``, ``p.mul_(...)``,
    ``p.grad``) treats it as a plain tensor, so the optimizers, the train
    step and the port's models pay nothing for it; its Paddle methods and
    the ops still give ``Tensor``s."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __new__(cls, data=None, requires_grad=True, *, name=None,
                trainable=None, dtype=None):
        if data is None:
            data = torch.empty(0)
        if trainable is not None:
            requires_grad = bool(trainable)
        dev = data.device if isinstance(data, torch.Tensor) else \
            get_default_place().device
        p = _make(cls, _to_torch(data, dtype, dev), requires_grad)
        p.name = name
        p.persistable = True
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.is_distributed = False
        return p

    def __init__(self, *args, **kwargs):
        pass

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        with torch.no_grad():
            p = Parameter(self.detach().clone(), self.requires_grad)
        p.__dict__.update({k: v for k, v in self.__dict__.items()
                           if k != "_pd_name"})
        p.name = self.name
        memo[id(self)] = p
        return p

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    @property
    def param_name(self) -> str:
        """The name the port's optimizers key state and decay by."""
        return self.name

    @param_name.setter
    def param_name(self, value):
        self.name = value

    def __repr__(self, **kwargs):
        return "Parameter containing:\n" + super().__repr__()


def wrap_outputs(out, keep=frozenset()):
    """Make the plain torch tensors in an op's output (a tensor, or a
    tuple or list of them) ``Tensor``s in place of their class, except
    those whose ``id`` is in ``keep`` (the op's own inputs)."""
    if type(out) is torch.Tensor:
        if id(out) not in keep:
            out.__class__ = Tensor
        return out
    if isinstance(out, tuple):
        items = [wrap_outputs(o, keep) for o in out]
        if type(out) is tuple:
            return tuple(items)
        # a namedtuple takes fields, torch's return types a sequence
        return type(out)(*items) if hasattr(out, "_fields") \
            else type(out)(items)
    if isinstance(out, list):
        return [wrap_outputs(o, keep) for o in out]
    return out


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True
              ) -> Tensor:
    """``paddle.to_tensor``: a new leaf ``Tensor`` holding a copy of
    ``data`` on ``place`` (the default place: the card, or what
    ``set_device`` chose). Python floats become float32 and ints int64
    (the JAX package's int64 is int32: XLA runs without 64-bit mode)."""
    if isinstance(data, torch.Tensor):
        data = data.detach().clone()
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)
