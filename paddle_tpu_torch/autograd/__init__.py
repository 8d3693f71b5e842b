"""``paddle.autograd`` (counterpart of ``paddle_tpu/autograd/__init__.py``):
``backward``, and ``PyLayer``, the user-defined op with its own forward
and backward, on ``torch.autograd.Function``.

A ``PyLayer``'s ``forward(ctx, *args, **kwargs)`` runs under no grad on
the arguments as given; ``ctx.save_for_backward(*tensors)`` keeps tensors
for ``backward(ctx, *grads)``, which returns one gradient (or None) per
tensor argument of ``forward``, in order. Double grad through a
``PyLayer`` is not supported (as in the JAX package). ``jvp``, ``vjp``,
``Jacobian`` and ``Hessian`` (``autograd/functional.py``) are ROADMAP
Queue 1, item 1's rest.
"""
from __future__ import annotations

from typing import List

import torch

from ..core.autograd import run_backward
from ..core.tensor import Tensor, wrap_outputs

__all__ = ["backward", "PyLayer", "PyLayerContext", "PyLayerMeta",
           "LegacyPyLayer"]


def backward(tensors: List[Tensor], grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward(tensors, grad_tensors, retain_graph)``."""
    run_backward(tensors, grad_tensors, retain_graph)


class PyLayerContext:
    """What ``forward`` and ``backward`` share: ``save_for_backward``,
    ``saved_tensor`` (a tuple), and any attribute set on it."""

    def __init__(self):
        self._saved = ()
        self.materialize_grads = True
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


def _function_of(layer_cls):
    """``layer_cls``'s forward and backward as one
    ``torch.autograd.Function`` (built once per class)."""
    fn = layer_cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, kwargs, *args):
            pctx = PyLayerContext()
            out = layer_cls.forward(pctx, *args, **kwargs)
            saved = pctx._saved
            tensors = [i for i, t in enumerate(saved)
                       if isinstance(t, torch.Tensor)]
            ctx.save_for_backward(*[saved[i] for i in tensors])
            pctx._saved = ()
            ctx.pctx, ctx.saved_slots, ctx.n_saved = pctx, tensors, saved
            ctx.tensor_args = [isinstance(a, torch.Tensor) for a in args]
            return out

        @staticmethod
        def backward(ctx, *grads):
            pctx = ctx.pctx
            saved = list(ctx.n_saved)
            for i, t in zip(ctx.saved_slots, ctx.saved_tensors):
                saved[i] = wrap_outputs(t)
            pctx._saved = tuple(saved)
            got = layer_cls.backward(pctx, *[wrap_outputs(g) for g in grads])
            got = list(got) if isinstance(got, (tuple, list)) else [got]
            n = sum(ctx.tensor_args)
            if len(got) != n:
                raise RuntimeError(
                    f"{layer_cls.__name__}.backward returned {len(got)} "
                    f"grads for {n} tensor inputs")
            it = iter(got)
            return (None,) + tuple(next(it) if is_t else None
                                   for is_t in ctx.tensor_args)

    _Fn.__name__ = f"{layer_cls.__name__}Backward"
    layer_cls._torch_function = _Fn
    return _Fn


class PyLayerMeta(type):
    def __init__(cls, name, bases, attrs):
        super().__init__(name, bases, attrs)


class PyLayer(metaclass=PyLayerMeta):
    """User-defined autograd op::

        class Exp(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = paddle.exp(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                (y,) = ctx.saved_tensor
                return dy * y
    """

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return wrap_outputs(_function_of(cls).apply(kwargs, *args))


LegacyPyLayer = PyLayer
