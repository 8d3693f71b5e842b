"""Eager op dispatch (counterpart of ``paddle_tpu/core/dispatch.py``).

Every public op of the Paddle surface (``ops``, ``nn.functional``, the
``Tensor`` methods) is a registered forward, and ``apply_op(name, args,
attrs)`` runs it. In the JAX package a forward is a jax function
compiled once per signature into a cached executable and the tape
records a vjp node; here a forward is PyTorch code that eager torch runs
as it comes, and torch autograd records it:

* ``register_op(name, fwd)`` — torch autograd differentiates ``fwd``;
* ``register_op(name, fwd, bwd)`` — the pair becomes one
  ``torch.autograd.Function``: ``bwd(primals, outs, cotangents,
  **attrs)`` returns one gradient (or None) per primal, the JAX
  package's explicit-backward contract.

``apply_op`` is the one place every op passes: the ``auto_cast`` cast by
the op's name (``amp_state.maybe_cast_inputs``; the body then runs with
the cast mode suspended), ``FLAGS_check_nan_inf`` on the outputs, and the
profiler and monitor hooks (``set_profiler_hook``, ``set_monitor_hooks``:
``op_hook(name)`` per call; eager torch builds no per-op executable, so
the compile hook is kept for the JAX package's signature and never
called). The body sees its ``Tensor`` arguments as plain torch tensors
(their class is swapped for the call, so torch methods keep torch's
meaning inside it and nothing is copied or added to the graph) and its
tensor outputs become ``Tensor``s.

``no_grad``, ``enable_grad``, ``set_grad_enabled`` and
``is_grad_enabled`` are torch's own grad mode.
"""
from __future__ import annotations

import time as _time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .amp_state import _tls as _amp_tls
from .amp_state import maybe_cast_inputs
from .flags import flag
from .tensor import Tensor, wrap_outputs

__all__ = ["OpDef", "register_op", "get_op", "apply_op", "no_grad",
           "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "set_profiler_hook", "set_monitor_hooks",
           "clear_executable_cache"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


class OpDef:
    __slots__ = ("name", "fwd", "bwd", "nondiff_inputs", "_function")

    def __init__(self, name: str, fwd: Callable, bwd: Optional[Callable] = None,
                 nondiff_inputs: Sequence[int] = ()):
        self.name = name
        self.fwd = fwd
        self.bwd = bwd
        self.nondiff_inputs = frozenset(nondiff_inputs)
        self._function = None if bwd is None else _explicit_function(self)

    def __call__(self, *args, **attrs):
        if self._function is None:
            return self.fwd(*args, **attrs)
        return self._function.apply(attrs, *args)


def _explicit_function(op: OpDef):
    """``op``'s forward and explicit backward as a
    ``torch.autograd.Function`` (attributes ride as its first argument)."""

    class _Explicit(torch.autograd.Function):
        @staticmethod
        def forward(ctx, attrs, *args):
            out = op.fwd(*args, **attrs)
            outs = out if isinstance(out, tuple) else (out,)
            slots = [i for i, a in enumerate(args) if torch.is_tensor(a)]
            ctx.attrs, ctx.args, ctx.slots = attrs, args, slots
            ctx.n_out = len(outs)
            ctx.save_for_backward(*[args[i] for i in slots], *outs)
            return out

        @staticmethod
        def backward(ctx, *cts):
            saved = ctx.saved_tensors
            primals = list(ctx.args)
            for k, i in enumerate(ctx.slots):
                primals[i] = saved[k]
            outs = saved[len(ctx.slots):]
            grads = op.bwd(tuple(primals), tuple(outs), cts, **ctx.attrs)
            grads = tuple(grads) + (None,) * (len(primals) - len(grads))
            return (None,) + tuple(
                None if i in op.nondiff_inputs else g
                for i, g in enumerate(grads))

    _Explicit.__name__ = f"{op.name}_op"
    return _Explicit


_REGISTRY: Dict[str, OpDef] = {}

# profiler host-tracer hook fn(op_name, t_start, t_end), or None
_PROFILER_HOOK: Optional[Callable[[str, float, float], None]] = None
# monitor hooks: fn(op_name) per dispatch; the compile hook has no event
# to fire on in eager torch (no per-op executable) and is only held
_MONITOR_OP: Optional[Callable[[str], None]] = None
_MONITOR_COMPILE: Optional[Callable[[str, Tuple], None]] = None


def set_profiler_hook(hook):
    global _PROFILER_HOOK
    _PROFILER_HOOK = hook


def set_monitor_hooks(op_hook, compile_hook):
    """Install the monitor's per-op counter (``op_hook(name)``, called at
    every dispatch) and its compile hook (never called: eager torch builds
    no per-op executable). ``None, None`` removes them."""
    global _MONITOR_OP, _MONITOR_COMPILE
    _MONITOR_OP = op_hook
    _MONITOR_COMPILE = compile_hook


def register_op(name: str, fwd: Callable, bwd: Optional[Callable] = None,
                nondiff_inputs: Sequence[int] = ()) -> OpDef:
    op = OpDef(name, fwd, bwd, nondiff_inputs)
    _REGISTRY[name] = op
    return op


def get_op(name: str) -> OpDef:
    return _REGISTRY[name]


def clear_executable_cache():
    """The JAX package drops its per-op executables; eager torch has
    none, so there is nothing to drop."""


def _swap_in(a, swapped, keep):
    """``a`` as the body sees it: a ``Tensor`` with its class swapped to
    ``torch.Tensor`` (recorded in ``swapped``); lists and tuples of
    tensors one level deep. Returns whether ``a`` held a plain tensor
    (the ids of every tensor met go in ``keep``)."""
    if isinstance(a, Tensor):
        swapped.append((a, a.__class__))
        a.__class__ = torch.Tensor
        keep.add(id(a))
        return False
    if type(a) is torch.Tensor:
        keep.add(id(a))
        return True
    if isinstance(a, (list, tuple)):
        plain = False
        for b in a:
            if isinstance(b, torch.Tensor):
                plain = _swap_in(b, swapped, keep) or plain
        return plain
    return False


def _numpy_to_tensors(args):
    """numpy array arguments as tensors on the first tensor argument's
    device."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               None)
    return [torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray)
            else a for a in args]


def _check_nan_inf(name, out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for o in outs:
        if isinstance(o, torch.Tensor) and (o.is_floating_point()
                                            or o.is_complex()):
            if not bool(torch.isfinite(o).all()):
                raise FloatingPointError(
                    f"Operator {name} output contains NaN/Inf "
                    f"(FLAGS_check_nan_inf is enabled)")


def apply_op(name: str, tensor_args: Sequence, attrs: Optional[dict] = None):
    """Run the registered op ``name`` on ``tensor_args`` (tensors, numpy
    arrays, scalars, or lists of tensors) with keyword ``attrs``; returns
    its output(s) as ``Tensor``s, recorded by torch autograd where an
    input needs a gradient. Called with plain torch tensors only (the
    port's own models call the functionals so), it returns plain ones."""
    op = _REGISTRY[name]
    args = maybe_cast_inputs(name, tensor_args)
    if any(isinstance(a, np.ndarray) for a in args):
        args = _numpy_to_tensors(args)
    hook = _PROFILER_HOOK
    t0 = _time.perf_counter() if hook is not None else 0.0
    swapped, keep = [], set()
    plain = False
    try:
        for a in args:
            plain = _swap_in(a, swapped, keep) or plain
        _amp_tls.suspended = getattr(_amp_tls, "suspended", 0) + 1
        try:
            out = op(*args, **(attrs or {}))
        finally:
            _amp_tls.suspended -= 1
    finally:
        for a, cls in reversed(swapped):
            a.__class__ = cls
    if hook is not None:
        hook(name, t0, _time.perf_counter())
    mon = _MONITOR_OP
    if mon is not None:
        mon(name)
    if flag("FLAGS_check_nan_inf"):
        _check_nan_inf(name, out)
    if plain and not swapped:
        return out          # plain torch tensors in, plain out
    return wrap_outputs(out, keep)
