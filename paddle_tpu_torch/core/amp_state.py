"""AMP cast state (counterpart of ``paddle_tpu/core/amp_state.py``).

The JAX package casts the inputs of every op it dispatches by the op's
name: O1 runs the ``WHITE_LIST`` in the low type and the ``BLACK_LIST``
in fp32, O2 runs everything outside the black list in the low type. The
port has no dispatcher of its own, so ``auto_cast`` opens ``_AmpMode``, a
``torch.overrides.TorchFunctionMode`` that names the torch calls it sees
by ``TORCH_NAMES`` (the table below) and casts their tensor arguments by
the same rule. A torch call outside the table runs in its inputs' types,
under O1 as under O2.

The port's own ops (``amp_op``: the flash functionals, dropout, RMSNorm,
RoPE, the LM-head loss) are one op each, as in the JAX package: their
inputs are cast by their name at entry and their bodies run with the mode
suspended, so the plain versions of the kernels on the CPU compute what
the kernels compute on the card.
"""
from __future__ import annotations

import functools
import threading
from contextlib import contextmanager, nullcontext

import torch
import torch.nn.functional as TF
from torch.overrides import TorchFunctionMode

__all__ = ["WHITE_LIST", "BLACK_LIST", "TORCH_NAMES", "AmpAttrs",
           "amp_state", "applied", "amp_op", "maybe_cast_inputs"]

# the O1 lists, the JAX package's op names
WHITE_LIST = {
    "matmul", "linear", "bmm", "mv", "einsum", "conv", "conv_transpose",
    "sdpa", "addmm", "inner", "outer",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "softmax_ce_noreduce",
    "cross_entropy", "cross_entropy_w", "mse_loss", "l1_loss", "bce",
    "bce_logits", "sum", "mean", "norm_fro", "norm_p", "softmax",
    "log_softmax", "cumsum", "layer_norm", "batch_norm_train",
    "batch_norm_infer", "rms_norm", "nll_loss", "kl_div", "pow",
}


def _names():
    t = torch.Tensor
    table = {
        "linear": [TF.linear],
        "matmul": [torch.matmul, t.matmul, t.__matmul__, t.__rmatmul__,
                   torch.mm, t.mm],
        "bmm": [torch.bmm, t.bmm],
        "mv": [torch.mv, t.mv],
        "einsum": [torch.einsum],
        "conv": [TF.conv1d, TF.conv2d, TF.conv3d],
        "conv_transpose": [TF.conv_transpose1d, TF.conv_transpose2d,
                           TF.conv_transpose3d],
        "sdpa": [TF.scaled_dot_product_attention],
        "addmm": [torch.addmm, t.addmm],
        "inner": [torch.inner, t.inner],
        "outer": [torch.outer, t.outer],
        "exp": [torch.exp, t.exp],
        "log": [torch.log, t.log],
        "log2": [torch.log2, t.log2],
        "log10": [torch.log10, t.log10],
        "log1p": [torch.log1p, t.log1p],
        "logsumexp": [torch.logsumexp, t.logsumexp],
        "cross_entropy": [TF.cross_entropy],
        "mse_loss": [TF.mse_loss],
        "l1_loss": [TF.l1_loss],
        "bce": [TF.binary_cross_entropy],
        "bce_logits": [TF.binary_cross_entropy_with_logits],
        "sum": [torch.sum, t.sum],
        "mean": [torch.mean, t.mean],
        "norm_p": [torch.norm, t.norm, torch.linalg.vector_norm],
        "softmax": [torch.softmax, t.softmax, TF.softmax],
        "log_softmax": [torch.log_softmax, t.log_softmax, TF.log_softmax],
        "cumsum": [torch.cumsum, t.cumsum],
        "layer_norm": [TF.layer_norm],
        "batch_norm": [TF.batch_norm],
        "nll_loss": [TF.nll_loss],
        "kl_div": [TF.kl_div],
        "pow": [torch.pow, t.pow, t.__pow__],
        # named for O2, which casts every op outside the black list
        "add": [torch.add, t.add, t.__add__, t.__radd__],
        "subtract": [torch.sub, t.sub, t.__sub__, t.__rsub__],
        "multiply": [torch.mul, t.mul, t.__mul__, t.__rmul__],
        "divide": [torch.div, t.div, t.__truediv__, t.__rtruediv__],
        "gelu": [TF.gelu],
        "silu": [TF.silu],
        "relu": [TF.relu, torch.relu, t.relu],
        "tanh": [torch.tanh, t.tanh],
        "sigmoid": [torch.sigmoid, t.sigmoid],
        "embedding": [TF.embedding],
    }
    return {fn: name for name, fns in table.items() for fn in fns}


# torch callable -> the JAX package's op name
TORCH_NAMES = _names()

_tls = threading.local()


class AmpAttrs:
    """One ``auto_cast`` setting: ``enable``, the low type (bf16, or fp16
    for "float16"), ``level`` ("O1" or "O2") and the custom lists."""

    __slots__ = ("enable", "dtype", "level", "custom_white_list",
                 "custom_black_list")

    def __init__(self, enable, dtype, level, custom_white_list=None,
                 custom_black_list=None):
        if level not in ("O1", "O2"):
            raise ValueError(f"auto_cast: level must be 'O1' or 'O2', got "
                             f"{level!r}")
        self.enable = bool(enable)
        self.dtype = torch.bfloat16 if str(dtype) in (
            "bfloat16", "bf16", "torch.bfloat16") else torch.float16
        self.level = level
        self.custom_white_list = set(custom_white_list or ())
        self.custom_black_list = set(custom_black_list or ())

    def target(self, name: str):
        """The type ``name``'s floating inputs run in: ``(from, to)`` or
        None for no cast (the JAX package's ``maybe_cast_inputs``)."""
        if not self.enable:
            return None
        black = name in BLACK_LIST or name in self.custom_black_list
        if self.level == "O2":
            return (self.dtype, torch.float32) if black \
                else (torch.float32, self.dtype)
        if (name in WHITE_LIST or name in self.custom_white_list) \
                and name not in self.custom_black_list:
            return (torch.float32, self.dtype)
        if black:
            return (self.dtype, torch.float32)
        return None


def amp_state():
    """The ``AmpAttrs`` in force on this thread, or None."""
    return getattr(_tls, "amp", None)


def _cast(obj, src, dst):
    if torch.is_tensor(obj):
        return obj.to(dst) if obj.dtype == src else obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cast(o, src, dst) for o in obj)
    return obj


class _AmpMode(TorchFunctionMode):
    """Casts the tensor arguments of the torch calls ``TORCH_NAMES`` names
    by the state's rule; anything else passes through."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        st = amp_state()
        name = TORCH_NAMES.get(func)
        if name == "batch_norm":
            name = "batch_norm_train" if kwargs.get("training", False) or (
                len(args) > 5 and args[5]) else "batch_norm_infer"
        rule = None if (st is None or name is None
                        or getattr(_tls, "suspended", 0)) \
            else st.target(name)
        if rule is not None:
            args = _cast(args, *rule)
            kwargs = {k: _cast(v, *rule) for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextmanager
def applied(state):
    """Put ``state`` (an ``AmpAttrs``, or None for none) in force on this
    thread for the block: the cast rule and the mode that applies it.
    ``auto_cast`` opens it, and a recompute region reopens its forward's
    state around the recompute, which runs in the backward."""
    prev = amp_state()
    _tls.amp = state
    try:
        with _AmpMode() if state is not None else nullcontext():
            yield
    finally:
        _tls.amp = prev


def amp_op(name: str):
    """Make a port function one AMP op named ``name``: under ``auto_cast``
    its tensor arguments (top level, or in a list or tuple) are cast by the
    name's rule and its body runs with the mode suspended."""
    def wrap(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            st = amp_state()
            if st is None:
                return fn(*args, **kwargs)
            rule = None if getattr(_tls, "suspended", 0) else st.target(name)
            if rule is not None:
                args = _cast(args, *rule)
                kwargs = {k: _cast(v, *rule) for k, v in kwargs.items()}
            _tls.suspended = getattr(_tls, "suspended", 0) + 1
            try:
                return fn(*args, **kwargs)
            finally:
                _tls.suspended -= 1
        return op
    return wrap


def maybe_cast_inputs(name: str, args):
    """``args`` (a list) cast by the rule of the op ``name`` under the
    ``auto_cast`` in force (the JAX package's ``maybe_cast_inputs``, which
    its dispatcher calls for every op): unchanged outside ``auto_cast``
    and inside a suspended body."""
    st = getattr(_tls, "amp", None)
    if st is None or getattr(_tls, "suspended", 0):
        return args
    rule = st.target(name)
    return args if rule is None else [_cast(a, *rule) for a in args]
