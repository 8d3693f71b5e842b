"""Runtime flag registry (counterpart of ``paddle_tpu/core/flags.py``).

Flags are a plain registry seeded from the environment (``FLAGS_*``) and
read by the port at call time. ``FLAGS_check_nan_inf`` makes every op
dispatched through ``core.dispatch.apply_op`` check its outputs.
``FLAGS_eager_jit_ops`` and ``FLAGS_eager_fusion`` are accepted for the
JAX package's scripts and have no effect: eager PyTorch launches each
op's kernels directly, and the deferred-eager graph of
``paddle_tpu/core/lazy.py`` is XLA's (ROADMAP Queue 1, item 11).
``FLAGS_cudnn_deterministic`` sets ``torch.backends.cudnn.deterministic``
(and, when on, turns ``cudnn.benchmark`` off: an autotuned algorithm may
add with atomics), from the environment at import and at every
``set_flags``.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

__all__ = ["define_flag", "set_flags", "get_flags", "flag"]

_FLAGS: Dict[str, Any] = {}
_DEFS: Dict[str, tuple] = {}  # name -> (type, default, help)
_ON_SET: Dict[str, Callable[[Any], None]] = {}


def define_flag(name: str, default, help_str: str = "",
                on_set: Optional[Callable[[Any], None]] = None):
    """Register ``name`` with its default; ``FLAGS_*`` in the environment
    overrides the default (``1``/``true``/``yes``/``on`` for a bool).
    ``on_set(value)`` applies a value where it takes effect: at every
    ``set_flags`` of the flag, and here when the environment sets it."""
    typ = type(default)
    _DEFS[name] = (typ, default, help_str)
    env = os.environ.get(name)
    if env is None:
        _FLAGS[name] = default
    elif typ is bool:
        _FLAGS[name] = env.lower() in ("1", "true", "yes", "on")
    else:
        _FLAGS[name] = typ(env)
    if on_set is not None:
        _ON_SET[name] = on_set
        if env is not None:
            on_set(_FLAGS[name])


def set_flags(flags: Dict[str, Any]):
    """``paddle.set_flags({...})``: an unknown name raises ``KeyError``."""
    for k, v in flags.items():
        if k not in _DEFS:
            raise KeyError(f"unknown flag {k!r}; defined flags: "
                           f"{sorted(_DEFS)}")
        _FLAGS[k] = _DEFS[k][0](v)
        if k in _ON_SET:
            _ON_SET[k](_FLAGS[k])


def get_flags(names):
    """``paddle.get_flags(name or names)`` -> ``{name: value}``."""
    if isinstance(names, str):
        names = [names]
    return {k: _FLAGS[k] for k in names}


def flag(name: str):
    return _FLAGS[name]


define_flag("FLAGS_check_nan_inf", False,
            "check every dispatched op's floating outputs for NaN/Inf")
define_flag("FLAGS_eager_jit_ops", True,
            "accepted, no effect: eager torch launches each op directly")
define_flag("FLAGS_eager_fusion", True,
            "accepted, no effect: the deferred-eager graph is XLA's")
define_flag("FLAGS_use_bf16_matmul", False,
            "accepted, no effect in the port")
define_flag("FLAGS_retain_grad_for_all", False,
            "retain .grad for non-leaf tensors")
define_flag("FLAGS_log_level", 0, "VLOG-style verbosity")
define_flag("FLAGS_allocator_strategy", "auto_growth",
            "accepted for parity; the CUDA caching allocator owns memory")


def _cudnn_deterministic(on: bool):
    import torch
    torch.backends.cudnn.deterministic = bool(on)
    if on:
        torch.backends.cudnn.benchmark = False


define_flag("FLAGS_cudnn_deterministic", False,
            "cuDNN's deterministic algorithms (no autotuning)",
            on_set=_cudnn_deterministic)
define_flag("FLAGS_use_autotune", False, "accepted for parity")
define_flag("FLAGS_autotune_cache_file",
            os.path.join(os.path.expanduser("~"), ".cache",
                         "paddle_tpu_torch", "autotune.json"),
            "accepted for parity")
