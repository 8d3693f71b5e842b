"""Dropout with the keep mask drawn inside the kernel.

Counterpart of ``paddle_tpu/kernels/pallas/dropout.py`` (``dropout_tpu``,
dropout.py:62-95). One kernel, CUDA C++ for ``sm_90a``
(``csrc/dropout.cu``), built with ``nvcc`` at first use and bound with
``ctypes``:

* ``dropout_fwd(x, seed, rate, upscale)``: ``keep ? x * scale : 0`` in
  fp32, rounded to x's type, with ``scale = 1 / (1 - rate)`` (1 without
  ``upscale``, the training form of ``downscale_in_infer``) and the keep
  mask of ``philox.row_keep(seed, SALT_DROPOUT, ...)`` over the view
  ``[numel / cols, cols]``, ``cols`` the last axis.

``DropoutFunction`` puts it under autograd: the backward launches the same
kernel on the cotangent with the forward's seed, as ``_dropout_vjp_bwd``
does, so the mask exists in device memory in neither direction. On a CUDA
tensor the wrapper launches the kernel; on a CPU tensor it computes
``dropout_fwd_reference``, the same function in plain torch (the same
bits). Anything the kernel does not take raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, philox

__all__ = ["dropout_fwd", "dropout_fwd_reference", "DropoutFunction"]

_DTYPES = (torch.bfloat16, torch.float32)


def _view_shape(x: torch.Tensor):
    """The ``[rows, cols]`` view the mask is keyed on."""
    cols = x.shape[-1] if x.dim() else 1
    return (x.numel() // cols if cols else 0), cols


def _scale(rate: float, upscale: bool) -> float:
    return philox.keep_scale(rate) if upscale else 1.0


def _check(x: torch.Tensor, seed: int, rate: float, plain: bool = False):
    if not 0.0 <= float(rate) < 1.0:
        raise ValueError(f"dropout_fwd: rate must be in [0, 1), got {rate}")
    philox.check_seed(seed)
    if x.dtype not in _DTYPES + ((torch.float64,) if plain else ()):
        raise TypeError(f"dropout_fwd: dtype {x.dtype} is not supported "
                        f"(bfloat16 or float32)")


def dropout_fwd_reference(x: torch.Tensor, seed: int, rate: float,
                          upscale: bool = True) -> torch.Tensor:
    """The kernel's function in plain torch: ``where(keep, x * scale, 0)``
    with ``x * scale`` in fp32 (fp64 for fp64 input), rounded to x's
    type."""
    _check(x, seed, rate, plain=True)
    rows, cols = _view_shape(x)
    keep = philox.row_keep(seed, philox.SALT_DROPOUT, rows, cols, rate,
                           x.device).reshape(x.shape)
    ct = torch.promote_types(x.dtype, torch.float32)
    out = torch.where(keep, x.to(ct) * _scale(rate, upscale), 0.0)
    return out.to(x.dtype)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
             ctypes.c_float, ctypes.c_void_p)


def dropout_fwd(x: torch.Tensor, seed: int, rate: float,
                upscale: bool = True) -> torch.Tensor:
    """Dropout of ``x`` under ``seed`` (a 64-bit int) at ``rate``, in x's
    type and shape.

    A CUDA tensor launches the kernel on the current stream (one launch a
    call, counted in ``dropout_fwd.launches``); a CPU tensor runs
    ``dropout_fwd_reference``. Raises on a rate outside [0, 1), a type
    other than bf16/fp32 and non-contiguous input."""
    _check(x, seed, rate)
    if x.device.type == "cpu":
        return dropout_fwd_reference(x, seed, rate, upscale)
    if x.device.type != "cuda":
        raise ValueError(f"dropout_fwd: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("dropout_fwd: x must be contiguous")
    out = torch.empty_like(x)
    rows, cols = _view_shape(x)
    if rows == 0 or cols == 0:
        return out
    # the seed's words (or a staged seed's address, flagged in the
    # threshold) as every launcher takes them; at rate 0 the threshold
    # keeps every element
    _, lo, hi, thr, _ = philox.kernel_args(rate, seed)
    lib = _build.load("dropout_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dropout_fwd(x.data_ptr(), out.data_ptr(), rows, cols,
                             int(x.dtype == torch.bfloat16), lo, hi, thr,
                             _scale(rate, upscale), stream)
    if rc != 0:
        raise RuntimeError(f"dropout_fwd: kernel launch failed "
                           f"(cudaError {rc})")
    dropout_fwd.launches += 1
    return out


dropout_fwd.launches = 0


class DropoutFunction(torch.autograd.Function):
    """``apply(x, seed, rate, upscale) -> dropout_fwd(x, ...)``; the
    backward is ``dropout_fwd`` on the cotangent with the saved seed (an
    int), which regenerates the forward's mask: ``dx = keep * scale *
    dy``."""

    @staticmethod
    def forward(ctx, x, seed, rate, upscale=True):
        ctx.seed, ctx.rate, ctx.upscale = seed, rate, upscale
        return dropout_fwd(x, seed, rate, upscale)

    @staticmethod
    def backward(ctx, dy):
        return (dropout_fwd(dy.contiguous(), ctx.seed, ctx.rate, ctx.upscale),
                None, None, None)
