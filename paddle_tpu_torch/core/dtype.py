"""Dtype names <-> ``torch.dtype`` (counterpart of ``paddle_tpu/core/dtype.py``).

Names follow Paddle's spelling (``"float32"``, ``"bf16"``, ...). Unlike the
JAX package, where ``int64`` maps to int32 because XLA runs without 64-bit
mode, ``int64`` here is torch's real 64-bit integer.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "dtype_name", "is_floating_point", "is_integer",
           "is_complex", "is_differentiable", "bool_", "uint8", "int8",
           "int16", "int32", "int64", "float16", "bfloat16", "float32",
           "float64", "complex64", "complex128"]

# the dtype names ``paddle.float32`` etc.: torch's dtypes themselves
bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR_ALIASES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "fp16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float64": torch.float64,
    "fp64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

_NAMES = {torch.bool: "bool", torch.uint8: "uint8", torch.int8: "int8",
          torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.float32: "float32", torch.float64: "float64",
          torch.complex64: "complex64", torch.complex128: "complex128"}


def convert_dtype(dtype) -> torch.dtype:
    """A dtype name, ``torch.dtype`` or numpy dtype -> ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is bool or dtype is float or dtype is int:
        return {bool: torch.bool, float: torch.float32,
                int: torch.int64}[dtype]
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _STR_ALIASES:
            raise ValueError(f"unknown dtype string: {dtype!r}")
        return _STR_ALIASES[key]
    if isinstance(dtype, (type, np.dtype)):
        name = np.dtype(dtype).name
        if name in _STR_ALIASES:
            return _STR_ALIASES[name]       # a numpy dtype or scalar type
    raise TypeError(f"expected a dtype name or torch.dtype, got {dtype!r}")


def dtype_name(dtype) -> str:
    """Canonical name of a dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return _NAMES[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex)


def is_complex(dtype) -> bool:
    return convert_dtype(dtype).is_complex


def is_differentiable(dtype) -> bool:
    d = convert_dtype(dtype)
    return d.is_floating_point or d.is_complex
