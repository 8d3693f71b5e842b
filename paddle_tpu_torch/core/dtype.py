"""Dtype names <-> ``torch.dtype`` (counterpart of ``paddle_tpu/core/dtype.py``).

Names follow Paddle's spelling (``"float32"``, ``"bf16"``, ...). Unlike the
JAX package, where ``int64`` maps to int32 because XLA runs without 64-bit
mode, ``int64`` here is torch's real 64-bit integer.
"""
from __future__ import annotations

import torch

__all__ = ["convert_dtype", "dtype_name"]

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
    """A dtype name or ``torch.dtype`` -> ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _STR_ALIASES:
            raise ValueError(f"unknown dtype string: {dtype!r}")
        return _STR_ALIASES[key]
    raise TypeError(f"expected a dtype name or torch.dtype, got {dtype!r}")


def dtype_name(dtype) -> str:
    """Canonical name of a dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return _NAMES[convert_dtype(dtype)]
