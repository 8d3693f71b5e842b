"""Core runtime of the port: dtypes, devices, generators."""
from .device import resolve_device
from .dtype import convert_dtype, dtype_name
from .random import make_generator, next_seed

__all__ = ["resolve_device", "convert_dtype", "dtype_name", "make_generator",
           "next_seed"]
