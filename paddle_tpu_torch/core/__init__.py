"""Core runtime of the port: dtypes, devices, generators and the global
random chain."""
from .device import resolve_device
from .dtype import convert_dtype, dtype_name
from .random import (get_rng_state, get_seed, make_generator, next_seed,
                     seed, set_rng_state)

__all__ = ["resolve_device", "convert_dtype", "dtype_name", "make_generator",
           "next_seed", "seed", "get_seed", "get_rng_state", "set_rng_state"]
