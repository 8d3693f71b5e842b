"""Seeded generators (counterpart of ``paddle_tpu/core/random.py``).

The JAX package threads one global ``jax.random`` key chain; the port
passes an explicit ``torch.Generator`` to whatever draws random numbers.
The two give different numbers from the same seed, so tests that compare
the packages make their data with numpy and hand it to both. A generator
on the GPU gives other numbers than one on the CPU from the same seed.

Dropout draws one seed per call with ``next_seed`` (the counterpart of the
JAX package's ``int32_seed``, the one seed recipe of its in-kernel PRNG
ops) and hands it to a kernel, which keys a counter-based Philox stream on
it (``kernels/philox.py``). The generator lies on the CPU, so a draw never
waits for the device, and a run on the card and one on the CPU that start
from the same generator state draw the same seeds in the same order.
"""
from __future__ import annotations

import torch

__all__ = ["make_generator", "next_seed"]


def make_generator(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def next_seed(generator: torch.Generator) -> int:
    """A fresh 63-bit seed drawn from a CPU ``generator`` (advances it)."""
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"next_seed: expected a torch.Generator, got "
                        f"{type(generator).__name__}")
    if generator.device.type != "cpu":
        raise ValueError("next_seed: the generator must lie on the CPU (a "
                         "draw from a device generator would wait for the "
                         "device)")
    return int(torch.empty((), dtype=torch.int64).random_(
        generator=generator))
