"""Seeded generators (counterpart of ``paddle_tpu/core/random.py``).

The JAX package threads one global ``jax.random`` key chain; the port
passes an explicit ``torch.Generator`` to whatever draws random numbers.
The two give different numbers from the same seed, so tests that compare
the packages make their data with numpy and hand it to both. A generator
on the GPU gives other numbers than one on the CPU from the same seed.
"""
from __future__ import annotations

import torch

__all__ = ["make_generator"]


def make_generator(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
