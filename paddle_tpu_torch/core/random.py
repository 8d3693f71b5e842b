"""Seeded generators (counterpart of ``paddle_tpu/core/random.py``).

The JAX package threads one global ``jax.random`` key chain; the port
passes an explicit ``torch.Generator`` to whatever draws random numbers.
The two give different numbers from the same seed, so tests that compare
the packages make their data with numpy and hand it to both.
"""
from __future__ import annotations

import torch

__all__ = ["make_generator"]


def make_generator(seed: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded with ``seed`` (weights are drawn
    on the CPU, then moved to their device)."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g
