"""Seeded generators (counterpart of ``paddle_tpu/core/random.py``).

The port has one global chain, as the JAX package does: a module-level CPU
``torch.Generator`` that ``seed(value)`` reseeds (``paddle.seed``) and
``get_rng_state`` / ``set_rng_state`` read and restore. Whatever draws
random numbers takes an explicit ``torch.Generator`` where it is given one
and the global chain where it is not: ``F.dropout``, ``nn.Dropout``,
``F.add_dropout_ln`` and the attention functionals. The models keep
generators of their own, seeded from their seed, so their masks do not
depend on what else drew from the chain. The chain gives other numbers
than the JAX package's ``jax.random`` key chain from the same seed, so
tests that compare the packages make their data with numpy and hand it to
both. A generator on the GPU gives other numbers than one on the CPU from
the same seed.

Dropout draws one seed per call with ``next_seed`` (the counterpart of the
JAX package's ``int32_seed``, the one seed recipe of its in-kernel PRNG
ops) and hands it to a kernel, which keys a counter-based Philox stream on
it (``kernels/philox.py``). The generators lie on the CPU, so a draw never
waits for the device, and a run on the card and one on the CPU that start
from the same generator state draw the same seeds in the same order:
after ``seed(s)`` a call without a generator drops what the same call
with ``generator=make_generator(s)`` drops.
"""
from __future__ import annotations

import torch

__all__ = ["make_generator", "next_seed", "seed", "get_seed",
           "get_rng_state", "set_rng_state", "default_generator",
           "check_model_generator"]

# the global chain, seeded with 0 as the JAX package's is
_CHAIN = torch.Generator(device="cpu")
_CHAIN.manual_seed(0)
_seed = 0


def make_generator(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def seed(value: int) -> int:
    """``paddle.seed``: reseed the global chain with ``value``; returns
    ``value``."""
    global _seed
    _CHAIN.manual_seed(int(value))
    _seed = int(value)
    return value


def get_seed() -> int:
    """The value the global chain was last seeded with (0 at import)."""
    return _seed


def get_rng_state() -> torch.Tensor:
    """The global chain's state (the generator's uint8 state tensor)."""
    return _CHAIN.get_state()


def set_rng_state(state: torch.Tensor) -> None:
    """Restore the global chain to ``state`` (from ``get_rng_state``)."""
    _CHAIN.set_state(state)


def default_generator(generator: torch.Generator | None = None
                      ) -> torch.Generator:
    """``generator``, or the global chain when it is None."""
    return _CHAIN if generator is None else generator


def check_model_generator(module, generator, *rates) -> None:
    """Raise when a model part (``module``, a ``torch.nn.Module``) drops in
    training at one of ``rates`` without a generator of its own: a model
    never draws its masks from the global chain, whose state depends on
    whatever else drew from it."""
    if module.training and generator is None and any(r > 0 for r in rates):
        raise ValueError(f"{type(module).__name__}: training at dropout > 0 "
                         f"needs the model's own generator (models do not "
                         f"draw from the global chain)")


def next_seed(generator: torch.Generator | None = None) -> int:
    """A fresh 63-bit seed drawn from a CPU ``generator``, or from the
    global chain without one (advances it)."""
    generator = default_generator(generator)
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"next_seed: expected a torch.Generator, got "
                        f"{type(generator).__name__}")
    if generator.device.type != "cpu":
        raise ValueError("next_seed: the generator must lie on the CPU (a "
                         "draw from a device generator would wait for the "
                         "device)")
    return int(torch.empty((), dtype=torch.int64).random_(
        generator=generator))
