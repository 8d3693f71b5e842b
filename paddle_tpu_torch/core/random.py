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

An activation-recompute region (``distributed/fleet/recompute.py``) must
draw in its recompute the seeds its first forward drew, from whatever
generator each came from: ``record_generators()`` snapshots every
generator a draw resolves (``default_generator``) the first time it does
so inside the block, and ``replay_generators(snapshot)`` sets them back
to those states for the recompute and restores their current states
after it (the JAX package restores its chain around the recompute the
same way).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["make_generator", "next_seed", "seed", "get_seed",
           "get_rng_state", "set_rng_state", "default_generator",
           "check_model_generator", "record_generators",
           "replay_generators"]

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


# the open record_generators() snapshots of this thread, innermost last
_recording = threading.local()


def default_generator(generator: torch.Generator | None = None
                      ) -> torch.Generator:
    """``generator``, or the global chain when it is None. Every draw of
    the port resolves its generator here, so each open
    ``record_generators`` snapshot takes the generator's state the first
    time a draw reaches it."""
    generator = _CHAIN if generator is None else generator
    for snap in getattr(_recording, "open", ()):
        if all(g is not generator for g, _ in snap):
            snap.append((generator, generator.get_state()))
    return generator


@contextmanager
def record_generators(snap: list):
    """Within it, every generator a draw resolves is snapshotted into
    ``snap`` before its first draw, as ``(generator, state)`` pairs for
    ``replay_generators``."""
    stack = getattr(_recording, "open", None)
    if stack is None:
        stack = _recording.open = []
    stack.append(snap)
    try:
        yield
    finally:
        del stack[next(i for i, s in enumerate(stack) if s is snap)]


@contextmanager
def replay_generators(snapshot):
    """Within it, each generator of ``snapshot`` (from
    ``record_generators``) stands at its recorded state, so the block
    draws again the seeds it drew then; each is restored to its current
    state after."""
    now = [(g, g.get_state()) for g, _ in snapshot]
    for g, state in snapshot:
        g.set_state(state)
    try:
        yield
    finally:
        for g, state in now:
            g.set_state(state)


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
