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

Inside a training program (``jit.TrainStep``'s fast path) draws become seed
slots (``SeedStage``): a captured graph cannot read a Python int the host
draws at each call, so each draw returns a ``kernels.philox.DeviceSeed``,
one element of the program's staged seed buffer, keyed on which generator
it came from and which of that generator's draws in the step it was.
Before each call the host draws the same seeds in the same order from the
same generators into the buffer (``SeedStage.draw``), so N captured steps
drop what N eager steps drop and leave every generator where they leave
it. A recompute's replay reads the slots its forward drew: while a stage
runs, a generator's state is its draw count in the step, which
``record_generators`` snapshots and ``replay_generators`` winds back.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.philox import DeviceSeed

__all__ = ["make_generator", "next_seed", "seed", "get_seed",
           "get_rng_state", "set_rng_state", "default_generator",
           "check_model_generator", "record_generators",
           "replay_generators", "SeedStage"]

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
            snap.append((generator, _state_of(generator)))
    return generator


def _state_of(generator):
    """A generator's state: inside a running ``SeedStage`` its draw count
    in the step (with the stage), else the generator's own state."""
    stage = _running_stage()
    if stage is not None:
        return (stage, stage.cursor(generator))
    return generator.get_state()


def _set_state(generator, state):
    if isinstance(state, tuple):
        stage, n = state
        stage._cursors[id(generator)] = n
    else:
        generator.set_state(state)


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
    # a snapshot taken inside a program's body holds its seed stage
    stage = next((st[0] for _, st in snapshot if isinstance(st, tuple)),
                 None)
    with _StageRunning(stage):
        now = [(g, _state_of(g)) for g, _ in snapshot]
        for g, state in snapshot:
            _set_state(g, state)
        try:
            yield
        finally:
            for g, state in now:
                _set_state(g, state)


def check_model_generator(module, generator, *rates) -> None:
    """Raise when a model part (``module``, a ``torch.nn.Module``) drops in
    training at one of ``rates`` without a generator of its own: a model
    never draws its masks from the global chain, whose state depends on
    whatever else drew from it."""
    if module.training and generator is None and any(r > 0 for r in rates):
        raise ValueError(f"{type(module).__name__}: training at dropout > 0 "
                         f"needs the model's own generator (models do not "
                         f"draw from the global chain)")


def next_seed(generator: torch.Generator | None = None):
    """A fresh 63-bit seed drawn from a CPU ``generator``, or from the
    global chain without one (advances it). Inside a running
    ``SeedStage`` the draw is the stage's (a ``DeviceSeed`` slot once the
    stage is laid out)."""
    generator = default_generator(generator)
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"next_seed: expected a torch.Generator, got "
                        f"{type(generator).__name__}")
    if generator.device.type != "cpu":
        raise ValueError("next_seed: the generator must lie on the CPU (a "
                         "draw from a device generator would wait for the "
                         "device)")
    stage = _running_stage()
    if stage is not None:
        return stage._draw(generator)
    return _draw(generator, 1)[0]


def _draw(generator: torch.Generator, n: int) -> List[int]:
    """``n`` seeds from ``generator`` in order (one batch draw gives what
    ``n`` single draws give)."""
    return torch.empty(n, dtype=torch.int64).random_(
        generator=generator).tolist()


# ------------------------------------------------------------ seed slots

_stages = threading.local()


def _running_stage() -> Optional["SeedStage"]:
    return getattr(_stages, "stage", None)


class _StageRunning:
    """Run a block with ``stage`` running in this thread (nothing when it
    is None): a recompute's replay runs in the autograd engine's thread,
    not in the thread that ran the forward."""

    def __init__(self, stage):
        self.stage = stage

    def __enter__(self):
        self.prev = _running_stage()
        if self.stage is not None:
            _stages.stage = self.stage
        return self.stage

    def __exit__(self, *exc):
        _stages.stage = self.prev
        return False


class SeedStage:
    """The seeds one program draws in a call, as slots of one staged buffer.

    A slot is (generator, n): the n-th draw from that generator in the
    step. The first run of the body (``running()`` before ``layout``) is
    live: each new slot draws its seed from its generator at once and the
    draw returns the int, as an eager step's would. ``layout(buf)`` then
    fixes the slots in a 1-d int64 buffer of ``len(self)`` elements (the
    program's staged copy), and later runs return ``DeviceSeed`` views of
    it. Before each of those calls ``draw(host)`` fills the host side of
    the buffer from the generators, slot by slot in the order the first
    run met them (so each generator's draws stay in order), which leaves
    every generator as the eager step would.

    A run that draws a slot the first run did not (another number or order
    of dropouts) raises: the program's body must draw the same seeds
    every call."""

    def __init__(self):
        self._gens: List[torch.Generator] = []
        self._slots: Dict[Tuple[int, int], int] = {}
        self._order: List[Tuple[int, int]] = []     # slot -> (gen, n)
        self._values: List[int] = []                # the live run's draws
        self._cursors: Dict[int, int] = {}
        self._buf: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return len(self._order)

    @property
    def laid_out(self) -> bool:
        return self._buf is not None

    def cursor(self, generator) -> int:
        return self._cursors.get(id(generator), 0)

    def running(self):
        """Context manager: the body's draws go through this stage (each
        generator's count starts at 0)."""
        self._cursors = {}
        return _StageRunning(self)

    def layout(self, buf: torch.Tensor):
        """Fix the slots in ``buf`` (1-d int64, ``len(self)`` elements)."""
        if buf.dtype != torch.int64 or buf.numel() != len(self):
            raise ValueError(f"SeedStage.layout: want int64 [{len(self)}], "
                             f"got {buf.dtype} {tuple(buf.shape)}")
        self._buf = buf
        self._values = []

    def draw(self, host: np.ndarray):
        """Draw every slot's seed for the next call into ``host`` (the host
        side of the laid-out buffer), generator by generator in order."""
        per: Dict[int, List[int]] = {}
        for gi, n in self._order:
            per[gi] = per.get(gi, 0) + 1
        got = {gi: iter(_draw(self._gens[gi], k)) for gi, k in per.items()}
        for slot, (gi, _) in enumerate(self._order):
            host[slot] = next(got[gi])

    def _draw(self, generator: torch.Generator):
        gi = next((i for i, g in enumerate(self._gens) if g is generator),
                  None)
        if gi is None:
            if self.laid_out:
                raise RuntimeError(self._strange("a generator"))
            gi = len(self._gens)
            self._gens.append(generator)
        n = self._cursors.get(id(generator), 0)
        self._cursors[id(generator)] = n + 1
        slot = self._slots.get((gi, n))
        if slot is None:
            if self.laid_out:
                raise RuntimeError(self._strange("a draw"))
            slot = self._slots[(gi, n)] = len(self._order)
            self._order.append((gi, n))
            self._values.append(_draw(generator, 1)[0])
        if not self.laid_out:
            return self._values[slot]
        return DeviceSeed(self._buf, slot)

    @staticmethod
    def _strange(what):
        return (f"the step drew a seed from {what} its program's first call "
                f"did not: a program's body must draw the same seeds, in "
                f"the same order, at every call")
