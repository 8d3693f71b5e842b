"""Fixed-shape programs: the port's counterpart of the JAX package's AOT
executables and of the serving recompile sentinel ``compile_count``.

A program is a callable ``fn()`` that reads and writes only tensors it was
built with (its static buffers, the model's parameters, the KV pools):
every input that changes from call to call is DATA in those buffers,
filled by ``copy_``, never a Python value or a shape. On the card the
first call runs ``fn`` once on a side stream (that run is the call
itself: its writes are the call's effects), and then captures it into a
``torch.cuda.CUDAGraph``; every later call replays the graph. On the CPU
a program is ``fn`` itself, run eagerly. Both go through one
``ProgramRegistry``, whose ``count`` is the number of programs built, so
the zero-steady-state-recompile gates read the same number on both
devices.

A graph reads its buffers and the model's parameters by address. The
registry keeps the addresses of the parameters it was built against
(``validate``): when one changes (``p.data = ...``, ``model.to(...)``),
every program is dropped and rebuilt at its next call, and counted. An
in-place update (``load_state_dict``, an optimizer step) keeps the
addresses and needs no rebuild.

There is no fallback: on a CUDA device a capture or replay that fails
raises. ``capture = False`` on a registry (a private switch, set before
its first program runs) runs the programs eagerly on the card too, as the
reference the graphs are held to.

With the monitor on, a registry's ``on_built(program, build_s, cost)``
hears of each program's first call: its wall (the eager run and, on the
card, the capture), the FLOPs of its eager run (``monitor.goodput.
FlopCount``, never open inside the capture) and, on the card, the memory
the capture reserved (``program.memory``). The observation wraps the
whole first call: a captured body runs its Python once, at capture, so
nothing inside a body may report.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from .. import monitor as _monitor
from ..monitor import goodput as _goodput
from ..monitor.memory import capture_reading

__all__ = ["ProgramRegistry", "Program", "StagedInputs", "serving_mode",
           "leaf_addresses"]


@contextmanager
def serving_mode(model: torch.nn.Module):
    """Every module of ``model`` in eval mode and autograd off for the
    duration, then each module's OWN training flag restored: serving must
    not flip a training model's mode as a side effect."""
    mods = list(model.modules())
    saved = [m.training for m in mods]
    for m in mods:
        m.training = False
    try:
        with torch.no_grad():
            yield
    finally:
        for m, flag in zip(mods, saved):
            m.training = flag


def leaf_addresses(model: torch.nn.Module) -> Tuple[int, ...]:
    """The storage address of every parameter and buffer of ``model``, in
    module order: what a captured graph reads its weights from."""
    return tuple(t.data_ptr() for t in model.parameters()) \
        + tuple(t.data_ptr() for t in model.buffers())


class StagedInputs:
    """Named int64 inputs of one program: views of ONE flat device buffer,
    filled from one host buffer (pinned on the card) by a single
    non-blocking copy. ``host[name]`` are numpy views to fill, ``dev[name]``
    the device tensors the program reads. Nothing is allocated per call.

    The host buffer is rewritten only after the caller has read the
    previous call's outputs (which waits for the stream), so an upload
    never races the copy before it."""

    def __init__(self, device: torch.device, **shapes):
        sizes = {k: int(np.prod(s, dtype=np.int64)) for k, s in shapes.items()}
        n = sum(sizes.values())
        self._dev = torch.zeros(n, dtype=torch.int64, device=device)
        self._host = self._dev if self._dev.device.type == "cpu" else \
            torch.zeros(n, dtype=torch.int64, pin_memory=True)
        flat = self._host.numpy()
        self.host: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        off = 0
        for name, shape in shapes.items():
            k = sizes[name]
            self.host[name] = flat[off:off + k].reshape(shape)
            self.dev[name] = self._dev[off:off + k].view(shape)
            off += k

    def upload(self):
        if self._host is not self._dev:
            self._dev.copy_(self._host, non_blocking=True)


# one warm-up stream a device for every program: cuBLAS keeps a workspace
# for each stream it has run on until the process ends, so a stream of its
# own a program would hold one more workspace for each program built
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(dev: torch.device) -> "torch.cuda.Stream":
    side = _SIDE_STREAMS.get(dev)
    if side is None:
        side = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return side


class Program:
    """One fixed-shape program of a registry under ``key``; ``state`` is
    whatever its build function returned beside ``fn`` (its static
    buffers). ``memory`` is the allocator's growth across its first call
    on the card when the monitor observed it (else None)."""

    def __init__(self, fn: Callable[[], None], state, registry, key=None):
        self._fn = fn
        self.state = state
        self.key = key
        self.memory = None
        self._reg = registry
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._fresh = True

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self):
        if self._graph is not None:
            self._graph.replay()
            return
        if _monitor._active is not None and self._fresh \
                and self._reg.on_built is not None:
            self._observed_first_call()
            return
        self._fresh = False
        self._run()

    def _observed_first_call(self):
        """The first call with the monitor on: timed, its eager run's
        FLOPs counted and, on the card, the capture's memory measured;
        then ``on_built`` hears of it."""
        self._fresh = False
        dev = self._reg.device
        before = capture_reading(dev)
        t0 = time.perf_counter()
        cost = _goodput.FlopCount()
        self._run(cost)
        build_s = time.perf_counter() - t0
        if before is not None:
            after = capture_reading(dev)
            self.memory = {k: after[k] - before[k] for k in before}
        self._reg.on_built(self, build_s, cost)

    def _run(self, count=None):
        """Run the body: eagerly, or (the first call on the card) the
        warm-up and the capture. ``count`` (a ``FlopCount``) wraps the
        eager run only."""
        reg = self._reg
        count = nullcontext() if count is None else count
        if not reg.capture:
            with count, reg.mode():
                self._fn()
            return
        # the first call on the card: run it on a side stream (the warm-up
        # that lets cuBLAS and the allocator settle outside the capture;
        # its writes are this call's effects), then capture the same work
        # for the calls after it
        dev = reg.device
        cur = torch.cuda.current_stream(dev)
        side = _side_stream(dev)
        side.wait_stream(cur)
        with count, torch.cuda.stream(side), reg.mode():
            self._fn()
        cur.wait_stream(side)
        if reg.pool is None:
            reg.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with reg.mode(), torch.cuda.graph(graph, pool=reg.pool):
            self._fn()
        self._graph = graph


class ProgramRegistry:
    """The programs of one owner (an engine, a model's ``generate()``),
    keyed by (kind, shape, static options); ``count`` programs were built.

    ``mode`` is a context-manager factory every eager run and capture
    enters (``serving_mode`` of the model). Programs share one graph
    memory pool: they run one at a time on one stream, so their
    intermediates may share memory. ``limit`` bounds how many programs are
    kept (the oldest is dropped first). ``on_built`` (None, or a callable
    ``(program, build_s, cost)``) is the owner's monitor hook."""

    def __init__(self, device, mode, limit: Optional[int] = None):
        self.device = torch.device(device)
        self.mode = mode
        self.limit = limit
        self.capture = self.device.type == "cuda"
        self.pool = None
        self.count = 0
        self.on_built = None
        self._programs: Dict[Hashable, Program] = {}
        self._leaves: Optional[Tuple[int, ...]] = None

    def __len__(self) -> int:
        return len(self._programs)

    def validate(self, leaves: Tuple[int, ...]):
        """Drop every program when the parameters' addresses changed since
        the programs were built (``leaf_addresses``)."""
        if leaves != self._leaves:
            self._programs.clear()
            self._leaves = leaves

    def get(self, key: Hashable, build) -> Program:
        """The program under ``key``, built by ``build() -> (fn, state)``
        (and counted) when there is none."""
        prog = self._programs.get(key)
        if prog is None:
            if self.limit is not None and len(self._programs) >= self.limit:
                self._programs.pop(next(iter(self._programs)))
            fn, state = build()
            prog = Program(fn, state, self, key)
            self._programs[key] = prog
            self.count += 1
        return prog
