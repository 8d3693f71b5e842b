"""Non-blocking loss/metric readback for the hapi fit loop (counterpart of
``paddle_tpu/hapi/async_metrics.py``).

The training step's loss is a device scalar; CUDA launches are
asynchronous, so the scalar costs nothing until someone calls ``float()``
on it — at which point the host blocks on a device round-trip. The
reference hapi loop (and our eager ``Model.fit``) forces that round-trip
EVERY step just to fill the progress-bar logs, serializing host and
device. The fix is the same
bounded-staleness idea as tf.data metrics or torch_xla's ``xm.add_step_closure``:
hold scalar *handles*, resolve them opportunistically when the device has
already delivered them, and force a sync only every ``max_lag`` steps (and at
epoch end), so the device round-trip happens once per window instead of once
per step.
"""
from __future__ import annotations

from collections import deque
from typing import List, Tuple

import torch

__all__ = ["AsyncScalar", "MetricDrain"]


class AsyncScalar:
    """Handle to a device scalar: blocks only when read.

    On the card the handle queues a non-blocking copy of the scalar into
    pinned host memory on the current stream, behind the work that
    computes it, and records a ``torch.cuda.Event`` after the copy:
    ``is_ready()`` is ``event.query()``, ``float(h)`` waits for the event
    alone (not the whole device). A host value (a CPU tensor, a float) is
    ready at once. The resolved value is cached, so a handle syncs once.
    """

    __slots__ = ("_value", "_event", "_resolved")

    def __init__(self, value):
        self._event = None
        self._resolved = None
        if isinstance(value, torch.Tensor) and value.is_cuda:
            host = torch.empty(value.shape, dtype=value.dtype,
                               pin_memory=True)
            host.copy_(value.detach(), non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            value = host
        self._value = value

    def is_ready(self) -> bool:
        return self._resolved is not None or self._event is None \
            or self._event.query()

    def get(self) -> float:
        if self._resolved is None:
            if self._event is not None:
                self._event.synchronize()
            self._resolved = float(self._value)
            self._value = self._event = None  # drop the host copy
        return self._resolved

    def __float__(self) -> float:
        return self.get()

    def __repr__(self):
        if self._resolved is not None:
            return f"AsyncScalar({self._resolved})"
        return "AsyncScalar(<pending>)"


def _resolve(values):
    return [v.get() if isinstance(v, AsyncScalar) else v for v in values]


class MetricDrain:
    """Bounded-lag scalar drain.

    ``push`` enqueues one step's scalar handles; ``ready()`` returns, in step
    order, every entry that can be emitted *right now*: entries whose device
    values have already landed (free), plus forced resolutions of the oldest
    entries whenever more than ``max_lag`` steps are pending (the staleness
    bound — a callback never observes a step more than ``max_lag`` behind the
    dispatch frontier). ``flush`` resolves everything (epoch end).

    ``forced_syncs`` counts how many entries had to block on the device —
    the observable that the per-step round-trip is actually gone.
    """

    def __init__(self, max_lag: int = 8):
        if max_lag < 1:
            raise ValueError("max_lag must be >= 1")
        self.max_lag = max_lag
        self._pending = deque()  # (step, [AsyncScalar | float, ...])
        self.forced_syncs = 0
        self.free_syncs = 0

    def __len__(self):
        return len(self._pending)

    def push(self, step: int, values) -> None:
        self._pending.append((step, list(values)))

    def _entry_ready(self, values) -> bool:
        return all(v.is_ready() for v in values if isinstance(v, AsyncScalar))

    def ready(self) -> List[Tuple[int, list]]:
        """Pop resolvable entries in order; forces the oldest past the lag
        bound, then keeps popping whatever is already device-complete."""
        out = []
        while self._pending:
            step, values = self._pending[0]
            if len(self._pending) > self.max_lag:
                self.forced_syncs += sum(
                    1 for v in values
                    if isinstance(v, AsyncScalar) and not v.is_ready())
            elif not self._entry_ready(values):
                break
            else:
                self.free_syncs += 1
            self._pending.popleft()
            out.append((step, _resolve(values)))
        return out

    def flush(self) -> List[Tuple[int, list]]:
        """Resolve every pending entry (epoch end / train end)."""
        out = []
        while self._pending:
            step, values = self._pending.popleft()
            self.forced_syncs += sum(
                1 for v in values
                if isinstance(v, AsyncScalar) and not v.is_ready())
            out.append((step, _resolve(values)))
        return out
