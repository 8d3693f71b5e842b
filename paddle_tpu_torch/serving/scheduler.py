"""Continuous-batching scheduler state: requests, slots, admission queue.

A copy of ``paddle_tpu/serving/scheduler.py`` (pure host bookkeeping) for
the parts this port's engine uses, the speculative-decoding ledgers
included. Not carried over yet: per-request deadlines and the span-tracer
hooks, which belong to engine features the port does not have yet.

Iteration-level scheduling (Orca, Yu et al., OSDI 2022): scheduling
decisions happen between decode STEPS, not between requests. A request
occupies one slot (one row of the engine's decode batch) from admission to
its stop condition; the moment it stops, the slot returns to the allocator
and the next queued request's prefill folds into it while every other slot
keeps decoding.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import List, Optional

__all__ = ["Request", "SlotAllocator", "AdmissionQueue",
           "TERMINAL_STATUSES"]

# THE terminal-status set: a request in any of these states will never
# change again — no slot, no queued position, no pending work.
TERMINAL_STATUSES = frozenset((
    "done", "failed", "rejected_overload", "rejected_draining",
    "expired", "cancelled"))


class Request:
    """One generation request: prompt in, tokens out, per-request stop.

    Lifecycle: ``queued`` -> ``prefilling`` -> ``running`` (slot assigned,
    first token emitted by the last prefill chunk) -> a terminal status:
    ``done`` (stop condition), ``failed`` (malformed at submit, or
    non-finite logits), ``rejected_overload`` (full admission queue) or
    ``cancelled`` (``engine.cancel``). A malformed request goes straight to
    ``failed`` with ``error`` set — it never reaches a slot, so it cannot
    poison the live batch.
    """

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, request_id=None):
        self.id = request_id if request_id is not None else next(Request._ids)
        self.prompt: List[int] = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = None if eos_token_id is None else int(eos_token_id)
        self.tokens: List[int] = []      # generated tokens (eos inclusive)
        # queued|prefilling|running | TERMINAL_STATUSES
        self.status = "queued"
        self.error: Optional[str] = None
        self.slot: Optional[int] = None
        self.preemptions = 0             # pool-pressure evictions survived
        # speculative decoding: the drafts proposed for and accepted from
        # THIS request over its life (they sum to the engine's counters),
        # and the drafter's per-request scratch, reset by
        # ``Drafter.begin_request`` at every (re-)admission: the token
        # history it derives from restarts with a preemption
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.drafter_state: Optional[dict] = None
        # chunk calls the (final) prefill took: a request whose prompt was
        # served from shared blocks prefills only the uncovered remainder
        self.prefill_chunks = 0
        self.t_submit = time.time()
        # when the request last entered the queue: t_submit at first, reset
        # on a preemption re-queue
        self.t_enqueue = self.t_submit
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None

    @property
    def output_tokens(self) -> List[int]:
        return list(self.tokens)

    @property
    def finished(self) -> bool:
        return self.status in TERMINAL_STATUSES

    def _stop_hit(self) -> bool:
        """Per-request stop: eos emitted, or the token budget spent."""
        if self.tokens and self.eos_token_id is not None \
                and self.tokens[-1] == self.eos_token_id:
            return True
        return len(self.tokens) >= self.max_new_tokens

    def __repr__(self):
        return (f"Request(id={self.id}, status={self.status}, "
                f"prompt={len(self.prompt)}, tokens={len(self.tokens)}"
                + (f", error={self.error!r}" if self.error else "") + ")")


class SlotAllocator:
    """Free-list over the engine's fixed slot (batch-row) indices."""

    def __init__(self, n: int):
        self.n = n
        self._free = list(range(n - 1, -1, -1))   # pop() hands out slot 0 first

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, slot: int):
        assert 0 <= slot < self.n and slot not in self._free
        self._free.append(slot)


class AdmissionQueue:
    """FIFO of validated requests waiting for a free slot.

    ``max_queue`` bounds it: a full queue refuses ``push`` (the engine
    rejects the request at the door with ``status="rejected_overload"``).
    ``push_front`` re-queues a preempted request ahead of the line — it
    already spent compute and FIFO fairness says it goes next; preemption
    re-queues bypass the bound (the request was already admitted once)."""

    def __init__(self, max_queue: Optional[int] = None):
        self._q = deque()
        self.max_queue = None if max_queue is None else int(max_queue)

    @property
    def full(self) -> bool:
        return self.max_queue is not None and len(self._q) >= self.max_queue

    def push(self, req: Request) -> bool:
        if self.full:
            return False
        self._q.append(req)
        return True

    def push_front(self, req: Request):
        self._q.appendleft(req)

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request:
        return self._q[0]

    def remove(self, req: Request) -> bool:
        """Take ``req`` out of the line wherever it sits (cancel of a
        queued request). False when it was not queued."""
        try:
            self._q.remove(req)
            return True
        except ValueError:
            return False

    def __len__(self):
        return len(self._q)

    def __bool__(self):
        return bool(self._q)

    def __iter__(self):
        # snapshot: callers remove() while iterating
        return iter(list(self._q))
