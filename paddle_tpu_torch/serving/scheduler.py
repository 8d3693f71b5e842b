"""Continuous-batching scheduler state: requests, slots, admission queue.

A copy of ``paddle_tpu/serving/scheduler.py`` (pure host bookkeeping; the
port keeps its own so that it never imports ``paddle_tpu``): deadlines,
the speculative-decoding ledgers and the span-tracer state included.

Iteration-level scheduling (Orca, Yu et al., OSDI 2022): scheduling
decisions happen between decode STEPS, not between requests. A request
occupies one slot (one row of the engine's preallocated KV-cache batch
axis) from admission to its stop condition; the moment it stops, the slot
returns to the allocator and the next queued request's prefill folds into
it while every other slot keeps decoding. The device side lives in
engine.py.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import List, Optional

__all__ = ["Request", "SlotAllocator", "AdmissionQueue",
           "TERMINAL_STATUSES"]

# THE terminal-status set: a request in any of these states will never
# change again — no slot, no queued position, no pending work. One copy,
# shared by ``Request.finished``, the engine's step()/run() returns, and
# tools/metrics_summary.py accounting. (The latent poller-spin bug this
# replaces: ``finished`` counted only done/failed, so a poller waiting on
# a rejected_overload request spun forever.)
TERMINAL_STATUSES = frozenset((
    "done", "failed", "rejected_overload", "rejected_draining",
    "expired", "cancelled"))


class Request:
    """One generation request: prompt in, tokens out, per-request stop.

    Lifecycle: ``queued`` -> ``prefilling`` -> ``running`` (slot assigned,
    first token emitted by the prefill) -> a terminal status. Terminal
    (``TERMINAL_STATUSES``): ``done`` (stop condition), ``failed``
    (malformed at submit, or the engine failed under it), ``rejected_
    overload`` (full admission queue), ``rejected_draining`` (engine
    draining), ``expired`` (deadline passed), ``cancelled``
    (``engine.cancel``). A malformed request (empty prompt, prompt that
    cannot fit the engine's ``max_len``) goes straight to ``failed`` with
    ``error`` set — it never reaches a slot, so it cannot poison the live
    batch.

    Deadlines (both optional, both wall-clock seconds from ``t_submit``,
    enforced at the engine's step boundaries — a request is never killed
    mid-executable-call): ``ttft_deadline_s`` bounds the time to FIRST
    token and stops applying the moment one is out; ``deadline_s`` bounds
    the whole request and applies from submit to stop. When both are set,
    whichever is violated first expires the request.
    """

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, request_id=None,
                 ttft_deadline_s: Optional[float] = None,
                 deadline_s: Optional[float] = None):
        self.id = request_id if request_id is not None else next(Request._ids)
        self.prompt: List[int] = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = None if eos_token_id is None else int(eos_token_id)
        self.ttft_deadline_s = None if ttft_deadline_s is None \
            else float(ttft_deadline_s)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        for name, d in (("ttft_deadline_s", self.ttft_deadline_s),
                        ("deadline_s", self.deadline_s)):
            if d is not None and (d < 0 or d != d):
                raise ValueError(f"{name} must be >= 0, got {d}")
        self.tokens: List[int] = []      # generated tokens (eos inclusive)
        # queued|prefilling|running | TERMINAL_STATUSES
        self.status = "queued"
        self.error: Optional[str] = None
        self.slot: Optional[int] = None
        self.preemptions = 0             # pool-pressure evictions survived
        # speculative-decoding bookkeeping (engine + spec.py): cumulative
        # drafted/accepted token counts for THIS request, and the drafter's
        # per-request scratch (reset by Drafter.begin_request on every
        # (re-)admission — the token history it derives from resets too)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.drafter_state: Optional[dict] = None
        # chunk-executable calls the (final) prefill took: the counted
        # signal the prefix-cache gate reads — a request whose prompt was
        # served from parked blocks prefills only the uncovered remainder
        self.prefill_chunks = 0
        self.t_submit = time.time()
        # when the request last entered the queue: t_submit at first, reset
        # on a preemption re-queue — serve/queue_wait_s measures from HERE,
        # so a preempted request's second wait doesn't absorb its first run
        self.t_enqueue = self.t_submit
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        # span-tracer state (monitor/trace.py): the request's trace and its
        # currently open phase span; None when tracing is off
        self._trace = None
        self._phase = None

    def _trace_phase(self, name: Optional[str], t0: Optional[float] = None,
                     **attrs):
        """Close the open phase span and open ``name`` at the SAME instant
        — the gap-free chain invariant every engine transition relies on
        (TTFT must equal the sum of its pre-first-token phases, so a phase
        may never end before the next begins). ``name=None`` just closes.
        Returns the new span (None when untraced/closing). Set attrs on
        the CLOSING span via ``self._phase.set(...)`` before calling."""
        if self._trace is None:
            return None
        if t0 is None:
            t0 = time.perf_counter()
        if self._phase is not None:
            self._phase.end(t0)
        self._phase = self._trace.span(name, t0=t0, **attrs) \
            if name is not None else None
        return self._phase

    @property
    def output_tokens(self) -> List[int]:
        return list(self.tokens)

    @property
    def finished(self) -> bool:
        return self.status in TERMINAL_STATUSES

    def deadline_exceeded(self, now: float) -> Optional[str]:
        """Which deadline (if any) ``now`` violates: "ttft" while no first
        token is out, "total" for the whole-request bound. None = alive."""
        if self.deadline_s is not None \
                and now - self.t_submit > self.deadline_s:
            return "total"
        if self.ttft_deadline_s is not None and self.t_first_token is None \
                and now - self.t_submit > self.ttft_deadline_s:
            return "ttft"
        return None

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
    rejects the request at the door with ``status="rejected_overload"``)
    so saturation is visible instead of silently growing host memory.
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
        """Take ``req`` out of the line wherever it sits (cancel / expiry
        of a queued request). False when it was not queued — the caller
        races admission, and losing that race just means the request gets
        handled on the slotted path instead."""
        try:
            self._q.remove(req)
            return True
        except ValueError:
            return False

    def drain_all(self) -> List[Request]:
        """Empty the queue, returning the requests in FIFO order (the
        engine terminalizes them on drain)."""
        out = list(self._q)
        self._q.clear()
        return out

    def __len__(self):
        return len(self._q)

    def __bool__(self):
        return bool(self._q)

    def __iter__(self):
        # snapshot: sweeps remove() while iterating
        return iter(list(self._q))
