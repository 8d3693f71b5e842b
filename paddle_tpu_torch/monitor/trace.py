"""Span tracer — request- and step-scoped causal telemetry (a copy of
``paddle_tpu/monitor/trace.py``: the same record schema, sampling and
escalation, so ``tools/trace_view.py`` reads the port's files).

The monitor's registry answers "what are the aggregates doing"; this
module answers the question it cannot: *which request or step was slow, and
which phase ate the time*. It is a Dapper-style tracer scaled down to one
process: a **trace** is one causal unit (a serving request from ``submit()``
to finish, one training step), a **span** is one phase of it (queue wait, a
chunked-prefill iteration, the step's dispatch), and spans carry parent links
plus point **events** (a COW copy batch, a preemption, a recompile) so a
TTFT or step-time outlier decomposes exactly.

Clocks: spans are timed on ``time.perf_counter()`` (monotonic — a phase
duration can never go negative on an NTP step) and exported against a
wall-clock anchor taken once at tracer start, so trace records line up with
the monitor's ``ts`` fields.

Sampling is head-based: the keep/drop decision is made when the trace
STARTS (``PADDLE_TRACE_SAMPLE``, a probability in [0, 1], default 1.0 —
a deterministic credit accumulator, not a PRNG, so a 0.1 sample really
keeps every 10th trace). Unsampled traces still buffer their spans in
memory (bounded) so a WARN fired mid-trace can **escalate** them to
sampled — the trace you need post-mortem is by construction the one the
sampler would have dropped.

Sink: schema-v1 ``run.trace.jsonl`` through the same buffered
:class:`~paddle_tpu_torch.monitor.sink.JsonlSink` (per-process ``.procN``
suffix under the launcher env contract). A bounded in-memory ring of
finished spans feeds flight dumps (the JAX package's profiler also
exports it as a Chrome trace; the port has no profiler export yet).

Cost contract: every integration point guards on ONE module-global
``trace._active is None`` check (the ``monitor._active`` pattern); with the
tracer enabled, an unsampled trace costs object construction and list
appends only — no serialization, no I/O.
"""
from __future__ import annotations

import atexit
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

from .sink import JsonlSink

__all__ = ["TRACE_SCHEMA_VERSION", "Span", "Tracer", "enable", "disable",
           "enabled", "get", "current_trace_id", "escalate"]

TRACE_SCHEMA_VERSION = 1

# THE hot-path flag: integration points read this one module global and do
# nothing when it is None.
_active: Optional["Tracer"] = None

_lock = threading.Lock()


class Span:
    """One phase of a trace. ``end()`` seals it into the owning trace's
    buffer; ``event()`` attaches a point annotation (bounded — a runaway
    event stream degrades to a drop counter, never unbounded memory)."""

    MAX_EVENTS = 256

    __slots__ = ("trace", "span_id", "parent_id", "name", "kind", "t0",
                 "t1", "attrs", "events", "events_dropped")

    def __init__(self, trace: "_Trace", span_id: int, parent_id, name: str,
                 kind: str, t0: float, attrs: dict):
        self.trace = trace
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.t0 = t0
        self.t1 = None
        self.attrs = attrs
        self.events = []
        self.events_dropped = 0

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def event(self, name: str, t: Optional[float] = None, **fields):
        if len(self.events) >= self.MAX_EVENTS:
            self.events_dropped += 1
            return
        ev = {"name": name, "t": time.perf_counter() if t is None else t}
        if fields:
            ev.update(fields)
        self.events.append(ev)

    def end(self, t1: Optional[float] = None):
        if self.t1 is not None:
            return  # idempotent: a double end keeps the first boundary
        self.t1 = time.perf_counter() if t1 is None else t1
        self.trace._seal(self)

    @property
    def dur_s(self) -> float:
        return (self.t1 if self.t1 is not None
                else time.perf_counter()) - self.t0


class _Trace:
    """One causal unit: a root span plus its children, buffered until
    ``end()`` decides (sampling) whether the spans reach the sink."""

    MAX_SPANS = 512

    __slots__ = ("tracer", "trace_id", "name", "kind", "sampled",
                 "escalated", "root", "_sealed", "_dropped", "_next_span",
                 "_ended")

    def __init__(self, tracer: "Tracer", trace_id: str, name: str,
                 kind: str, sampled: bool, t0: float, attrs: dict):
        self.tracer = tracer
        self.trace_id = trace_id
        self.name = name
        self.kind = kind
        self.sampled = sampled
        self.escalated = None
        self._sealed = []          # finished spans, root excluded until end
        self._dropped = 0
        self._next_span = itertools.count(1)
        self._ended = False
        self.root = Span(self, 0, None, name, kind, t0, attrs)

    # -------------------------------------------------------------- building

    def span(self, name: str, kind: str = "phase", parent: Optional[Span]
             = None, t0: Optional[float] = None, **attrs) -> Span:
        """Open a child span (default parent: the root)."""
        return Span(self, next(self._next_span),
                    (parent or self.root).span_id, name, kind,
                    time.perf_counter() if t0 is None else t0, attrs)

    def record(self, name: str, t0: float, t1: float, kind: str = "phase",
               parent: Optional[Span] = None, **attrs) -> Span:
        """A completed span in one call (both boundaries already known)."""
        sp = self.span(name, kind=kind, parent=parent, t0=t0, **attrs)
        sp.end(t1)
        return sp

    def event(self, name: str, **fields):
        """Point annotation on the ROOT span."""
        self.root.event(name, **fields)

    def _seal(self, span: Span):
        if span.span_id == 0:
            return  # the root exports via end(), not the child buffer
        if len(self._sealed) >= self.MAX_SPANS:
            self._dropped += 1
            return
        self._sealed.append(span)

    # ------------------------------------------------------------- lifecycle

    def escalate(self, reason: str = "warn"):
        """Force-sample this trace (always-sample-on-WARN): the spans are
        already buffered, so escalation any time before ``end()`` loses
        nothing."""
        if not self.sampled:
            self.sampled = True
            self.tracer._escalated += 1
            # per-reason tally: a dump then says WHICH tripwire class
            # (health_nan, straggler, deadline...) is forcing sampling
            rs = self.tracer._escalate_reasons
            rs[reason] = rs.get(reason, 0) + 1
        if self.escalated is None:
            self.escalated = reason

    def end(self, t1: Optional[float] = None, **attrs):
        if self._ended:
            return
        self._ended = True
        if attrs:
            self.root.attrs.update(attrs)
        self.root.end(t1)  # seals the root last — it sorts first on export
        self.tracer._finish_trace(self)


class Tracer:
    """One enabled tracing session (sink + ring + sampling state)."""

    def __init__(self, path: Optional[str] = None, *,
                 sample: Optional[float] = None, ring: int = 1024,
                 flush_every: int = 32):
        if sample is None:
            try:
                sample = float(os.environ.get("PADDLE_TRACE_SAMPLE", "")
                               or 1.0)
            except ValueError:
                sample = 1.0
        self.sample = min(max(float(sample), 0.0), 1.0)
        self.sink = JsonlSink(path, flush_every) if path else None
        self.path = self.sink.path if self.sink else None
        # finished spans of SAMPLED traces, monotonic times kept — flight
        # dumps read this
        self.ring = deque(maxlen=max(int(ring), 1))
        self._wall0 = time.time()
        self._mono0 = time.perf_counter()
        self._ids = itertools.count(1)
        self._slock = threading.Lock()
        # head-sampling credit: starts at 1.0 so the FIRST trace is always
        # kept (a short run with sample=0.1 still yields one trace);
        # sample=0.0 means "escalations only" and keeps nothing up front
        self._credit = 1.0 if self.sample > 0 else 0.0
        self._open: dict = {}          # id(trace) -> trace
        self._tls = threading.local()  # per-thread current-trace stack
        self._floating = deque(maxlen=64)
        self._last_trace_id: Optional[str] = None
        self.traces_started = 0
        self.traces_sampled = 0
        self.spans_written = 0
        self._escalated = 0
        self._escalate_reasons: Dict[str, int] = {}
        self._via_monitor = False
        if self.sink is not None:
            self.sink.write({"v": TRACE_SCHEMA_VERSION, "kind": "trace_meta",
                             "ts": self._wall0, "pid": os.getpid(),
                             "proc": int(os.environ.get("PADDLE_TRAINER_ID",
                                                        "0") or 0),
                             "sample": self.sample})

    # --------------------------------------------------------------- clocks

    def wall(self, mono: float) -> float:
        return self._wall0 + (mono - self._mono0)

    # --------------------------------------------------------------- traces

    def start_trace(self, name: str, kind: str = "trace",
                    current: bool = True, **attrs) -> _Trace:
        """Open a trace. ``current=True`` pushes it on this thread's
        current-trace stack (step traces; WARN tagging reads the top);
        serving request traces pass False — many are open at once and none
        is "the" current one. Pending floating spans (loader waits recorded
        before any trace existed) are adopted as children of the new root.
        """
        with self._slock:
            self._credit += self.sample
            sampled = self._credit >= 1.0
            if sampled:
                self._credit -= 1.0
            n = next(self._ids)
        tid = f"{os.getpid():x}-{n:x}"
        tr = _Trace(self, tid, name, kind, sampled, time.perf_counter(),
                    attrs)
        with self._slock:
            # the open-trace map is read by OTHER threads (escalate from
            # the aggregator's WARN path, snapshot_info from dump) — every
            # access goes through the lock
            self._open[id(tr)] = tr
        self._last_trace_id = tid
        self.traces_started += 1
        if current:
            stack = getattr(self._tls, "stack", None)
            if stack is None:
                stack = self._tls.stack = []
            stack.append(tr)
        if self._floating:
            # adopt only the floats addressed to this trace KIND: loader/
            # ckpt spans are step-trace context — a serving request trace
            # starting in between must not steal them
            with self._slock:
                keep, mine = deque(maxlen=self._floating.maxlen), []
                for entry in self._floating:
                    (mine if entry[0] == kind else keep).append(entry)
                self._floating = keep
            for _, name_f, t0, t1, a in mine:
                tr.record(name_f, t0, t1, **a)
        return tr

    def _finish_trace(self, tr: _Trace):
        with self._slock:
            self._open.pop(id(tr), None)
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] is tr:
            stack.pop()
        if not tr.sampled:
            return
        self.traces_sampled += 1
        spans = [tr.root] + tr._sealed
        # children sealed before an escalation/late root-end keep insertion
        # order; export sorts by start so waterfalls render stably
        spans.sort(key=lambda s: (s.t0, s.span_id))
        for sp in spans:
            rec = {"v": TRACE_SCHEMA_VERSION, "kind": "span",
                   "trace": tr.trace_id, "span": sp.span_id,
                   "parent": sp.parent_id, "name": sp.name,
                   "span_kind": sp.kind, "ts": self.wall(sp.t0),
                   "dur_s": round((sp.t1 if sp.t1 is not None else sp.t0)
                                  - sp.t0, 9)}
            if sp.attrs:
                rec["attrs"] = sp.attrs
            if sp.events:
                rec["events"] = [
                    dict(e, t=self.wall(e["t"])) for e in sp.events]
            if sp.events_dropped:
                rec["events_dropped"] = sp.events_dropped
            self.ring.append({**rec, "_t0": sp.t0,
                              "_t1": sp.t1 if sp.t1 is not None else sp.t0})
            if self.sink is not None:
                self.sink.write(rec)
                self.spans_written += 1
        summary = {"v": TRACE_SCHEMA_VERSION, "kind": "trace",
                   "trace": tr.trace_id, "name": tr.name,
                   "trace_kind": tr.kind, "ts": self.wall(tr.root.t0),
                   "dur_s": round(tr.root.dur_s, 9),
                   "spans": len(spans)}
        if tr.escalated:
            summary["escalated"] = tr.escalated
        if tr._dropped:
            summary["spans_dropped"] = tr._dropped
        if tr.root.attrs:
            summary["attrs"] = tr.root.attrs
        if self.sink is not None:
            self.sink.write(summary)

    # ------------------------------------------------------------- floating

    def floating(self, name: str, t0: float, t1: float,
                 adopt_kind: str = "step", **attrs):
        """A completed span observed OUTSIDE any trace (the DeviceLoader's
        wait/fetch/H2D run before the step trace opens; a checkpoint save
        lands between steps). Buffered (bounded, cross-thread) and adopted
        as children of the next trace of ``adopt_kind`` to start — the
        step waterfall then shows the feed work that preceded the
        dispatch, and an unrelated request trace starting in between
        cannot steal it."""
        self._floating.append((adopt_kind, name, float(t0), float(t1),
                               attrs))

    # ------------------------------------------------------------ WARN hooks

    def current_trace_id(self) -> Optional[str]:
        """This thread's open trace id (top of stack), else the most
        recently started trace anywhere — what a WARN record embeds."""
        stack = getattr(self._tls, "stack", None)
        if stack:
            return stack[-1].trace_id
        return self._last_trace_id

    def escalate(self, trace: Optional[_Trace] = None,
                 reason: str = "warn"):
        """Force-sample ``trace`` — or, with None, EVERY open trace (a
        fleet WARN arriving on the aggregator thread cannot know which of
        the live traces is implicated; keeping all of them is bounded by
        the open-trace count and loses nothing)."""
        if trace is not None:
            trace.escalate(reason)
            return
        with self._slock:
            targets = list(self._open.values())
        for tr in targets:
            tr.escalate(reason)

    # ------------------------------------------------------------- plumbing

    def snapshot_info(self) -> dict:
        """Flight-dump payload: where the trace stream lives and which
        traces were recently active (the crash report names the trace to
        open, not just the metrics at death)."""
        recent = []
        seen = set()
        for rec in reversed(self.ring):
            t = rec.get("trace")
            if t and t not in seen:
                seen.add(t)
                recent.append(t)
            if len(recent) >= 8:
                break
        with self._slock:
            open_ids = [tr.trace_id for tr in self._open.values()]
        return {"path": self.path, "current": self.current_trace_id(),
                "open": open_ids,
                "recent": recent, "sample": self.sample,
                "started": self.traces_started,
                "sampled": self.traces_sampled,
                "escalated": self._escalated,
                "escalated_reasons": dict(self._escalate_reasons)}

    def flush(self):
        if self.sink is not None:
            self.sink.flush()

    def close(self):
        # traces still open at close (e.g. requests in flight) are ended so
        # their spans are not silently lost
        with self._slock:
            still_open = list(self._open.values())
        for tr in still_open:
            try:
                tr.end(status="tracer_closed")
            except Exception:
                pass
        if self.sink is not None:
            self.sink.close()


# ------------------------------------------------------------------ module API


def enable(path: Optional[str] = None, *, sample: Optional[float] = None,
           ring: int = 1024, flush_every: int = 32) -> Tracer:
    """Turn the tracer on. ``path`` is the trace JSONL file (None: in-memory
    ring only); multi-process runs write ``path.procN`` per the sink
    contract. ``sample``: head-sampling probability (default: env
    ``PADDLE_TRACE_SAMPLE``, else 1.0). Idempotent-safe."""
    global _active
    with _lock:
        if _active is not None:
            _teardown_locked()
        _active = Tracer(path, sample=sample, ring=ring,
                         flush_every=flush_every)
    return _active


def _teardown_locked():
    global _active
    tr, _active = _active, None
    if tr is not None:
        tr.close()


def disable():
    with _lock:
        _teardown_locked()


def enabled() -> bool:
    return _active is not None


def get() -> Optional[Tracer]:
    return _active


def current_trace_id() -> Optional[str]:
    tr = _active
    return tr.current_trace_id() if tr is not None else None


def escalate(reason: str = "warn"):
    """Module-level always-sample-on-WARN hook (no-op when disabled)."""
    tr = _active
    if tr is not None:
        tr.escalate(reason=reason)


@atexit.register
def _atexit_close():
    # the sink buffers writes; a process that exits without disable() must
    # not lose its tail spans (open traces are ended + flushed by close)
    tr = _active
    if tr is not None:
        try:
            tr.close()
        except Exception:
            pass
