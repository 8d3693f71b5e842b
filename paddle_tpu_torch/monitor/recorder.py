"""Flight recorder — bounded ring of recent telemetry for post-mortems (a
copy of ``paddle_tpu/monitor/recorder.py``).

Every record the monitor emits is also pushed here (cheap: deque append with
maxlen). On an uncaught exception escaping ``TrainStep.__call__`` — or on an
explicit ``monitor.dump()`` — the ring, the full metric-registry snapshot,
and the exception are written to one JSON file, so a crashed run leaves
behind the last N events (recompiles, memory gauges, step latencies) that
led up to the failure.
"""
from __future__ import annotations

import json
import os
import time
import traceback
from collections import deque
from typing import Optional

from .sink import SCHEMA_VERSION, _default

__all__ = ["FlightRecorder"]


class FlightRecorder:
    def __init__(self, capacity: int = 256):
        self.capacity = max(int(capacity), 1)
        self._ring = deque(maxlen=self.capacity)
        self.events_seen = 0

    def push(self, record: dict):
        self._ring.append(record)
        self.events_seen += 1

    def events(self):
        return list(self._ring)

    def dump(self, path: str, registry_snapshot: Optional[dict] = None,
             exc: Optional[BaseException] = None,
             fleet: Optional[dict] = None,
             trace: Optional[dict] = None) -> str:
        payload = {
            "v": SCHEMA_VERSION,
            "kind": "flight_dump",
            "dumped_at": time.time(),
            "pid": os.getpid(),
            "events_seen": self.events_seen,
            "events_kept": len(self._ring),
            "events": list(self._ring),
            "metrics": registry_snapshot or {},
        }
        if fleet is not None:
            # rank 0's last aggregated fleet snapshot (monitor/collector.py):
            # the post-mortem shows the whole fleet, not just this rank
            payload["fleet"] = fleet
        if trace is not None:
            # span-tracer context (monitor/trace.py): the stream path and
            # the open/recent trace ids — the dump names the trace to open
            payload["trace"] = trace
        if exc is not None:
            payload["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__))[-8000:],
            }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, default=_default)
        return path
