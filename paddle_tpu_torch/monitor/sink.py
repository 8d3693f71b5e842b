"""Buffered JSONL event sink for paddle_tpu_torch.monitor (a copy of
``paddle_tpu/monitor/sink.py``: the same schema version and file naming).

One JSON object per line, schema-versioned (every record carries ``"v"``).
Writes are buffered and flushed in batches so the steady-state cost of an
event on the training thread is a dict build + list append; the file write
happens every ``flush_every`` records, on explicit flush(), and at close.

Distributed: each process writes its OWN file. Under the launcher env
contract (PADDLE_TRAINERS_NUM > 1) the path gains a ``.procN`` suffix keyed
by PADDLE_TRAINER_ID, so a multi-host run produces one JSONL per process and
tools/metrics_summary.py can aggregate them without write contention.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

SCHEMA_VERSION = 1

__all__ = ["SCHEMA_VERSION", "JsonlSink", "resolve_sink_path"]


def resolve_sink_path(path: str) -> str:
    """Key the sink file by process index in multi-process runs.

    Uses the launcher's env contract (PADDLE_TRAINERS_NUM /
    PADDLE_TRAINER_ID) so resolving a path never initialises a device.
    """
    try:
        world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    except ValueError:
        world = 1
    if world <= 1:
        return path
    rank = os.environ.get("PADDLE_TRAINER_ID", "0")
    root, ext = os.path.splitext(path)
    return f"{root}.proc{rank}{ext or '.jsonl'}"


def _default(o):
    # a 0-d torch.Tensor or a numpy scalar becomes its number; dtypes and
    # anything exotic degrade to repr, never raise — telemetry must not be
    # able to crash the run it is observing
    try:
        import numpy as np
        if isinstance(o, np.generic):
            return o.item()
        import torch
        if isinstance(o, torch.Tensor) and o.dim() == 0:
            return o.item()
    except Exception:
        pass
    return repr(o)


class JsonlSink:
    """Append-only buffered JSONL writer (thread-safe)."""

    def __init__(self, path: str, flush_every: int = 64,
                 resolve: bool = True):
        # resolve=False: single-writer streams that are already rank-scoped
        # (the collector's rank-0 fleet stream) must not grow a .procN suffix
        self.path = resolve_sink_path(path) if resolve else path
        self.flush_every = max(int(flush_every), 1)
        self._lock = threading.Lock()
        self._buf = []
        self._closed = False
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        # truncate: one sink instance owns one run's file
        with open(self.path, "w"):
            pass
        self.records_written = 0

    def write(self, record: dict):
        try:
            line = json.dumps(record, default=_default)
        except Exception:
            return  # never let telemetry serialization kill the run
        with self._lock:
            if self._closed:
                return
            self._buf.append(line)
            if len(self._buf) >= self.flush_every:
                self._flush_locked()

    def _flush_locked(self):
        if not self._buf:
            return
        chunk = "\n".join(self._buf) + "\n"
        self._buf.clear()
        try:
            with open(self.path, "a") as f:
                f.write(chunk)
            self.records_written += chunk.count("\n")
        except OSError:
            pass

    def flush(self):
        with self._lock:
            self._flush_locked()

    def close(self):
        with self._lock:
            self._flush_locked()
            self._closed = True
