"""Metric primitives + registry for paddle_tpu_torch.monitor (a copy of
``paddle_tpu/monitor/registry.py``: the same names, buckets and snapshot
shape, so the shared ``tools/`` read either package's records).

Reference analog: the reference framework's statistics/benchmark layer
(python/paddle/profiler/utils.py benchmark, fluid monitor counters); shape
borrowed from the Prometheus client model (Counter/Gauge/Histogram) because
that is what production telemetry pipelines ingest.

Thread-safety: a loader thread and the training thread may both touch
these, so every mutation takes the registry lock. The lock is only ever
contended while the monitor is ENABLED — disabled hot paths never reach here
(they guard on ``monitor._active is None``).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]

# decade buckets in seconds: dispatch latencies live in 1e-5..1e0, compile
# times in 1e-1..1e2 — one fixed scale covers both without configuration
_DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "_n", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._n = 0
        self._lock = lock

    def inc(self, n: int = 1):
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def snapshot(self):
        return self._n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._v = 0.0
        self._lock = lock

    def set(self, v: float):
        with self._lock:
            self._v = float(v)

    def add(self, v: float):
        with self._lock:
            self._v += float(v)

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self):
        return self._v


class Histogram:
    """Fixed-bucket distribution (count/sum/min/max + cumulative buckets).

    Buckets are upper bounds in the observed unit (seconds for latencies);
    an implicit +inf bucket catches the tail. `quantile(q)` interpolates the
    bucket boundaries — coarse, but stable and allocation-free on observe.
    """

    __slots__ = ("name", "buckets", "_counts", "_n", "_sum", "_min", "_max",
                 "_lock")

    def __init__(self, name: str, lock: threading.Lock,
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = lock

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self._n += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def avg(self) -> float:
        return self._sum / self._n if self._n else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-boundary estimate of the q-quantile (0 < q <= 1)."""
        if not self._n:
            return 0.0
        target = q * self._n
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target:
                if i < len(self.buckets):
                    return self.buckets[i]
                return self._max
        return self._max

    def snapshot(self) -> dict:
        return {"count": self._n, "sum": self._sum, "avg": self.avg,
                "min": self._min if self._n else 0.0,
                "max": self._max if self._n else 0.0,
                "p50": self.quantile(0.5), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class Registry:
    """Name -> primitive store. Creation is idempotent; asking for an
    existing name with a different type raises (silent shadowing would
    corrupt the exported snapshot)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, self._lock, *args)
                self._metrics[name] = m
            elif type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._get_or_create(name, Histogram,
                                *((buckets,) if buckets else ()))
        if buckets is not None and h.buckets != tuple(sorted(buckets)):
            # same no-silent-shadowing rule as a type mismatch: observations
            # landing in someone else's bucket scale corrupt quantile()
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h.buckets}, not {tuple(sorted(buckets))}")
        return h

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} —
        JSON-ready, stable key order."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.snapshot()
            else:
                out["histograms"][name] = m.snapshot()
        return out

    @staticmethod
    def delta(prev: Optional[dict], cur: dict) -> dict:
        """Changed-metrics view of ``cur`` vs a previous ``snapshot()``.

        Values stay CUMULATIVE (the fleet collector's loss-tolerant wire
        format: a missed blob costs nothing because the next one carries
        absolute values again); only UNCHANGED keys are dropped. Histograms
        compare on observation count — a summary whose count moved is
        re-sent whole. ``prev=None`` returns ``cur`` unchanged (the full
        first publish of an incarnation)."""
        if prev is None:
            return cur
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for kind in ("counters", "gauges"):
            pk = prev.get(kind) or {}
            for name, v in (cur.get(kind) or {}).items():
                if pk.get(name) != v:
                    out[kind][name] = v
        ph = prev.get("histograms") or {}
        for name, h in (cur.get("histograms") or {}).items():
            if (ph.get(name) or {}).get("count") != h.get("count"):
                out["histograms"][name] = h
        return out

    def remove_prefix(self, prefix: str):
        """Unregister every metric whose name starts with ``prefix`` — for
        metrics scoped to an object that no longer exists (e.g. per-bucket
        executable gauges after the executables are dropped), where a stale
        value would misattribute live state."""
        with self._lock:
            for name in [n for n in self._metrics if n.startswith(prefix)]:
                del self._metrics[name]

    def reset(self):
        with self._lock:
            self._metrics.clear()
