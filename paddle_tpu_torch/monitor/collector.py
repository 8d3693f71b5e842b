"""Online fleet-telemetry plane: cross-rank metric aggregation.

A copy of ``paddle_tpu/monitor/collector.py`` (host code) over the port's
registry, sink, tracer and goodput ledger and its own
``distributed/launch/master.KVClient``: the blob schema, the key namespace
and the ``run.fleet.jsonl`` records are the JAX package's, so
``tools/fleet_top.py`` and ``tools/fleet_prom.py`` read them unchanged.

The monitor is per-process: every rank writes its own ``run.proc<K>.jsonl``
and the fleet view only exists post-mortem when tools/metrics_summary.py
merges the files. This module is the ONLINE half (ROADMAP "one live dashboard
stream"): each rank runs a lightweight **publisher** thread that periodically
snapshots its registry as a compact delta-encoded blob and publishes it keyed
by rank + incarnation; rank 0 runs the **aggregator**, folding per-rank
snapshots into one fleet stream ``run.fleet.jsonl`` (schema v2: per-metric
``{sum, min, max, per_rank}``) plus the fleet-derived metrics no single rank
can see:

* **straggler detection** — per-rank step-duration skew over the publish
  window (``fleet/step_skew`` gauge; a WARN event names the slow rank when
  skew exceeds ``PADDLE_MONITOR_SKEW_WARN``);
* **liveness** — a rank whose blobs stop arriving goes stale
  (``fleet/ranks_stale`` gauge + flight event) within two publish intervals;
* **divergence tripwires** — a rank whose recompile or skipped-update
  counter advances ALONE is flagged (the all-ranks-vs-one-rank diagnostic
  metrics_summary does offline, moved online);
* **weight-divergence digests** — the health plane's Rademacher projection
  digests (``health/digest_step`` + ``health/digest/p<d>`` gauges, computed
  by TrainStep) are bitwise-equal across ranks holding equal
  weights; the aggregator compares them at a COMMON step (a small per-rank
  history bridges unsynchronized publish windows) and flags the rank whose
  *weights* — not just its counters — forked. Tolerance is
  ``PADDLE_HEALTH_DIGEST_RTOL`` (default 1e-5 relative).

Transport rides the launch KV master (``PADDLE_MONITOR_MASTER``, falling
back to ``PADDLE_CKPT_MASTER`` — both exported by the launch controller)
under the ``/<job>/telemetry/<rank>`` key namespace; a single-process
in-memory transport makes the whole plane testable without a launcher.

Cost contract: the publisher runs on its OWN thread — the only work it adds
anywhere near the training thread is the registry snapshot under the
registry lock, which is bounded by the metric count and measured into the
``fleet/publish_s`` histogram it publishes. The disabled path stays the
monitor's single ``_active is None`` check: nothing here installs hot-path
hooks — the collector consumes ``step_event``'s histograms, it does not
re-instrument.

Incarnation discipline (same token idea as the pod commit): every publisher
start mints ``{gen, start, token}`` where ``gen`` is the elastic restart
counter (``PADDLE_ELASTIC_RESTART``) and ``start`` the publisher birth time.
The aggregator orders incarnations by ``(gen, start)`` — a SIGKILLed rank
that restarts publishes a strictly newer incarnation and cleanly replaces
its old state; a wedged previous incarnation's late blob is rejected.
"""
from __future__ import annotations

import json
import os
import secrets
import threading
import time
import warnings
from typing import Dict, List, Optional

from . import goodput as _goodput_mod
from . import trace as _trace_mod
from .health import DIGEST_PREFIX, DIGEST_STEP_GAUGE
from .registry import Registry
from .sink import JsonlSink

__all__ = ["FLEET_SCHEMA_VERSION", "LocalTransport", "KVTransport",
           "Publisher", "Aggregator", "Collector", "start", "stop",
           "get_active", "fleet_state", "attach_elastic",
           "resolve_fleet_path"]

FLEET_SCHEMA_VERSION = 2

# counters whose single-rank advance is a divergence signature: the same
# input reaching every rank recompiles everywhere (data skew), ONE rank
# recompiling alone is that rank's placement/bucketing bug; a lone
# skipped-update means one rank saw non-finite grads the others did not
TRIPWIRE_COUNTERS = ("train_step/recompiles", "train_step/skipped_updates")

# the step-duration feed (jit/hapi already observe it via step_event)
STEP_HIST = "train_step/dispatch_s"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def resolve_fleet_path(value: Optional[str], sink_path: Optional[str]) -> str:
    """``PADDLE_MONITOR_FLEET`` contract: a truthy flag derives the stream
    path from the monitor sink's UNRESOLVED path (``run.jsonl`` ->
    ``run.fleet.jsonl``); anything else is an explicit path."""
    if value and value.lower() not in ("1", "true", "yes", "on"):
        return value
    base = sink_path or f"monitor_{os.getpid()}.jsonl"
    root, _ = os.path.splitext(base)
    return root + ".fleet.jsonl"


# ---------------------------------------------------------------- transports


class LocalTransport:
    """In-memory blob store: the single-process fallback that makes the
    publish/aggregate protocol testable without a launcher or KV master.

    Two slots per rank: ``delta`` (overwritten every publish) and ``full``
    (overwritten only on full publishes). A delta anchored on full N is
    only visible AFTER full N is (the publisher writes the full slot
    first), so the aggregator can always reconstruct exact state as
    full + latest delta — a missed intermediate blob costs nothing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._blobs: Dict[int, Dict[str, str]] = {}

    def publish(self, rank: int, blob: str, slot: str = "delta") -> bool:
        with self._lock:
            self._blobs.setdefault(int(rank), {})[slot] = blob
        return True

    def fetch_all(self) -> Dict[int, Dict[str, str]]:
        with self._lock:
            return {r: dict(slots) for r, slots in self._blobs.items()}


class KVTransport:
    """Blobs over the launch KV master (launch/master.py KVServer) under
    ``/<job>/telemetry/<rank>`` (delta slot) and ``.../<rank>/full`` —
    the same store the pod commit and the elastic heartbeats already ride.
    All failures are soft: telemetry must degrade, never take the run down
    with it."""

    def __init__(self, endpoint: str, job_id: str = "default"):
        from ..distributed.launch.master import KVClient
        self.endpoint = endpoint
        self._kv = KVClient(endpoint)
        self._prefix = f"/{job_id}/telemetry/"

    def publish(self, rank: int, blob: str, slot: str = "delta") -> bool:
        tail = f"{int(rank)}/full" if slot == "full" else f"{int(rank)}"
        return self._kv.put(f"{self._prefix}{tail}", blob)

    def fetch_all(self) -> Dict[int, Dict[str, str]]:
        out: Dict[int, Dict[str, str]] = {}
        for key, blob in self._kv.get_prefix(self._prefix).items():
            tail = key[len(self._prefix):]
            if tail.isdigit():
                out.setdefault(int(tail), {})["delta"] = blob
            elif tail.endswith("/full") and tail[:-5].isdigit():
                out.setdefault(int(tail[:-5]), {})["full"] = blob
        return out


# ----------------------------------------------------------------- publisher


class Publisher:
    """One rank's side of the plane: periodic delta-encoded registry blobs."""

    # every Nth blob re-sends the FULL snapshot: the transport only keeps a
    # rank's latest blob, so an aggregator that (re)starts mid-run would
    # otherwise never learn about metrics that settled before it joined
    FULL_EVERY = 12

    def __init__(self, registry: Registry, transport, rank: int,
                 interval: float = 5.0, generation: int = 0):
        self.registry = registry
        self.transport = transport
        self.rank = int(rank)
        self.interval = float(interval)
        self.incarnation = {"gen": int(generation), "start": time.time(),
                            "token": secrets.token_hex(4)}
        self.seq = 0
        # delta BASE: the snapshot + seq of the last FULL blob published.
        # Deltas are encoded against it — not against the previous delta —
        # and carry its seq as ``base``, so the aggregator can pair any
        # delta with the full it extends (the full lives in its own
        # transport slot); missed intermediate blobs cost nothing.
        self._base: Optional[dict] = None
        self._base_seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def publish_once(self, full: bool = False) -> bool:
        """Snapshot -> delta -> publish. The snapshot is the only work under
        the registry lock (bounded by metric count); its cost is measured
        into fleet/publish_s so the overhead claim is a gauge, not a hope."""
        # freshen the goodput/idle gauges first: the wire must carry the
        # state as of THIS publish, not as of the last hook event (idle is
        # the one state that grows between events)
        _goodput_mod.refresh_active()
        t0 = time.perf_counter()
        snap = self.registry.snapshot()
        snap_s = time.perf_counter() - t0
        # the histogram write lands in the NEXT snapshot; self-measurement
        # must not dirty the one just taken
        self.registry.histogram("fleet/publish_s").observe(snap_s)
        full = full or self._base is None \
            or (self.seq + 1) % self.FULL_EVERY == 0
        delta = snap if full else Registry.delta(self._base, snap)
        self.seq += 1
        blob = {"v": FLEET_SCHEMA_VERSION, "rank": self.rank,
                "inc": self.incarnation, "seq": self.seq,
                "base": self.seq if full else self._base_seq,
                "ts": time.time(), "full": full,
                "counters": delta.get("counters", {}),
                "gauges": delta.get("gauges", {}),
                "hists": delta.get("histograms", {})}
        tracer = _trace_mod._active
        if tracer is not None:
            # this rank's most recent trace id rides the wire: a straggler
            # WARN on rank 0 can then name BOTH the slow rank and the trace
            # to open on that rank's run.trace.jsonl
            tid = tracer.current_trace_id()
            if tid:
                blob["trace"] = tid
        payload = json.dumps(blob)
        try:
            # full slot FIRST: a visible delta must imply its anchor full
            # is visible too (the aggregator folds full-then-delta)
            ok = (not full
                  or self.transport.publish(self.rank, payload, slot="full"))
            ok = self.transport.publish(self.rank, payload) and ok
        except Exception:
            ok = False
        if ok and full:
            self._base = snap
            self._base_seq = self.seq
        # a failed full keeps the old base: the next blob re-sends the
        # union of both windows' changes (cumulative values make that safe)
        return ok

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"fleet-pub-{self.rank}")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.publish_once()
            except Exception:
                pass  # telemetry never kills the run it observes

    def stop(self, final: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 5.0)
            self._thread = None
        if final:
            try:
                self.publish_once()  # flush the tail window
            except Exception:
                pass


# ---------------------------------------------------------------- aggregator


class _RankState:
    """Aggregator-side merged view of one rank's cumulative metrics."""

    __slots__ = ("inc", "seq", "base_seq", "ts", "rx", "counters", "gauges",
                 "hists", "prev_step", "trace")

    def __init__(self, inc: dict):
        self.inc = inc
        self.seq = 0
        self.base_seq = 0  # seq of the last FULL blob folded (replace point)
        self.trace = None  # the rank's last published span-tracer trace id
        self.ts = 0.0   # publisher's clock at blob creation (display only)
        # AGGREGATOR's clock when a new blob was last accepted: liveness
        # must compare clocks from ONE host — judging the publisher's ts
        # against rank 0's clock would declare an NTP-drifted node
        # permanently stale no matter how fast it publishes
        self.rx = 0.0
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, dict] = {}
        # (count, sum) of STEP_HIST at the previous poll — the window basis
        # for straggler math
        self.prev_step = (0, 0.0)


def _inc_order(inc: dict):
    return (int(inc.get("gen", 0)), float(inc.get("start", 0.0)))


class Aggregator:
    """Rank 0's side: fold per-rank blobs into the fleet stream + derived
    metrics. Runs on its own thread; ``poll_once`` is the deterministic unit
    tests drive directly."""

    def __init__(self, transport, world: int, fleet_path: Optional[str],
                 interval: float = 5.0, stale_after: Optional[float] = None,
                 skew_warn: float = 2.0, registry: Optional[Registry] = None,
                 emit=None, flush_every: int = 1):
        self.transport = transport
        self.world = int(world)
        self.interval = float(interval)
        # the acceptance contract: a killed rank flips ranks_stale within
        # two publish intervals
        self.stale_after = float(stale_after if stale_after is not None
                                 else 2.0 * self.interval)
        self.skew_warn = float(skew_warn)
        self.registry = registry
        self._emit = emit  # monitor event hook (flight ring + proc sink)
        self.sink = JsonlSink(fleet_path, flush_every=flush_every,
                              resolve=False) if fleet_path else None
        self.fleet_path = self.sink.path if self.sink else None
        self._ranks: Dict[int, _RankState] = {}
        self._start = time.time()
        self._warned_stale: set = set()
        self._warned_straggler: set = set()
        self._trip_streak: Dict[str, tuple] = {}
        self.digest_rtol = _env_float("PADDLE_HEALTH_DIGEST_RTOL", 1e-5)
        # per-rank {digest_step: probe vector}, bounded — the alignment
        # buffer for the cross-rank weight-digest comparison
        self._digest_hist: Dict[int, Dict[int, tuple]] = {}
        self._digest_streak = (None, 0)
        self._elastic = None
        self._elastic_mismatch = 0
        self.last_fleet: Optional[dict] = None
        self.rounds = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.sink is not None:
            self.sink.write({"v": FLEET_SCHEMA_VERSION, "kind": "fleet_meta",
                             "ts": self._start, "world": self.world,
                             "publish_s": self.interval,
                             "stale_after_s": self.stale_after,
                             "skew_warn": self.skew_warn,
                             "job": os.environ.get("PADDLE_JOB_ID",
                                                   "default")})
            self.sink.flush()

    # ------------------------------------------------------------- ingestion

    def _ingest(self, rank: int, slots: Dict[str, str]) -> None:
        blobs = []
        for slot in ("full", "delta"):  # fold order: anchor full first
            raw = slots.get(slot) if isinstance(slots, dict) else None
            if not raw:
                continue
            try:
                b = json.loads(raw)
                int(b["seq"])
                # a malformed inc must fail HERE, inside the per-blob
                # guard — not later in max(key=_inc_order), where one
                # poisoned persistent blob would abort every future poll
                if not isinstance(b["inc"], dict):
                    continue
                _inc_order(b["inc"])
            except (ValueError, KeyError, TypeError):
                continue  # torn/foreign blob: ignore
            blobs.append(b)
        if not blobs:
            return
        # the newest incarnation present wins; older slots are leftovers
        inc = max((b["inc"] for b in blobs), key=_inc_order)
        blobs = [b for b in blobs
                 if b["inc"].get("token") == inc.get("token")]
        st = self._ranks.get(rank)
        if st is not None and inc.get("token") != st.inc.get("token"):
            if _inc_order(inc) < _inc_order(st.inc):
                return  # a dead incarnation's late blob must not resurrect it
            if _inc_order(inc) == _inc_order(st.inc) \
                    and max(float(b.get("ts", 0)) for b in blobs) <= st.ts:
                return  # same-order different-token, not newer: stale
            # a NEW incarnation of this rank (restart): the cumulative
            # baseline resets with it
            st = None
        if st is None:
            st = _RankState(inc)
            self._ranks[rank] = st
            self._event("fleet_rank", rank=rank, inc=inc)
        st.inc = inc
        for b in blobs:
            self._fold(st, b)

    def _fold(self, st: _RankState, b: dict) -> None:
        """Apply one blob. Fulls REPLACE the rank's state (they are complete
        snapshots, so a metric dropped by remove_prefix disappears here
        too); deltas update it, but only when their anchor full has been
        folded — the exactness invariant that makes missed intermediate
        blobs free."""
        seq = int(b["seq"])
        if b.get("full"):
            if seq <= st.base_seq:
                return  # this full (or a newer one) is already folded
            st.counters = dict(b.get("counters") or {})
            st.gauges = dict(b.get("gauges") or {})
            st.hists = dict(b.get("hists") or {})
            st.base_seq = seq
        else:
            if seq <= st.seq:
                return  # replay of a blob already folded in
            if int(b.get("base", 0)) > st.base_seq:
                return  # anchor full not visible yet: next poll has it
            st.counters.update(b.get("counters") or {})
            st.gauges.update(b.get("gauges") or {})
            st.hists.update(b.get("hists") or {})
        if seq > st.seq:
            st.seq = seq
            st.ts = float(b.get("ts", time.time()))
            if b.get("trace"):
                st.trace = str(b["trace"])
        st.rx = time.time()

    # ------------------------------------------------------------ aggregation

    def _rank_trace(self, rank) -> Optional[str]:
        st = self._ranks.get(rank)
        return st.trace if st is not None else None

    def _digest_differs(self, a, b) -> bool:
        if len(a) != len(b):
            return True
        return any(abs(x - y) > self.digest_rtol * max(abs(x), abs(y), 1.0)
                   for x, y in zip(a, b))

    def _event(self, kind: str, **fields):
        """WARN/lifecycle events go to BOTH sides of the plane: the fleet
        stream (the live dashboard reads it) and rank 0's own monitor sink +
        flight ring (a crash report keeps the fleet context). A WARN also
        escalates the local span tracer (always-sample-on-WARN): whatever
        rank 0 had in flight when the fleet went bad survives sampling."""
        if kind == "fleet_warn":
            tracer = _trace_mod._active
            if tracer is not None:
                tracer.escalate(reason=str(fields.get("warn", "fleet")))
        if fields.get("trace", "") is None:
            del fields["trace"]  # no known trace: omit, don't write null
        rec = {"v": FLEET_SCHEMA_VERSION, "ts": time.time(), "kind": kind}
        rec.update(fields)
        if self.sink is not None:
            self.sink.write(rec)
        if self._emit is not None:
            try:
                self._emit(kind, **fields)
            except Exception:
                pass

    def _derive(self, now: float) -> dict:
        """The fleet-level metrics no single rank can compute."""
        live: List[int] = []
        stale: List[int] = []
        for r, st in sorted(self._ranks.items()):
            (stale if now - st.rx >= self.stale_after else live).append(r)
        # expected-but-never-heard ranks count stale after the grace window
        # (a rank killed before its first publish must not stay invisible)
        if now - self._start >= self.stale_after:
            for r in range(self.world):
                if r not in self._ranks:
                    stale.append(r)
        stale.sort()

        # straggler: per-rank mean step duration over THIS window
        step_s: Dict[int, float] = {}
        for r in live:
            st = self._ranks[r]
            h = st.hists.get(STEP_HIST)
            if not h:
                continue
            n, s = int(h.get("count", 0)), float(h.get("sum", 0.0))
            pn, ps = st.prev_step
            if n > pn:
                step_s[r] = (s - ps) / (n - pn)
            st.prev_step = (n, s)
        skew, slowest = 1.0, None
        if len(step_s) >= 2:
            fastest = min(step_s.values())
            slowest = max(step_s, key=step_s.get)
            if fastest > 0:
                skew = step_s[slowest] / fastest

        # divergence tripwires on cumulative VALUES, not window deltas:
        # publish windows are not synchronized across ranks, so a fleet-wide
        # startup compile lands in different polls per rank and a delta
        # comparison would cry wolf. A rank strictly AHEAD of every sibling
        # for two consecutive polls has really diverged (one poll of lead is
        # publish lag); the streak resets when the fleet catches up, so an
        # all-ranks advance (data skew) never trips it.
        diverged = []
        for name in TRIPWIRE_COUNTERS:
            vals = {r: float(self._ranks[r].counters.get(name, 0))
                    for r in live}
            leader = None
            if len(vals) > 1:
                top = max(vals.values())
                ahead = [r for r, v in vals.items() if v == top]
                if len(ahead) == 1 and top > min(vals.values()):
                    leader = ahead[0]
            prev_rank, streak = self._trip_streak.get(name, (None, 0))
            streak = streak + 1 if leader is not None \
                and leader == prev_rank else (1 if leader is not None else 0)
            self._trip_streak[name] = (leader, streak)
            if streak == 2:  # warn once on the transition, not every poll
                diverged.append({"counter": name, "rank": leader})

        # weight-divergence digests: record each live rank's latest
        # (digest_step, probe vector) into a small history, then compare all
        # ranks at the newest step EVERY digest-publishing rank has seen —
        # publish windows are unsynchronized, so rank A's freshest digest
        # may label a step rank B published two polls ago. Same two-poll
        # streak discipline as the counter tripwires: one poll of
        # disagreement can be a torn read, two is a forked rank.
        div_rank, div_step = None, None
        for r in live:
            st = self._ranks[r]
            ds = st.gauges.get(DIGEST_STEP_GAUGE)
            if ds is None:
                continue
            vec, i = [], 0
            while True:
                v = st.gauges.get(f"{DIGEST_PREFIX}p{i}")
                if v is None:
                    break
                vec.append(float(v))
                i += 1
            if not vec:
                continue
            hist = self._digest_hist.setdefault(r, {})
            hist[int(ds)] = tuple(vec)
            while len(hist) > 8:
                del hist[min(hist)]
        ranks_d = [r for r in live if self._digest_hist.get(r)]
        if len(ranks_d) >= 2:
            shared = set.intersection(
                *(set(self._digest_hist[r]) for r in ranks_d))
            if shared:
                step = max(shared)
                vecs = {r: self._digest_hist[r][step] for r in ranks_d}
                # reference = the rank the most siblings agree with (ties
                # to the lowest rank — rank 0 anchors checkpoints and this
                # aggregation, so in a 2-rank split it is the trusted side);
                # exactly ONE rank off the reference is the forked-rank
                # signature, several is seed/topology misconfiguration
                agree = {r: sum(not self._digest_differs(vecs[r], vecs[q])
                                for q in ranks_d if q != r) for r in ranks_d}
                ref = min(ranks_d, key=lambda r: (-agree[r], r))
                outliers = [r for r in ranks_d if r != ref
                            and self._digest_differs(vecs[r], vecs[ref])]
                if len(outliers) == 1:
                    div_rank, div_step = outliers[0], step
        prev_rank, streak = self._digest_streak
        streak = streak + 1 if div_rank is not None and div_rank == prev_rank \
            else (1 if div_rank is not None else 0)
        self._digest_streak = (div_rank, streak)
        if streak == 2:
            diverged.append({"counter": DIGEST_STEP_GAUGE, "rank": div_rank,
                             "kind": "weights", "step": div_step})

        derived = {"fleet/ranks": len(self._ranks), "fleet/ranks_live":
                   len(live), "fleet/ranks_stale": len(stale),
                   "fleet/step_skew": skew}
        if slowest is not None:
            derived["fleet/slowest_rank"] = slowest
        derived["fleet/weight_divergence"] = \
            1.0 if div_rank is not None and streak >= 2 else 0.0
        if div_rank is not None and streak >= 2:
            derived["fleet/weight_diverged_rank"] = div_rank

        # pod goodput (monitor/goodput.py accounting plane): a pod moves at
        # its slowest rank's pace, so pod goodput is the MIN over ranks —
        # and the lost fraction is ATTRIBUTED to the named rank (its own
        # goodput/idle_s gauge says how much of the loss is straggler idle)
        gp = {r: float(self._ranks[r].gauges["goodput/fraction"])
              for r in live
              if "goodput/fraction" in self._ranks[r].gauges}
        if gp:
            worst = min(gp, key=gp.get)
            derived["fleet/goodput"] = gp[worst]
            derived["fleet/goodput_min_rank"] = worst
            idle = self._ranks[worst].gauges.get("goodput/idle_s")
            if idle is not None:
                derived["fleet/goodput_min_rank_idle_s"] = float(idle)
        return {"live": live, "stale": stale, "step_s": step_s,
                "skew": skew, "slowest": slowest, "diverged": diverged,
                "derived": derived}

    def _warn_transitions(self, d: dict):
        """WARNs fire on the TRANSITION into a bad state (a breach episode
        is one event, not one per poll) and re-arm on recovery."""
        stale_now = set(d["stale"])
        for r in sorted(stale_now - self._warned_stale):
            self._event("fleet_warn", warn="stale", rank=r,
                        stale_after_s=self.stale_after,
                        trace=self._rank_trace(r),
                        msg=f"rank {r} missed its heartbeat: no telemetry "
                            f"blob for >= {self.stale_after:.1f}s")
        self._warned_stale = stale_now

        if d["skew"] > self.skew_warn and d["slowest"] is not None:
            r = d["slowest"]
            if r not in self._warned_straggler:
                tid = self._rank_trace(r)
                self._event(
                    "fleet_warn", warn="straggler", rank=r,
                    skew=round(d["skew"], 3), trace=tid,
                    step_s={str(k): v for k, v in d["step_s"].items()},
                    msg=f"rank {r} is the fleet straggler: step time "
                        f"{d['step_s'][r] * 1e3:.1f}ms is "
                        f"{d['skew']:.2f}x the fastest rank "
                        f"(threshold {self.skew_warn:.2f}x)"
                        + (f" [trace {tid} on rank {r}]" if tid else ""))
                self._warned_straggler.add(r)
        else:
            self._warned_straggler.clear()

        for div in d["diverged"]:
            if div.get("kind") == "weights":
                r = div["rank"]
                tid = self._rank_trace(r)
                self._event(
                    "fleet_warn", warn="weight_divergence", rank=r,
                    step=div.get("step"), trace=tid,
                    msg=f"rank {r}'s weight digest disagrees with every "
                        f"sibling at step {div.get('step')} — its WEIGHTS "
                        f"(not just its counters) have forked; eject or "
                        f"restore that rank before it poisons a collective"
                        + (f" [trace {tid} on rank {r}]" if tid else ""))
                continue
            self._event("fleet_warn", warn="divergence", rank=div["rank"],
                        counter=div["counter"],
                        trace=self._rank_trace(div["rank"]),
                        msg=f"rank {div['rank']} advanced "
                            f"{div['counter']} ALONE this window — "
                            f"one-rank divergence (placement/bucketing bug "
                            f"on that rank, not fleet-wide data skew)")

    def _check_elastic(self, d: dict):
        """The membership cross-check: ElasticManager's peer view and the
        telemetry liveness view must not silently disagree (a rank the
        elastic layer still trusts but whose telemetry died — or vice
        versa — is exactly the split-brain a restart decision must not be
        made on)."""
        mgr = self._elastic
        if mgr is None:
            return
        try:
            n_peers = len(mgr.peers())
        except Exception:
            return
        d["derived"]["fleet/elastic_peers"] = n_peers
        if n_peers != d["derived"]["fleet/ranks_live"]:
            self._elastic_mismatch += 1
            if self._elastic_mismatch == 2:  # persists past one poll: real
                self._event(
                    "fleet_warn", warn="membership_disagree",
                    elastic_peers=n_peers,
                    telemetry_live=d["derived"]["fleet/ranks_live"],
                    msg=f"elastic membership sees {n_peers} peer(s) but "
                        f"telemetry sees "
                        f"{d['derived']['fleet/ranks_live']} live rank(s)")
        else:
            self._elastic_mismatch = 0

    def poll_once(self, now: Optional[float] = None) -> dict:
        """One aggregation round: fetch -> fold -> derive -> publish."""
        now = time.time() if now is None else now
        try:
            blobs = self.transport.fetch_all()
        except Exception:
            blobs = {}
        for rank, blob in sorted(blobs.items()):
            try:
                self._ingest(rank, blob)
            except Exception:
                pass  # one rank's bad blob drops that rank, not the plane
        d = self._derive(now)
        self._check_elastic(d)
        self._warn_transitions(d)

        metrics = {"counters": {}, "gauges": {}, "histograms": {}}
        for kind, attr in (("counters", "counters"), ("gauges", "gauges"),
                           ("histograms", "hists")):
            names = set()
            for st in self._ranks.values():
                names.update(getattr(st, attr))
            for name in sorted(names):
                per = {r: getattr(st, attr)[name]
                       for r, st in sorted(self._ranks.items())
                       if name in getattr(st, attr)}
                if kind == "histograms":
                    tot = sum(int(h.get("count", 0)) for h in per.values())
                    merged = {
                        "count": tot,
                        "sum": sum(float(h.get("sum", 0.0))
                                   for h in per.values()),
                        "min": min((float(h.get("min", 0.0))
                                    for h in per.values()
                                    if h.get("count")), default=0.0),
                        "max": max((float(h.get("max", 0.0))
                                    for h in per.values()), default=0.0),
                    }
                    merged["avg"] = merged["sum"] / tot if tot else 0.0
                    for q in ("p50", "p95", "p99"):
                        merged[q] = max((float(h.get(q, 0.0))
                                         for h in per.values()), default=0.0)
                    merged["per_rank"] = {str(r): h for r, h in per.items()}
                    metrics[kind][name] = merged
                else:
                    vals = list(per.values())
                    metrics[kind][name] = {
                        "sum": sum(vals), "min": min(vals), "max": max(vals),
                        "per_rank": {str(r): v for r, v in per.items()}}

        rec = {"v": FLEET_SCHEMA_VERSION, "kind": "fleet", "ts": now,
               "round": self.rounds, "ranks": sorted(self._ranks),
               "live": d["live"], "stale": d["stale"],
               "derived": {k: (round(v, 6) if isinstance(v, float) else v)
                           for k, v in d["derived"].items()},
               "step_s": {str(r): round(v, 6)
                          for r, v in d["step_s"].items()},
               "metrics": metrics}
        self.rounds += 1
        self.last_fleet = rec
        if self.sink is not None:
            self.sink.write(rec)
            self.sink.flush()
        if self.registry is not None:
            for name, v in d["derived"].items():
                self.registry.gauge(name).set(v)
        return rec

    # -------------------------------------------------------------- lifecycle

    def attach_elastic(self, manager):
        """Any object with ``peers()`` (a list of the live members) takes
        part in the membership cross-check. The port has no
        ``ElasticManager`` of its own yet (ROADMAP Queue 1, item 10's
        rest), so nothing in the port calls this today."""
        self._elastic = manager

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-agg")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.poll_once()
            except Exception:
                pass

    def stop(self, final: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 5.0)
            self._thread = None
        if final:
            try:
                self.poll_once()
            except Exception:
                pass
        if self.sink is not None:
            self.sink.close()


# ----------------------------------------------------------------- collector


class Collector:
    """One rank's whole plane membership: a publisher always, the
    aggregator + fleet sink on rank 0 only."""

    def __init__(self, registry: Registry, transport=None,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 interval: Optional[float] = None,
                 fleet_path: Optional[str] = None,
                 stale_after: Optional[float] = None,
                 skew_warn: Optional[float] = None,
                 generation: Optional[int] = None, emit=None):
        env = os.environ
        self.rank = int(env.get("PADDLE_TRAINER_ID", "0") or 0) \
            if rank is None else int(rank)
        self.world = int(env.get("PADDLE_TRAINERS_NUM", "1") or 1) \
            if world is None else int(world)
        self.interval = _env_float("PADDLE_MONITOR_PUBLISH_S", 5.0) \
            if interval is None else float(interval)
        if generation is None:
            try:
                generation = int(env.get("PADDLE_ELASTIC_RESTART", "0") or 0)
            except ValueError:
                generation = 0
        if transport is None:
            endpoint = env.get("PADDLE_MONITOR_MASTER") \
                or env.get("PADDLE_CKPT_MASTER")
            if endpoint and self.world > 1:
                transport = KVTransport(endpoint,
                                        env.get("PADDLE_JOB_ID", "default"))
            else:
                transport = LocalTransport()
        self.transport = transport
        self.publisher = Publisher(registry, transport, self.rank,
                                   interval=self.interval,
                                   generation=generation)
        self.aggregator: Optional[Aggregator] = None
        if self.rank == 0:
            if stale_after is None:
                v = env.get("PADDLE_MONITOR_STALE_S")
                stale_after = float(v) if v else None
            if skew_warn is None:
                skew_warn = _env_float("PADDLE_MONITOR_SKEW_WARN", 2.0)
            self.aggregator = Aggregator(
                transport, self.world, fleet_path, interval=self.interval,
                stale_after=stale_after, skew_warn=skew_warn,
                registry=registry, emit=emit)

    @property
    def fleet_path(self) -> Optional[str]:
        return self.aggregator.fleet_path if self.aggregator else None

    def start(self):
        self.publisher.start()
        if self.aggregator is not None:
            self.aggregator.start()
        return self

    def stop(self):
        self.publisher.stop(final=True)
        if self.aggregator is not None:
            self.aggregator.stop(final=True)

    def fleet_state(self) -> Optional[dict]:
        if self.aggregator is None or self.aggregator.last_fleet is None:
            return None
        return self.aggregator.last_fleet


# ------------------------------------------------------------- module plane

_active: Optional[Collector] = None
_lock = threading.Lock()
_pending_elastic = None


def start(registry: Optional[Registry] = None, **kw) -> Optional[Collector]:
    """Start the fleet plane over ``registry`` (default: the enabled
    monitor's). Returns None — with a warning — when there is nothing to
    attach to; telemetry is never a reason a run fails."""
    global _active
    with _lock:
        if _active is not None:
            _active.stop()
            _active = None
        if registry is None:
            from . import get as _mon_get
            mon = _mon_get()
            if mon is None:
                warnings.warn("monitor.collector.start(): the monitor is not "
                              "enabled; call monitor.enable() first",
                              RuntimeWarning)
                return None
            registry = mon.registry
            kw.setdefault("emit", mon.emit)
        try:
            col = Collector(registry, **kw)
        except Exception as e:
            warnings.warn(f"fleet collector failed to start "
                          f"({type(e).__name__}: {e}); continuing without "
                          f"online aggregation", RuntimeWarning)
            return None
        if _pending_elastic is not None and col.aggregator is not None:
            col.aggregator.attach_elastic(_pending_elastic)
        _active = col.start()
        return col


def stop():
    global _active
    with _lock:
        if _active is not None:
            _active.stop()
            _active = None


def get_active() -> Optional[Collector]:
    return _active


def fleet_state() -> Optional[dict]:
    """Rank 0's latest aggregated fleet record (None elsewhere / inactive)."""
    col = _active
    return col.fleet_state() if col is not None else None


def attach_elastic(manager):
    """Wire an elastic membership manager (any object with ``peers()``)
    into the aggregator's membership cross-check. Safe to call before
    start() (the next start picks it up) and on ranks without an
    aggregator (no-op). The port has no ``ElasticManager`` yet (ROADMAP
    Queue 1, item 10's rest): the JAX package's is the one this was built
    for."""
    global _pending_elastic
    _pending_elastic = manager
    col = _active
    if col is not None and col.aggregator is not None:
        col.aggregator.attach_elastic(manager)
