"""Serving guardrails: fault injection seam + dispatch watchdog.

A copy of ``paddle_tpu/serving/guardrails.py`` (host code, no device
work), with the same env names, sites and schedule syntax, so one
``PADDLE_SERVE_FAULT`` / ``PADDLE_ROUTE_FAULT`` string drives either
package. On the card the watchdog's armed window brackets a program's
graph replay and the host read that waits for it (``engine.py``
``_dispatch_guarded``), never the captured body.

The DecodeEngine's failure behavior is a specified contract, not an
accident — and a contract is only real if every path through it is
deterministically exercisable. This file holds the two host-side pieces
that make that possible:

* **`FaultSchedule`** — the ``PADDLE_SERVE_FAULT`` chaos seam, the serving
  mirror of ``PADDLE_CKPT_FAULT`` (distributed/checkpoint.py): a scripted
  schedule of faults fired at exact call counts of the engine's
  interesting sites, so a test (or ``chip_smoke.py``'s
  ``[guard-chaos]``) can drive expiry, cancellation, preemption, hang
  detection and drain through the very same code paths production
  traffic would, with zero randomness.

  Schedule syntax (comma-separated entries)::

      PADDLE_SERVE_FAULT="slow@decode:5:0.2,raise@admit:3,raise@alloc:7"
                          <action>@<site>:<nth>[:<arg>]

  | site         | counts                          | ``raise`` means            |
  |--------------|---------------------------------|----------------------------|
  | decode       | Nth decode executable call      | InjectedFault out of step()|
  | chunk        | Nth chunk/prefill exe call      | InjectedFault out of step()|
  | admit        | Nth paged admission attempt     | that request fails cleanly |
  | alloc        | Nth BlockPager block alloc      | deterministic exhaustion   |
  | verify       | Nth speculative verify dispatch | InjectedFault out of step()|
  | spec_reserve | Nth speculative reservation     | reservation yields nothing |
  | export       | Nth KV-pool block export        | that block is not exported |
  | fetch        | Nth KV-pool block fetch         | fetch misses; plain prefill|
  | adopt        | Nth pool-block table splice     | splice skipped; prefill    |

  ``slow`` sleeps ``<arg>`` seconds (default 0.05) at the site — inside
  the watchdog's armed window for decode/chunk/verify, which is how the
  hang detector is tested without a real wedged runtime. At the ``alloc``
  site an injected ``raise`` does NOT propagate: the pager reports it as
  pool exhaustion (returns no block), because exhaustion is the failure
  its callers actually handle — this is deterministic preemption
  injection. Likewise at ``spec_reserve`` an injected ``raise`` makes the
  reservation come back empty: the engine degrades to a plain one-token
  verify for that step — speculation is an optimization, so its chaos
  failure mode is graceful, never an error. The KV-pool sites follow the
  same rule: an injected ``raise`` at ``export`` skips that block's
  upload, at ``fetch`` reads as a pool miss, and at ``adopt`` abandons
  the splice — all three degrade to plain prefill (the pool is a cache
  tier, so its chaos failure mode is always the cold path). Counts are
  per-schedule (per-engine), 1-based.

* **`DispatchWatchdog`** — a monitor-side thread that detects a decode or
  chunk dispatch exceeding ``PADDLE_SERVE_HANG_S`` (default off — CPU
  steps legitimately take seconds under load). A Python thread cannot
  interrupt a call wedged inside the runtime, so the watchdog's job is to
  make the hang LOUD and attributable while it is still happening: it
  emits a trace-linked WARN naming the executable, escalates the live
  requests' traces past head sampling, and flight-dumps the monitor ring.
  When (if) the dispatch returns, the engine fails loudly
  (``EngineHangError`` after terminalizing every in-flight request)
  instead of decoding onward on a runtime it just caught wedging.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["FaultSchedule", "InjectedFault", "DispatchWatchdog",
           "EngineHangError", "FAULT_SITES", "FAULT_ENV", "HANG_ENV",
           "RouteFaultSchedule", "InjectedRouteFault", "ROUTE_FAULT_ENV",
           "ROUTE_FAULT_SITES"]

FAULT_ENV = "PADDLE_SERVE_FAULT"
HANG_ENV = "PADDLE_SERVE_HANG_S"

FAULT_SITES = ("decode", "chunk", "admit", "alloc", "verify",
               "spec_reserve", "export", "fetch", "adopt")
_ACTIONS = ("raise", "slow")
_DEFAULT_SLOW_S = 0.05

ROUTE_FAULT_ENV = "PADDLE_ROUTE_FAULT"
ROUTE_FAULT_SITES = ("route", "submit", "status")
_ROUTE_ACTIONS = ("drop", "slow", "kill")


class InjectedFault(RuntimeError):
    """A scripted PADDLE_SERVE_FAULT fired. Never raised by real traffic."""


class InjectedRouteFault(OSError):
    """A scripted PADDLE_ROUTE_FAULT ``drop`` fired — the router-side
    stand-in for a connection falling on the floor. Subclasses OSError so
    the default RetryPolicy (retry_on=(OSError,)) retries it exactly like
    a real transport error."""


class EngineHangError(RuntimeError):
    """A decode/chunk dispatch exceeded PADDLE_SERVE_HANG_S. The engine
    terminalized its in-flight requests and refuses to continue on a
    runtime it observed wedging; the WARN + flight dump landed while the
    hang was still in progress."""


class FaultSchedule:
    """Parsed fault schedule + per-site call counters (one per engine).
    ``sleep`` is what a ``slow`` entry calls (``time.sleep``; a test may
    swap in a wait on an event, so that a hang is seen however loaded the
    host is)."""

    def __init__(self, entries: List[Tuple[str, str, int, float]]):
        self.entries = entries
        self._counts: Dict[str, int] = {s: 0 for s in FAULT_SITES}
        self.sleep = time.sleep

    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        entries = []
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            try:
                action, rest = raw.split("@", 1)
                parts = rest.split(":")
                site, nth = parts[0], int(parts[1])
                arg = float(parts[2]) if len(parts) > 2 else _DEFAULT_SLOW_S
            except (ValueError, IndexError):
                raise ValueError(
                    f"{FAULT_ENV} entry {raw!r} is not "
                    f"<action>@<site>:<nth>[:<arg>]") from None
            if action not in _ACTIONS:
                raise ValueError(f"{FAULT_ENV} action {action!r} not in "
                                 f"{_ACTIONS} ({raw!r})")
            if site not in FAULT_SITES:
                raise ValueError(f"{FAULT_ENV} site {site!r} not in "
                                 f"{FAULT_SITES} ({raw!r})")
            if nth < 1:
                raise ValueError(f"{FAULT_ENV} nth must be >= 1 ({raw!r})")
            entries.append((action, site, nth, arg))
        return cls(entries)

    @classmethod
    def from_env(cls) -> Optional["FaultSchedule"]:
        spec = os.environ.get(FAULT_ENV, "")
        return cls.parse(spec) if spec else None

    def fired(self, site: str) -> int:
        """How many times ``site`` has been hit so far."""
        return self._counts[site]

    def fire(self, site: str):
        """Record one occurrence of ``site`` and apply any entry scheduled
        for exactly this count: ``slow`` sleeps in place, ``raise`` raises
        InjectedFault (both can be scheduled at the same count — the sleep
        runs first, so slow+raise models a hang that then errors)."""
        self._counts[site] += 1
        n = self._counts[site]
        boom = None
        for action, s, nth, arg in self.entries:
            if s != site or nth != n:
                continue
            if action == "slow":
                self.sleep(arg)
            else:
                boom = InjectedFault(f"injected {site} fault #{n} "
                                     f"({FAULT_ENV})")
        if boom is not None:
            raise boom

    def __repr__(self):
        return (f"FaultSchedule({', '.join(f'{a}@{s}:{n}' for a, s, n, _ in self.entries)})")


class RouteFaultSchedule:
    """The router's chaos seam — ``PADDLE_ROUTE_FAULT``, mirroring the
    engine's ``PADDLE_SERVE_FAULT`` (same ``<action>@<site>:<nth>[:<arg>]``
    syntax, per-router 1-based counters) with router-shaped sites and
    actions::

        PADDLE_ROUTE_FAULT="drop@submit:2,kill@route:5,slow@status:3:0.2"

    | site   | counts                              |
    |--------|-------------------------------------|
    | route  | Nth placement decision              |
    | submit | Nth submit dispatch to an engine    |
    | status | Nth health/door poll                |

    ``drop`` raises InjectedRouteFault at the site (an OSError, so the
    retry policy backs off and retries — the dropped-connection drill);
    ``slow`` sleeps ``<arg>`` seconds (default 0.05); ``kill`` returns
    ``"kill"`` for the caller to kill the chosen engine — the router
    chaos-kills the target so ejection + requeue-elsewhere run through
    the same code paths a SIGKILL'd process would exercise."""

    def __init__(self, entries: List[Tuple[str, str, int, float]]):
        self.entries = entries
        self._counts: Dict[str, int] = {s: 0 for s in ROUTE_FAULT_SITES}

    @classmethod
    def parse(cls, spec: str) -> "RouteFaultSchedule":
        entries = []
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            try:
                action, rest = raw.split("@", 1)
                parts = rest.split(":")
                site, nth = parts[0], int(parts[1])
                arg = float(parts[2]) if len(parts) > 2 else _DEFAULT_SLOW_S
            except (ValueError, IndexError):
                raise ValueError(
                    f"{ROUTE_FAULT_ENV} entry {raw!r} is not "
                    f"<action>@<site>:<nth>[:<arg>]") from None
            if action not in _ROUTE_ACTIONS:
                raise ValueError(f"{ROUTE_FAULT_ENV} action {action!r} not "
                                 f"in {_ROUTE_ACTIONS} ({raw!r})")
            if site not in ROUTE_FAULT_SITES:
                raise ValueError(f"{ROUTE_FAULT_ENV} site {site!r} not in "
                                 f"{ROUTE_FAULT_SITES} ({raw!r})")
            if nth < 1:
                raise ValueError(f"{ROUTE_FAULT_ENV} nth must be >= 1 "
                                 f"({raw!r})")
            entries.append((action, site, nth, arg))
        return cls(entries)

    @classmethod
    def from_env(cls) -> Optional["RouteFaultSchedule"]:
        spec = os.environ.get(ROUTE_FAULT_ENV, "")
        return cls.parse(spec) if spec else None

    def fired(self, site: str) -> int:
        """How many times ``site`` has been hit so far."""
        return self._counts[site]

    def fire(self, site: str) -> Optional[str]:
        """Record one occurrence of ``site``: ``slow`` sleeps in place,
        ``drop`` raises InjectedRouteFault, ``kill`` returns ``"kill"``
        (slow composes with either — the sleep runs first)."""
        self._counts[site] += 1
        n = self._counts[site]
        verdict = None
        boom = None
        for action, s, nth, arg in self.entries:
            if s != site or nth != n:
                continue
            if action == "slow":
                time.sleep(arg)
            elif action == "drop":
                boom = InjectedRouteFault(
                    f"injected {site} drop #{n} ({ROUTE_FAULT_ENV})")
            else:
                verdict = "kill"
        if boom is not None:
            raise boom
        return verdict

    def __repr__(self):
        return (f"RouteFaultSchedule("
                f"{', '.join(f'{a}@{s}:{n}' for a, s, n, _ in self.entries)})")


class DispatchWatchdog:
    """One monitor thread per engine, armed around each decode/chunk
    dispatch. ``on_hang(info, elapsed_s)`` runs ON THE WATCHDOG THREAD the
    moment the armed window exceeds ``hang_s`` — while the dispatch is
    still stuck — so the WARN and flight dump exist even if the call never
    returns. ``fired`` latches until the engine observes it."""

    def __init__(self, hang_s: float,
                 on_hang: Callable[[dict, float], None]):
        self.hang_s = float(hang_s)
        self._on_hang = on_hang
        self._cond = threading.Condition()
        self._armed: Optional[dict] = None
        self._armed_at: Optional[float] = None
        self._stop = False
        self.fired: Optional[dict] = None      # info of the hang, latched
        self.hangs = 0
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="serve-watchdog")
        self._thread.start()

    def arm(self, **info):
        """Enter an armed window; ``info`` names the dispatch (kind,
        bucket, engine, live trace ids) for the WARN. A latched ``fired``
        from a PREVIOUS window is dropped here — it belonged to a dispatch
        whose failure already propagated (e.g. a hang that then raised),
        and a fresh healthy dispatch must not inherit it."""
        with self._cond:
            self.fired = None
            self._armed = info
            self._armed_at = time.monotonic()
            self._cond.notify()

    def disarm(self):
        with self._cond:
            self._armed = None
            self._armed_at = None

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join(timeout=2.0)

    def _watch(self):
        with self._cond:
            while not self._stop:
                if self._armed is None:
                    self._cond.wait()
                    continue
                info, t0 = self._armed, self._armed_at
                remaining = self.hang_s - (time.monotonic() - t0)
                if remaining > 0:
                    self._cond.wait(remaining)
                    continue
                # deadline passed and the SAME window is still armed: hang
                if self._armed is info:
                    elapsed = time.monotonic() - t0
                    self.fired = dict(info, elapsed_s=elapsed)
                    self.hangs += 1
                    self._armed = None     # one WARN per window
                    self._cond.release()
                    try:
                        self._on_hang(info, elapsed)
                    except Exception:
                        pass               # the watchdog must never crash
                    finally:
                        self._cond.acquire()
