"""Fleet front door: fault-tolerant request router over engine replicas.

A copy of ``paddle_tpu/serving/router.py`` (stdlib host code): placement,
retry, ejection, requeue and rolling restart over the port's engines,
in-process (``LocalEngineClient``) or over HTTP (``HTTPEngineClient`` to a
``DoorServer``). It reports to the port's monitor and tracer.

One DecodeEngine serves one process; millions of users need N replicas
behind a door that survives any one of them dying. This router is that
door — stdlib-only host code (placement is DATA: no engine executable is
minted, touched, or re-shaped by anything here) with failure as a
specified contract:

* **Discovery** — replicas register TTL'd blobs on a directory
  (serving/endpoint.py: in-memory for in-process fleets, the launch KV
  master under ``/{job}/serve/{engine}`` across processes). The router
  judges freshness against its OWN receive clock per blob ``seq`` (a
  stalled heartbeat goes stale even if the store keeps answering) and
  orders incarnations by ``(gen, start)`` — a restarted engine's new
  registration supersedes; a dead incarnation's late blob is rejected
  (the fleet collector's semantics).

* **Placement** — cache-aware first: a prompt whose first-block digest
  matches a key the engine's door advertises lands THERE (its prefix
  blocks are parked in that engine's LRU — vLLM-lineage cache-aware
  routing, PAPERS.md), least-loaded spill otherwise, and a fleet with
  every door draining/stale rejects (explicit backpressure, not a hang).
  ``policy="round_robin"`` is the control arm the affinity gate measures
  against.

* **Failure contract** — every dispatch runs under a `utils/retry.py`
  RetryPolicy (exponential backoff + jitter, injectable sleep so tests
  assert the exact delay sequence). An engine that fails transport
  ``eject_after`` consecutive times — or whose heartbeat goes stale while
  it holds live tickets — is EJECTED: removed from placement until a
  strictly newer incarnation re-registers. Its tickets requeue elsewhere
  with the SAME request id; the engine-side id dedup (engine.submit)
  makes the requeue idempotent, so one request can never produce two
  token streams. MegaScale doctrine: detection / ejection / rollover as
  a tested contract, not a hope.

* **Rolling restart** — ``rolling_restart()`` cordons one engine at a
  time, chains its ``begin_drain``/drain wait, optionally restarts it and
  waits for the NEWER incarnation before moving on — a fleet upgrade
  never drops a request: drain-flushed tickets requeue to the live
  remainder, and capacity loss is bounded at one replica.

* **Chaos** — ``PADDLE_ROUTE_FAULT`` (serving/guardrails.py) scripts
  drop/slow/kill at exact route/submit/status counts, so ejection,
  requeue and backoff run deterministically under test.
"""
from __future__ import annotations

import itertools
import json
import secrets
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Set, Tuple

from .. import monitor as _monitor
from ..monitor import trace as _trace
from ..utils.retry import RetryPolicy
from .guardrails import InjectedRouteFault, RouteFaultSchedule
from .pager import prefix_digest
from .scheduler import TERMINAL_STATUSES

__all__ = ["Router", "RouteTicket", "LocalEngineClient", "HTTPEngineClient",
           "EngineDown", "NoEngineAvailable"]


class EngineDown(OSError):
    """Transport-level loss of an engine (dead local client, chaos kill,
    refused connection). OSError so the retry policy treats it exactly
    like a real network failure."""


class NoEngineAvailable(RuntimeError):
    """Every known door is draining, stale, ejected or absent. NOT an
    OSError: retrying placement against an empty fleet is noise — the
    caller gets an immediate ``rejected`` ticket instead."""


class LocalEngineClient:
    """In-process engine handle (tests, ``chip_smoke.py``'s
    ``[fleet-router]``). ``kill()`` is the chaos stand-in for SIGKILL: every later call raises
    EngineDown, and the harness stops stepping the engine — the router
    must then prove ejection + requeue-elsewhere, exactly as it would
    across processes."""

    def __init__(self, engine):
        self.engine = engine
        self.dead = False
        self._requests: Dict[str, object] = {}

    def _check(self):
        if self.dead:
            raise EngineDown("engine is dead (chaos kill)")

    @staticmethod
    def _view(req, since: Optional[int] = None) -> dict:
        out = {"id": str(req.id), "status": req.status, "error": req.error}
        tokens = [int(t) for t in req.tokens]
        if since is None:
            out["tokens"] = tokens
        else:
            # incremental form (endpoint.DoorServer._req_view contract):
            # only tokens past the clamped cursor ship
            eff = min(max(0, int(since)), len(tokens))
            out["tokens"] = tokens[eff:]
            out["since"] = eff
            out["n_tokens"] = len(tokens)
        return out

    def submit(self, prompt, max_new_tokens: int, eos_token_id,
               request_id: str) -> dict:
        self._check()
        req = self.engine.submit(prompt, max_new_tokens=max_new_tokens,
                                 eos_token_id=eos_token_id,
                                 request_id=request_id)
        self._requests[str(req.id)] = req
        return self._view(req)

    def status(self, request_id: str,
               since: Optional[int] = None) -> Optional[dict]:
        self._check()
        req = self._requests.get(str(request_id))
        return None if req is None else self._view(req, since=since)

    def door(self) -> dict:
        self._check()
        return self.engine.door_state()

    def begin_drain(self, grace_s: Optional[float] = None):
        self._check()
        self.engine.begin_drain(grace_s)

    def kill(self):
        self.dead = True


class HTTPEngineClient:
    """Cross-process engine handle over an endpoint.DoorServer address.
    urllib errors ARE OSErrors, so transport failure feeds the retry /
    ejection machinery with no translation. A 404 from /status means the
    engine does not know the id (it restarted) — that is ``None``, a
    resubmit signal, not a transport failure."""

    def __init__(self, addr: str, timeout: float = 2.0):
        self._base = f"http://{addr}"
        self._timeout = float(timeout)
        self.dead = False

    def _check(self):
        if self.dead:
            raise EngineDown("client killed (router-side)")

    def _call(self, path: str, payload: Optional[dict] = None) -> dict:
        self._check()
        if payload is None:
            req = urllib.request.Request(f"{self._base}{path}")
        else:
            req = urllib.request.Request(
                f"{self._base}{path}", data=json.dumps(payload).encode(),
                method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self._timeout) as r:
            return json.loads(r.read().decode())

    def submit(self, prompt, max_new_tokens: int, eos_token_id,
               request_id: str) -> dict:
        return self._call("/submit", {
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "eos_token_id": eos_token_id, "request_id": request_id})

    def status(self, request_id: str,
               since: Optional[int] = None) -> Optional[dict]:
        path = "/status?id=" + urllib.parse.quote(str(request_id))
        if since is not None:
            path += f"&since={int(since)}"
        try:
            return self._call(path)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def door(self) -> dict:
        return self._call("/door").get("door") or {}

    def begin_drain(self, grace_s: Optional[float] = None):
        self._call("/drain", {"grace_s": grace_s})

    def kill(self):
        self.dead = True


_ROUTER_TERMINAL = frozenset(TERMINAL_STATUSES) | {"rejected"}


class RouteTicket:
    """One request's life through the router: which engine holds it, how
    many dispatch attempts/requeues it took, and its last-seen engine
    status. ``finished`` covers the engine terminal statuses plus the
    router's own ``rejected`` (no engine would take it)."""

    __slots__ = ("id", "prompt", "max_new_tokens", "eos_token_id", "engine",
                 "status", "error", "tokens", "attempts", "requeues",
                 "t_submit", "t_done", "_trace", "_avoid", "_requeue_why",
                 "_q_deadline")

    def __init__(self, request_id: str, prompt, max_new_tokens: int,
                 eos_token_id):
        self.id = request_id
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.engine: Optional[str] = None
        self.status = "routing"
        self.error: Optional[str] = None
        self.tokens: list = []
        self.attempts = 0
        self.requeues = 0
        self.t_submit = time.time()
        self.t_done: Optional[float] = None
        self._trace = None
        self._avoid: Set[str] = set()
        self._requeue_why: Optional[str] = None
        self._q_deadline: Optional[float] = None

    @property
    def finished(self) -> bool:
        return self.status in _ROUTER_TERMINAL

    def __repr__(self):
        return (f"RouteTicket({self.id!r}, engine={self.engine!r}, "
                f"status={self.status!r}, tokens={len(self.tokens)}, "
                f"requeues={self.requeues})")


class Router:
    """The fleet front door. See the module docstring for the contract;
    parameters pin its knobs:

    * ``retry`` — the RetryPolicy wrapping every dispatch (default 3
      attempts, 50ms base, OSError-retried). Pass one with an injected
      ``sleep`` to assert backoff timing in tests.
    * ``policy`` — ``"affinity"`` (cache-aware, default) or
      ``"round_robin"`` (the control arm).
    * ``stale_after`` — seconds without heartbeat progress before a door
      is unplaceable (default 2.5x the blob's advertised ttl_s).
    * ``eject_after`` — consecutive transport failures before an engine
      is declared dead (two, by default: one dropped packet retries,
      a pattern ejects — this is the anti-flap margin the requeue-storm
      WARN in tools/metrics_summary.py patrols from the other side).
    * ``requeue_limit`` — how many times one ticket may move before the
      router gives up and fails it (a poisoned request must not orbit
      the fleet forever).
    * ``max_queue`` — bounded router-side admission queue. When every
      LIVE door is at capacity (overload bounces / all avoided) the
      request parks here instead of rejecting; ``poll()`` re-dispatches
      queued tickets as capacity frees. 0 (default) keeps the legacy
      immediate-reject behavior; queue overflow still rejects, and a
      genuinely empty/stale fleet rejects immediately (waiting cannot
      help a fleet that is gone).
    * ``queue_deadline_s`` — per-ticket budget in the router queue; a
      ticket still unplaced past it terminalizes as ``expired``, the
      same status an engine-side deadline produces.
    """

    def __init__(self, directory, retry: Optional[RetryPolicy] = None,
                 policy: str = "affinity",
                 stale_after: Optional[float] = None, eject_after: int = 2,
                 requeue_limit: int = 3, clock=time.time,
                 fault_schedule: Optional[RouteFaultSchedule] = None,
                 name: str = "router", max_queue: int = 0,
                 queue_deadline_s: Optional[float] = 5.0):
        if policy not in ("affinity", "round_robin"):
            raise ValueError(f"policy must be affinity|round_robin, "
                             f"got {policy!r}")
        self._dir = directory
        self._retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=1.0,
            retry_on=(OSError,))
        self.policy = policy
        self.stale_after = stale_after
        self.eject_after = int(eject_after)
        self.requeue_limit = int(requeue_limit)
        self.max_queue = int(max_queue)
        self.queue_deadline_s = queue_deadline_s
        self._queue: List[str] = []
        self._clock = clock
        self._faults = fault_schedule if fault_schedule is not None \
            else RouteFaultSchedule.from_env()
        self.name = name
        self._clients: Dict[str, object] = {}
        self._seen: Dict[str, dict] = {}
        self._ejected: Dict[str, Tuple[int, float]] = {}
        self._cordoned: Set[str] = set()
        self._fail_counts: Dict[str, int] = {}
        self._tickets: Dict[str, RouteTicket] = {}
        self._rr = 0
        # auto-minted ids carry a per-instance salt: two routers fronting
        # the same fleet (or one restarted) must never collide — the
        # engine-side dedup window would hand one router the OTHER's
        # completed request instead of generating
        self._mint = itertools.count(1)
        self._mint_salt = secrets.token_hex(3)
        self.counters = {"routed": 0, "affinity_hits": 0, "spills": 0,
                         "requeues": 0, "ejections": 0, "rejected": 0,
                         "queued": 0, "queue_expired": 0}

    # ------------------------------------------------------------ discovery

    def attach(self, name: str, client):
        """Register the transport handle for an engine name (local fleets
        attach LocalEngineClients; HTTP handles self-construct from the
        ``addr`` their registration advertises)."""
        self._clients[str(name)] = client

    def _drop_client(self, name: str, blob: dict):
        """On incarnation supersession: an HTTP client points at the DEAD
        process's door, so drop it — ``_client_for`` rebuilds from the new
        blob's addr. A locally attached client (no addr in the blob) is
        the caller's to manage: the restart hook attaches the replacement,
        possibly before the new registration is even observed, and the
        router must not throw that attachment away."""
        if blob.get("addr"):
            self._clients.pop(name, None)

    def _client_for(self, name: str, blob: dict):
        client = self._clients.get(name)
        if client is not None:
            return client
        addr = blob.get("addr")
        if addr:
            client = HTTPEngineClient(addr)
            self._clients[name] = client
        return client

    def refresh(self) -> Dict[str, dict]:
        """Fold the directory into the router's view: per-engine
        ``{key, token, seq, rx, blob}`` where ``rx`` is OUR clock at the
        last seq change — the only staleness clock that needs no
        cross-host agreement. Incarnation ordering gates every update."""
        now = self._clock()
        blobs = self._dir.list()
        for name, blob in blobs.items():
            inc = blob.get("inc") or {}
            try:
                key = (int(inc.get("gen", 0) or 0),
                       float(inc.get("start", 0.0) or 0.0))
            except (TypeError, ValueError):
                continue
            token = inc.get("token")
            seq = blob.get("seq")
            ej = self._ejected.get(name)
            if ej is not None and key > ej:
                # a strictly newer incarnation redeems the name: the dead
                # process is gone, this is its replacement
                del self._ejected[name]
                self._fail_counts.pop(name, None)
                self._drop_client(name, blob)
                self._seen.pop(name, None)
            cur = self._seen.get(name)
            if cur is not None:
                if key < cur["key"]:
                    continue       # a dead incarnation's late blob
                if key == cur["key"] and token != cur["token"]:
                    continue       # same order, different mint: not ours
                if key > cur["key"]:
                    self._fail_counts.pop(name, None)
                    self._drop_client(name, blob)
                    cur = None     # superseded: restart as a fresh record
            if cur is None:
                self._seen[name] = {"key": key, "token": token, "seq": seq,
                                    "rx": now, "blob": blob}
            else:
                if seq != cur["seq"]:
                    cur["seq"], cur["rx"] = seq, now
                cur["blob"] = blob
        for name in list(self._seen):
            if name not in blobs:
                del self._seen[name]       # explicit deregister: clean exit
        return self._seen

    def _fresh(self, rec: dict) -> bool:
        ttl = float(rec["blob"].get("ttl_s") or 3.0)
        bound = self.stale_after if self.stale_after is not None \
            else 2.5 * ttl
        return (self._clock() - rec["rx"]) <= bound

    # ------------------------------------------------------------ placement

    def _candidates(self, ticket: RouteTicket):
        out = []
        for name, rec in self._seen.items():
            if name in self._cordoned or name in self._ejected \
                    or name in ticket._avoid:
                continue
            if not self._fresh(rec):
                continue
            door = rec["blob"].get("door") or {}
            if door.get("state") != "accepting":
                continue
            client = self._client_for(name, rec["blob"])
            if client is None or getattr(client, "dead", False):
                continue
            out.append((name, client, door))
        return out

    def _place(self, ticket: RouteTicket):
        """Pick (engine, client, affinity_hit) for one dispatch attempt:
        prefix-key affinity -> least-loaded spill -> NoEngineAvailable.
        Load is queued + active (advertised), free slots break ties."""
        self.refresh()
        cands = self._candidates(ticket)
        if not cands:
            raise NoEngineAvailable(
                "no accepting engine (fleet empty, draining, stale or "
                "ejected)")
        if self.policy == "round_robin":
            cands.sort(key=lambda c: c[0])
            name, client, _ = cands[self._rr % len(cands)]
            self._rr += 1
            return name, client, False
        aff = []
        for name, client, door in cands:
            bs = int(door.get("block_size") or 0)
            keys = door.get("prefix_keys") or []
            if bs > 0 and keys and len(ticket.prompt) >= bs \
                    and prefix_digest(ticket.prompt[:bs]) in keys:
                aff.append((name, client, door))
        pool = aff if aff else cands

        def load(c):
            door = c[2]
            # warm-pool tiebreak: among equally loaded doors, prefer the
            # one whose cross-process pool tier has already served hits —
            # its host cache is warm, so a spilled prompt still has a
            # chance of adopting blocks instead of cold-prefilling
            return (int(door.get("queue_depth", 0))
                    + int(door.get("active", 0)),
                    -int(door.get("free_slots", 0)),
                    -int(door.get("pool_hits") or 0), c[0])

        name, client, _ = min(pool, key=load)
        return name, client, bool(aff)

    # ------------------------------------------------------------- dispatch

    def route(self, prompt, max_new_tokens: int = 32, eos_token_id=None,
              request_id=None) -> RouteTicket:
        """Admit one request to the fleet. Returns a ticket immediately —
        submitted somewhere on success, ``rejected`` when no door would
        take it, ``failed`` when transport lost every retry. A duplicate
        ``request_id`` returns the existing ticket (router-level
        idempotency, mirroring the engine's)."""
        if request_id is not None and str(request_id) in self._tickets:
            return self._tickets[str(request_id)]
        tid = str(request_id) if request_id is not None \
            else f"{self.name}-{self._mint_salt}-{next(self._mint)}"
        ticket = RouteTicket(tid, prompt, max_new_tokens, eos_token_id)
        self._tickets[tid] = ticket
        trc = _trace._active
        if trc is not None:
            ticket._trace = trc.start_trace(
                "route", kind="request", current=False, request=tid,
                prompt=len(ticket.prompt), router=self.name)
        self.counters["routed"] += 1
        self._dispatch(ticket)
        return ticket

    def _dispatch(self, ticket: RouteTicket):
        try:
            self._retry(self._dispatch_once, ticket)
        except NoEngineAvailable as e:
            if self._try_queue(ticket):
                return
            ticket.status, ticket.error = "rejected", str(e)
            self.counters["rejected"] += 1
            mon = _monitor._active
            if mon is not None:
                mon.route_reject(str(e))
            self._finish_ticket(ticket)
        except Exception as e:
            if isinstance(e, EngineDown) and ticket._requeue_why in (
                    "overload_bounce", "drain_bounce") \
                    and self._try_queue(ticket):
                return             # saturation, not sickness: wait it out
            ticket.status = "failed"
            ticket.error = f"dispatch failed after retries: {e}"
            self._finish_ticket(ticket)

    # ------------------------------------------------------ admission queue

    def _has_live_doors(self) -> bool:
        """A fresh, non-ejected, accepting door exists SOMEWHERE — the
        distinction between capacity exhaustion (queueing can help: a
        slot frees, a bounce clears) and a fleet that is gone (queueing
        is a hang with extra steps)."""
        for name, rec in self._seen.items():
            if name in self._ejected or not self._fresh(rec):
                continue
            if (rec["blob"].get("door") or {}).get("state") == "accepting":
                return True
        return False

    def _try_queue(self, ticket: RouteTicket) -> bool:
        """Park an unplaceable ticket in the bounded router queue.
        Returns False — caller proceeds to reject/fail — when queueing is
        off, the fleet is gone, or the queue is full (overflow rejects:
        the bound IS the backpressure)."""
        if self.max_queue <= 0 or not self._has_live_doors():
            return False
        requeue = ticket.status == "queued_router"
        if not requeue and len(self._queue) >= self.max_queue:
            return False
        if not requeue:
            ticket._q_deadline = (
                self._clock() + self.queue_deadline_s
                if self.queue_deadline_s is not None else None)
            self.counters["queued"] += 1
            mon = _monitor._active
            if mon is not None:
                mon.route_queued(len(self._queue) + 1)
        ticket.status = "queued_router"
        ticket.engine = None
        ticket.error = None
        ticket._avoid = set()      # fresh episode once capacity frees
        self._queue.append(ticket.id)
        return True

    def _service_queue(self):
        """Re-dispatch router-queued tickets in FIFO order: expired ones
        terminalize, the rest try placement again (and re-park, keeping
        their original deadline, if the fleet is still saturated)."""
        if not self._queue:
            return
        waiting, self._queue = self._queue, []
        for tid in waiting:
            ticket = self._tickets.get(tid)
            if ticket is None or ticket.finished:
                continue
            if ticket._q_deadline is not None \
                    and self._clock() > ticket._q_deadline:
                ticket.status = "expired"
                ticket.error = (f"router queue deadline "
                                f"({self.queue_deadline_s}s) exceeded")
                self.counters["queue_expired"] += 1
                self._finish_ticket(ticket)
                continue
            self._dispatch(ticket)

    def _dispatch_once(self, ticket: RouteTicket):
        ticket.attempts += 1
        name, client, affinity = self._place(ticket)
        if self._faults is not None and self._faults.fire("route") == "kill":
            self._chaos_kill(name)
            raise EngineDown(f"chaos kill of {name} at route site")
        try:
            if self._faults is not None \
                    and self._faults.fire("submit") == "kill":
                self._chaos_kill(name)
            out = client.submit(ticket.prompt, ticket.max_new_tokens,
                                ticket.eos_token_id, ticket.id)
        except OSError as e:
            if not isinstance(e, InjectedRouteFault):
                # an injected drop models a lost packet, not a sick
                # engine: it must exercise backoff WITHOUT feeding the
                # ejection tally (that distinction is the requeue-storm
                # signature metrics_summary WARNs on)
                self._note_failure(name, f"submit: {e}")
                ticket._avoid.add(name)
                ticket._requeue_why = ticket._requeue_why or "engine_down"
            raise
        self._fail_counts.pop(name, None)
        status = out.get("status")
        if status in ("rejected_draining", "rejected_overload"):
            # door bounce: not a failure of the ENGINE, but this ticket
            # must go elsewhere — retryable so the policy backs off and
            # the next attempt places on another door
            ticket._avoid.add(name)
            ticket._requeue_why = "drain_bounce" \
                if status == "rejected_draining" else "overload_bounce"
            raise EngineDown(f"{name} bounced: {out.get('error')}")
        prev = ticket.engine
        ticket.engine = name
        ticket.status = status or "queued"
        ticket.error = out.get("error")
        ticket.tokens = list(out.get("tokens") or [])
        mon = _monitor._active
        if affinity:
            self.counters["affinity_hits"] += 1
        else:
            self.counters["spills"] += 1
        if mon is not None:
            mon.route_placed(name, affinity)
        if prev is not None and prev != name:
            self._record_requeue(ticket, prev, name)
        ticket._requeue_why = None
        if ticket._trace is not None:
            sp = ticket._trace.span("dispatch", engine=name,
                                    affinity=affinity,
                                    attempt=ticket.attempts)
            sp.end()
        if ticket.finished:
            # the engine terminalized it at the door (validation failure):
            # surface as-is — input errors never requeue
            self._finish_ticket(ticket)

    def _record_requeue(self, ticket: RouteTicket, src: str, dst: str):
        ticket.requeues += 1
        self.counters["requeues"] += 1
        mon = _monitor._active
        if mon is not None:
            mon.route_requeue(
                ticket.id, src, dst, ticket._requeue_why or "?",
                trace_id=ticket._trace.trace_id
                if ticket._trace is not None else None)

    # --------------------------------------------------------- health / poll

    def _note_failure(self, name: str, why: str):
        n = self._fail_counts.get(name, 0) + 1
        self._fail_counts[name] = n
        if n >= self.eject_after:
            self._eject(name, f"transport failure x{n} ({why})")

    def _eject(self, name: str, why: str):
        if name in self._ejected:
            return
        rec = self._seen.get(name)
        self._ejected[name] = rec["key"] if rec is not None else (0, 0.0)
        self._fail_counts.pop(name, None)
        self.counters["ejections"] += 1
        mon = _monitor._active
        if mon is not None:
            mon.route_eject(name, why)

    def _chaos_kill(self, name: str):
        client = self._clients.get(name)
        if client is not None and hasattr(client, "kill"):
            client.kill()

    def poll(self) -> List[RouteTicket]:
        """One health + progress pass over live tickets: refresh the
        fleet view, eject stale/dead engines, requeue their tickets (and
        drain-flushed / engine-failed ones) elsewhere, re-dispatch
        router-queued tickets, and return every ticket that reached a
        terminal state during this pass."""
        self.refresh()
        self._service_queue()
        finished: List[RouteTicket] = []
        for ticket in [t for t in self._tickets.values() if not t.finished]:
            name = ticket.engine
            if name is None:
                continue           # still dispatching (shouldn't persist)
            rec = self._seen.get(name)
            if name not in self._ejected and rec is not None \
                    and not self._fresh(rec):
                self._eject(name, "stale heartbeat")
            if name in self._ejected:
                self._requeue(ticket, "engine_down")
                if ticket.finished:
                    finished.append(ticket)
                continue
            client = self._clients.get(name)
            if client is None:
                self._requeue(ticket, "engine_lost")
                if ticket.finished:
                    finished.append(ticket)
                continue
            try:
                if self._faults is not None \
                        and self._faults.fire("status") == "kill":
                    self._chaos_kill(name)
                try:
                    # incremental streaming: only tokens past our cursor
                    # cross the wire (clients without the ``since`` param
                    # — older doors, test stubs — get the full-view call)
                    st = client.status(ticket.id,
                                       since=len(ticket.tokens))
                except TypeError:
                    st = client.status(ticket.id)
            except OSError as e:
                if not isinstance(e, InjectedRouteFault):
                    self._note_failure(name, f"status: {e}")
                    if name in self._ejected:
                        self._requeue(ticket, "engine_down")
                        if ticket.finished:
                            finished.append(ticket)
                continue
            self._fail_counts.pop(name, None)
            if st is None:
                # the engine does not know this id: it restarted since we
                # placed there — resubmit (dedup makes a stale duplicate
                # harmless even if we mis-guess)
                self._requeue(ticket, "engine_restarted")
                if ticket.finished:
                    finished.append(ticket)
                continue
            ticket.status = st.get("status") or ticket.status
            ticket.error = st.get("error")
            new = [int(t) for t in st.get("tokens") or []]
            if "since" in st:
                # the effective cursor is clamped server-side: a
                # preemption that reset the stream replays from the clamp
                # point, so truncate-then-append reconciles both cases
                eff = int(st.get("since") or 0)
                ticket.tokens = ticket.tokens[:eff] + new
            else:
                ticket.tokens = new
            if not ticket.finished:
                continue
            if ticket.status == "rejected_draining":
                self._requeue(ticket, "drain_flush")
            elif ticket.status == "failed" and ticket.error \
                    and "engine failed" in ticket.error:
                self._requeue(ticket, "engine_failed")
            if ticket.finished:
                self._finish_ticket(ticket)
                finished.append(ticket)
        return finished

    def _requeue(self, ticket: RouteTicket, why: str):
        """Move one ticket off its (dead/draining) engine: same id, new
        placement. Bounded by ``requeue_limit`` so a request that fails
        everywhere terminalizes instead of orbiting."""
        if ticket.requeues >= self.requeue_limit:
            ticket.status = "failed"
            ticket.error = (f"requeue limit ({self.requeue_limit}) "
                            f"exhausted after {why}")
            self._finish_ticket(ticket)
            return
        # fresh avoid-set per episode: only the engine that just failed
        # this ticket is barred. Earlier avoids may have RESTARTED since
        # (rolling restart drains every engine in turn — a ticket bounced
        # by each must still land on whichever is healthy now).
        ticket._avoid = ({ticket.engine} if ticket.engine is not None
                         else set())
        ticket._requeue_why = why
        ticket.status = "requeued"
        ticket.tokens = []
        self._dispatch(ticket)

    def _finish_ticket(self, ticket: RouteTicket):
        ticket.t_done = time.time()
        if ticket._trace is not None:
            ticket._trace.end(status=ticket.status, error=ticket.error,
                              tokens=len(ticket.tokens),
                              requeues=ticket.requeues,
                              engine=ticket.engine)
            ticket._trace = None
        self._tickets.pop(ticket.id, None)

    def join(self, tickets: Optional[List[RouteTicket]] = None,
             step=None, timeout_s: float = 60.0,
             poll_s: float = 0.01) -> List[RouteTicket]:
        """Poll until every ticket terminalizes. ``step`` drives
        in-process fleets (the caller steps its engines between polls);
        without it the router sleeps ``poll_s`` between passes."""
        pending = list(tickets) if tickets is not None \
            else list(self._tickets.values())
        deadline = time.monotonic() + timeout_s
        while True:
            self.poll()
            if all(t.finished for t in pending):
                return pending
            if time.monotonic() > deadline:
                n = sum(1 for t in pending if not t.finished)
                raise TimeoutError(
                    f"{n} tickets unfinished after {timeout_s}s")
            if step is not None:
                step()
            else:
                time.sleep(poll_s)

    @property
    def live_tickets(self) -> int:
        return sum(1 for t in self._tickets.values() if not t.finished)

    # -------------------------------------------------------- fleet control

    def rolling_restart(self, grace_s: Optional[float] = None, restart=None,
                        step=None, wait_s: float = 60.0,
                        poll_s: float = 0.05):
        """Upgrade the fleet one engine at a time without dropping a
        request: cordon (no new placements) -> ``begin_drain(grace_s)`` ->
        wait for the drained door (its flushed tickets requeue to the
        live remainder via poll()) -> ``restart(name)`` if given -> wait
        for a strictly NEWER incarnation to register -> uncordon, next.
        Raises TimeoutError if any stage exceeds ``wait_s``."""
        for name in sorted(self.refresh()):
            rec = self._seen.get(name)
            client = self._clients.get(name) or (
                self._client_for(name, rec["blob"]) if rec else None)
            if client is None or getattr(client, "dead", False) \
                    or name in self._ejected:
                continue
            old_key = rec["key"] if rec is not None else None
            self._cordoned.add(name)
            try:
                client.begin_drain(grace_s)
                deadline = time.monotonic() + wait_s
                while True:
                    self.poll()
                    if step is not None:
                        step()
                    else:
                        time.sleep(poll_s)
                    try:
                        if client.door().get("state") == "drained":
                            break
                    except OSError:
                        break      # it died mid-drain; ejection owns it now
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"drain of {name} exceeded {wait_s}s")
                # the door can report drained within the same iteration the
                # flush happened; one more poll requeues the flushed tickets
                # to the live remainder BEFORE we take this engine down
                self.poll()
                if restart is not None:
                    restart(name)
                    deadline = time.monotonic() + wait_s
                    while True:
                        if step is not None:
                            step()
                        else:
                            time.sleep(poll_s)
                        self.refresh()
                        rec2 = self._seen.get(name)
                        if rec2 is not None and (old_key is None
                                                 or rec2["key"] > old_key):
                            break
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"restart of {name} exceeded {wait_s}s")
            finally:
                self._cordoned.discard(name)

    # ------------------------------------------------------------ telemetry

    def fleet_view(self) -> dict:
        """Per-engine door snapshot + router counters (the blob
        ``emit_state`` ships and tools/fleet_top.py renders)."""
        self.refresh()
        doors = {}
        for name, rec in self._seen.items():
            door = rec["blob"].get("door") or {}
            doors[name] = {
                "state": ("ejected" if name in self._ejected
                          else "cordoned" if name in self._cordoned
                          else "stale" if not self._fresh(rec)
                          else door.get("state", "?")),
                "queue_depth": door.get("queue_depth", 0),
                "active": door.get("active", 0),
                "free_slots": door.get("free_slots", 0),
                "free_blocks": door.get("free_blocks", 0),
                "prefix_hits": door.get("prefix_hits", 0),
                "pool_gen": door.get("pool_gen"),
                "pool_hits": door.get("pool_hits", 0),
                "inc": rec["blob"].get("inc"),
            }
        for name in self._ejected:
            doors.setdefault(name, {"state": "ejected"})
        placed = self.counters["affinity_hits"] + self.counters["spills"]
        view = {
            "doors": doors,
            "counters": dict(self.counters),
            "live_tickets": self.live_tickets,
            "queue_depth": len(self._queue),
            "affinity_hit_rate": round(
                self.counters["affinity_hits"] / placed, 4) if placed
            else 0.0,
        }
        return view

    def emit_state(self) -> dict:
        view = self.fleet_view()
        mon = _monitor._active
        if mon is not None:
            mon.route_state(view["doors"], dict(
                view["counters"], live_tickets=view["live_tickets"],
                affinity_hit_rate=view["affinity_hit_rate"]))
        return view
