"""Engine endpoint: discovery registration + HTTP door for fleet serving.

A copy of ``paddle_tpu/serving/endpoint.py`` (stdlib only) over the port's
``distributed/launch/master.KVClient``: the same directory keys, blob
schema and HTTP routes, so the JAX package's router and tools read a
port replica's records unchanged.

One DecodeEngine is a process-local object; a FLEET of them needs three
host-side pieces so a router (serving/router.py) can place, health-check
and drain replicas without ever importing engine internals:

* **Directories** — the discovery plane. ``LocalDirectory`` is an
  in-memory dict (in-process fleets: tests, ``chip_smoke.py``'s
  ``[fleet-router]``);
  ``KVDirectory`` rides the launch KV master (distributed/launch/
  master.py) under ``/{job}/serve/{engine}``, the same store + idiom the
  fleet-telemetry collector uses. The store has no server-side TTL, so
  registrations carry ``ttl_s`` + a monotonically bumped ``seq`` and the
  ROUTER judges staleness against its own receive clock — a publisher's
  clock never has to agree with anyone.

* **EngineEndpoint** — one engine's presence. Mints an incarnation
  (``{gen, start, token}``, the fleet collector's semantics: ``gen`` from
  ``PADDLE_ELASTIC_RESTART``, readers order by ``(gen, start)`` and
  reject late blobs from dead incarnations) and publishes TTL'd blobs
  carrying the engine's ``door_state()`` snapshot: accepting/draining/
  drained, load figures, and the prefix-registry digests cache-aware
  placement matches against. ``start_publishing()`` runs a daemon
  heartbeat — when the process is SIGKILLed the heartbeat stops with it,
  which is exactly the staleness signal the router ejects on.

* **DoorServer** — a stdlib ThreadingHTTPServer wrapping one engine for
  multi-process fleets: POST /submit, GET /status?id=, GET /door,
  POST /drain, GET /stats. The engine is not thread-safe, so every
  handler takes the same lock the worker's step loop holds around
  ``engine.step()`` — HTTP submissions and scheduler iterations
  interleave, never overlap.
"""
from __future__ import annotations

import json
import os
import secrets
import threading
import time
import urllib.parse
import urllib.request
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from ..distributed.launch.master import KVClient

__all__ = ["LocalDirectory", "KVDirectory", "EngineEndpoint", "DoorServer",
           "resolve_serve_master", "SERVE_MASTER_ENV", "JOB_ENV"]

SERVE_MASTER_ENV = "PADDLE_SERVE_MASTER"
JOB_ENV = "PADDLE_JOB_ID"

# terminal requests a DoorServer remembers for /status after completion
_DOOR_REQUEST_WINDOW = 4096


def resolve_serve_master() -> Optional[str]:
    """Discovery endpoint resolution, mirroring the collector's:
    a serve-specific env first, the checkpoint master as the shared
    fallback (one KV store typically serves every plane of a job)."""
    return (os.environ.get(SERVE_MASTER_ENV)
            or os.environ.get("PADDLE_CKPT_MASTER") or None)


class LocalDirectory:
    """In-process discovery: a dict with the KVDirectory contract. The
    same object is shared by endpoints (put) and the router (list), so
    in-process fleets — the chaos tests, chip_smoke's router phase — run
    the identical registration/staleness/incarnation logic with zero
    sockets."""

    def __init__(self):
        self._store: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def put(self, name: str, blob: dict) -> bool:
        # JSON round-trip: the local plane must not smuggle live object
        # state the KV plane could not carry
        blob = json.loads(json.dumps(blob))
        with self._lock:
            self._store[name] = blob
        return True

    def delete(self, name: str) -> bool:
        with self._lock:
            self._store.pop(name, None)
        return True

    def list(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._store.items()}


class KVDirectory:
    """Discovery over the launch KV master under ``/{job}/serve/``.
    Every call is bounded by a SHORT client timeout (placement polls this
    on the router's health cadence; one slow master must not stall the
    fleet) and failure-tolerant: an unreachable master reads as an empty
    fleet, which the router treats as 'nothing fresh', never as a crash."""

    def __init__(self, endpoint: Optional[str] = None,
                 job_id: Optional[str] = None, timeout: float = 1.0):
        endpoint = endpoint or resolve_serve_master()
        if not endpoint:
            raise ValueError(
                f"no KV master endpoint: pass one or set {SERVE_MASTER_ENV} "
                f"(or PADDLE_CKPT_MASTER)")
        job = job_id or os.environ.get(JOB_ENV, "default")
        self._kv = KVClient(endpoint, timeout=timeout)
        self._prefix = f"/{job}/serve/"

    def put(self, name: str, blob: dict) -> bool:
        return self._kv.put(self._prefix + name, json.dumps(blob))

    def delete(self, name: str) -> bool:
        return self._kv.delete(self._prefix + name)

    def list(self) -> Dict[str, dict]:
        out = {}
        for key, raw in self._kv.get_prefix(self._prefix).items():
            try:
                out[key[len(self._prefix):]] = json.loads(raw)
            except (ValueError, TypeError):
                continue           # a torn write is skipped, not fatal
        return out


class EngineEndpoint:
    """One engine's registration lifecycle on a directory.

    Each published blob carries the incarnation, a bumped ``seq`` (the
    router's freshness signal — same seq twice means the heartbeat
    stalled even if the store still answers), the advertised ``ttl_s``,
    an optional ``addr`` (the DoorServer address for cross-process
    dispatch; absent for in-process fleets), and the engine's live
    ``door_state()``."""

    def __init__(self, engine, name: str, directory, ttl_s: float = 3.0,
                 addr: Optional[str] = None, clock: Callable = time.time):
        self.engine = engine
        self.name = str(name)
        self.directory = directory
        self.ttl_s = float(ttl_s)
        self.addr = addr
        self._clock = clock
        gen = 0
        try:
            gen = int(os.environ.get("PADDLE_ELASTIC_RESTART", "0") or 0)
        except ValueError:
            pass
        # the collector's incarnation semantics: readers order by (gen, start) and a
        # dead incarnation's late blob must not resurrect it
        self.incarnation = {"gen": gen, "start": float(clock()),
                            "token": secrets.token_hex(4)}
        self._seq = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def blob(self) -> dict:
        self._seq += 1
        return {
            "name": self.name,
            "inc": dict(self.incarnation),
            "seq": self._seq,
            "ts": float(self._clock()),
            "ttl_s": self.ttl_s,
            "addr": self.addr,
            "door": self.engine.door_state(),
        }

    def publish(self) -> bool:
        return self.directory.put(self.name, self.blob())

    def deregister(self) -> bool:
        """Explicit goodbye (clean shutdown). A SIGKILLed process never
        gets here — that engine leaves by heartbeat staleness instead."""
        return self.directory.delete(self.name)

    def start_publishing(self, period_s: Optional[float] = None,
                         lock: Optional[threading.Lock] = None):
        """Daemon heartbeat publishing every ``period_s`` (default a third
        of the TTL, so one missed beat is not yet staleness). ``lock``:
        the worker's engine lock, held around the door_state() read."""
        if self._thread is not None:
            return
        period = period_s if period_s is not None else self.ttl_s / 3.0

        def beat():
            while not self._stop.wait(period):
                try:
                    if lock is not None:
                        with lock:
                            blob = self.blob()
                    else:
                        blob = self.blob()
                    self.directory.put(self.name, blob)
                except Exception:
                    continue       # a failed beat is staleness, not a crash

        self._thread = threading.Thread(target=beat, daemon=True,
                                        name=f"endpoint-{self.name}")
        self._thread.start()

    def stop_publishing(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._thread = None

    def close(self):
        self.stop_publishing()
        self.deregister()


class DoorServer:
    """HTTP front door for one engine (multi-process fleets).

    | route            | method | body / query          | returns          |
    |------------------|--------|-----------------------|------------------|
    | /submit          | POST   | prompt, max_new_tokens, eos_token_id, request_id | id, status, error, tokens |
    | /status          | GET    | ?id=<request_id>&since=<n> | id, status, error, tokens[n:], since, n_tokens |
    | /door            | GET    |                       | door, inc, name  |
    | /drain           | POST   | grace_s               | ok               |
    | /stats           | GET    |                       | engine.stats()   |

    The caller owns the step loop; handlers only touch the engine under
    ``lock`` (pass the same lock the loop holds around ``step()``)."""

    def __init__(self, engine, lock: Optional[threading.Lock] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 endpoint: Optional[EngineEndpoint] = None):
        self._engine = engine
        self._lock = lock if lock is not None else threading.Lock()
        self._endpoint = endpoint
        self._requests: "OrderedDict" = OrderedDict()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    return {}
                try:
                    return json.loads(self.rfile.read(n).decode())
                except (ValueError, UnicodeDecodeError):
                    return {}

            def do_POST(self):
                path = urllib.parse.urlparse(self.path).path
                if path == "/submit":
                    self._reply(200, outer._submit(self._body()))
                elif path == "/drain":
                    body = self._body()
                    grace = body.get("grace_s")
                    with outer._lock:
                        outer._engine.begin_drain(
                            float(grace) if grace is not None else None)
                    self._reply(200, {"ok": True})
                else:
                    self._reply(404, {"error": f"no route {path}"})

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path == "/status":
                    qs = urllib.parse.parse_qs(parsed.query)
                    rid = qs.get("id", [""])[0]
                    since = None
                    try:
                        if "since" in qs:
                            since = int(qs["since"][0])
                    except (ValueError, IndexError):
                        since = None
                    out = outer._status(rid, since=since)
                    self._reply(200 if "error_code" not in out else 404, out)
                elif parsed.path == "/door":
                    with outer._lock:
                        door = outer._engine.door_state()
                    self._reply(200, {
                        "door": door,
                        "inc": dict(outer._endpoint.incarnation)
                        if outer._endpoint is not None else None,
                        "name": outer._endpoint.name
                        if outer._endpoint is not None else None})
                elif parsed.path == "/stats":
                    with outer._lock:
                        self._reply(200, json.loads(json.dumps(
                            outer._engine.stats(), default=str)))
                else:
                    self._reply(404, {"error": f"no route {parsed.path}"})

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True, name="door-server")

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _req_view(self, req, since: Optional[int] = None) -> dict:
        """``since=None`` is the legacy full-token view. With a cursor,
        only tokens past it ship — plus ``since`` (the EFFECTIVE cursor,
        clamped to the current length: a preemption that reset the token
        list replays from the clamp point, so the caller reconciles by
        truncating to ``since`` before appending) and ``n_tokens`` (the
        authoritative total)."""
        tokens = [int(t) for t in req.tokens]
        out = {"id": req.id, "status": req.status, "error": req.error}
        if since is None:
            out["tokens"] = tokens
        else:
            eff = min(max(0, int(since)), len(tokens))
            out["tokens"] = tokens[eff:]
            out["since"] = eff
            out["n_tokens"] = len(tokens)
        return out

    def _submit(self, body: dict) -> dict:
        prompt = body.get("prompt") or []
        with self._lock:
            req = self._engine.submit(
                [int(t) for t in prompt],
                max_new_tokens=int(body.get("max_new_tokens", 32)),
                eos_token_id=body.get("eos_token_id"),
                request_id=body.get("request_id"))
            # keys are strings: /status?id= arrives as text, and an
            # engine-minted int id must still be findable
            self._requests[str(req.id)] = req
            while len(self._requests) > _DOOR_REQUEST_WINDOW:
                self._requests.popitem(last=False)
            return self._req_view(req)

    def _status(self, rid: str, since: Optional[int] = None) -> dict:
        with self._lock:
            req = self._requests.get(str(rid))
            if req is None:
                return {"error_code": "unknown_request", "id": rid}
            return self._req_view(req, since=since)

    def start(self):
        self._thread.start()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
