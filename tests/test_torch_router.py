"""The port's fleet front door (``serving/router.py`` and
``serving/endpoint.py``) against the JAX package's, on the CPU.

The cases of ``tests/test_router.py`` run on the port: the chaos seam
(``PADDLE_ROUTE_FAULT``), affinity / least-loaded / round-robin
placement, staleness on the router's own clock, incarnation ordering,
retry backoff with an injected sleep, ejection and requeue under the same
request id, ``rolling_restart`` and the router's telemetry, with the
engine-side request-id dedup on the port's ``DecodeEngine``.
``test_router_parity_with_jax`` gives both packages' routers the same
directory blobs, scripted clients, ``RouteFaultSchedule`` and seeded retry
jitter, and asks for the same placements, ejections, requeues, counters
and delay sequence."""
import io
import json
import os
import random
import sys
import time

import numpy as np
import pytest

import paddle_tpu.serving as jserving
from paddle_tpu.utils.retry import RetryPolicy as JaxRetryPolicy
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.serving import (DecodeEngine, EngineDown,
                                      EngineEndpoint, InjectedRouteFault,
                                      LocalDirectory, LocalEngineClient,
                                      RouteFaultSchedule, Router,
                                      prefix_digest)
from paddle_tpu_torch.serving.guardrails import ROUTE_FAULT_ENV
from paddle_tpu_torch.utils.retry import RetryPolicy

from test_torch_serving import _model_pair, greedy_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_FAULTS = RouteFaultSchedule.parse("")   # tests must ignore ambient env


@pytest.fixture(scope="module")
def models():
    return _model_pair(seed=11)


# ------------------------------------------------------- stub fleet plumbing


class StubDir:
    """Directory double: whatever blobs the test says, verbatim."""

    def __init__(self):
        self.blobs = {}

    def put(self, name, blob):
        self.blobs[name] = blob
        return True

    def delete(self, name):
        self.blobs.pop(name, None)
        return True

    def list(self):
        return {k: json.loads(json.dumps(v)) for k, v in self.blobs.items()}


def _blob(name, state="accepting", queue=0, active=0, free_slots=4,
          prefix_keys=(), block_size=8, gen=0, start=1.0, token="tok",
          seq=1, ttl_s=3.0, addr=None):
    return {"name": name,
            "inc": {"gen": gen, "start": start, "token": token},
            "seq": seq, "ts": 0.0, "ttl_s": ttl_s, "addr": addr,
            "door": {"state": state, "engine_id": 0,
                     "free_slots": free_slots, "queue_depth": queue,
                     "active": active, "free_blocks": 8,
                     "block_size": block_size,
                     "prefix_keys": list(prefix_keys), "prefix_hits": 0}}


class StubClient:
    """Engine-client double with scripted failures and mutable statuses;
    ``down`` is the exception class a dead client raises."""

    def __init__(self, down=EngineDown):
        self.dead = False
        self.down = down
        self.fail_next = 0         # raise OSError on the next N submits
        self.submits = []
        self.requests = {}

    def _check(self):
        if self.dead:
            raise self.down("stub dead")

    def submit(self, prompt, max_new_tokens, eos_token_id, request_id):
        self._check()
        if self.fail_next > 0:
            self.fail_next -= 1
            raise OSError("connection reset (scripted)")
        self.submits.append(str(request_id))
        view = {"id": str(request_id), "status": "queued", "error": None,
                "tokens": []}
        self.requests[str(request_id)] = view
        return dict(view)

    def status(self, request_id):
        self._check()
        v = self.requests.get(str(request_id))
        return dict(v) if v is not None else None

    def door(self):
        self._check()
        return {}

    def begin_drain(self, grace_s=None):
        self._check()

    def kill(self):
        self.dead = True


def _stub_fleet(blobs, clock=None, pkg=tserving, **router_kw):
    d = StubDir()
    clients = {}
    for b in blobs:
        d.put(b["name"], b)
        clients[b["name"]] = StubClient(pkg.EngineDown)
    router_kw.setdefault("fault_schedule", pkg.RouteFaultSchedule.parse(""))
    r = pkg.Router(d, clock=clock or time.time, **router_kw)
    for name, c in clients.items():
        r.attach(name, c)
    return d, clients, r


# ------------------------------------------------------- chaos seam parsing


def test_route_fault_schedule_parse_and_fire():
    s = RouteFaultSchedule.parse(
        "drop@submit:2,kill@route:3,slow@status:1:0.0")
    assert len(s.entries) == 3
    assert s.fire("submit") is None
    with pytest.raises(InjectedRouteFault):
        s.fire("submit")
    assert isinstance(InjectedRouteFault("x"), OSError)
    assert s.fire("route") is None and s.fire("route") is None
    assert s.fire("route") == "kill"
    assert s.fire("status") is None
    assert s.fired("submit") == 2 and s.fired("route") == 3


def test_route_fault_schedule_rejects_malformed():
    for bad in ("boom@submit:1", "drop@nowhere:1", "drop@submit:0",
                "drop@submit", "drop@submit:x"):
        with pytest.raises(ValueError):
            RouteFaultSchedule.parse(bad)


def test_route_fault_schedule_from_env(monkeypatch):
    monkeypatch.delenv(ROUTE_FAULT_ENV, raising=False)
    assert RouteFaultSchedule.from_env() is None
    monkeypatch.setenv(ROUTE_FAULT_ENV, "drop@route:1")
    s = RouteFaultSchedule.from_env()
    assert s is not None and s.entries == [("drop", "route", 1, 0.05)]


# ------------------------------------------------------------- placement


def test_affinity_beats_load():
    prompt = list(range(1, 12))
    key = prefix_digest(prompt[:8])
    _, clients, r = _stub_fleet([
        _blob("busy", queue=3, active=1, free_slots=0, prefix_keys=[key]),
        _blob("idle")])
    t = r.route(prompt, max_new_tokens=4)
    assert t.engine == "busy"
    assert r.counters["affinity_hits"] == 1 and r.counters["spills"] == 0
    assert clients["busy"].submits == [t.id]


def test_spill_is_least_loaded_with_free_slot_tiebreak():
    _, _, r = _stub_fleet([
        _blob("a", queue=2, active=1),
        _blob("b", queue=0, active=1),
        _blob("c", queue=0, active=1, free_slots=9)])
    t = r.route([1, 2, 3], max_new_tokens=4)
    assert t.engine == "c" and r.counters["spills"] == 1


def test_draining_doors_excluded_and_all_draining_rejects():
    _, clients, r = _stub_fleet([_blob("drn", state="draining"),
                                 _blob("ok", queue=5)])
    t = r.route([1, 2, 3], max_new_tokens=4)
    assert t.engine == "ok" and not clients["drn"].submits
    _, _, r2 = _stub_fleet([_blob("d0", state="draining"),
                            _blob("d1", state="drained")])
    t2 = r2.route([1, 2, 3], max_new_tokens=4)
    assert t2.status == "rejected" and t2.finished
    assert r2.counters["rejected"] == 1


def test_round_robin_control_arm_cycles():
    _, _, r = _stub_fleet([_blob("a"), _blob("b")], policy="round_robin")
    engines = [r.route([1, 2, 3], max_new_tokens=2).engine
               for _ in range(4)]
    assert engines == ["a", "b", "a", "b"]
    assert r.counters["affinity_hits"] == 0


def test_auto_minted_ids_unique_across_router_instances():
    _, _, r1 = _stub_fleet([_blob("a")])
    _, _, r2 = _stub_fleet([_blob("a")])
    ids1 = {r1.route([1, 2, 3], max_new_tokens=2).id for _ in range(5)}
    ids2 = {r2.route([1, 2, 3], max_new_tokens=2).id for _ in range(5)}
    assert not ids1 & ids2


def test_cordoned_engine_never_places():
    _, clients, r = _stub_fleet([_blob("a"), _blob("b")])
    r._cordoned.add("a")
    for _ in range(3):
        assert r.route([1, 2, 3], max_new_tokens=2).engine == "b"
    assert not clients["a"].submits


# ------------------------------------- staleness + incarnation ordering


def test_stale_heartbeat_unplaceable_until_seq_moves():
    clk = [100.0]
    d, _, r = _stub_fleet([_blob("a", ttl_s=2.0)], clock=lambda: clk[0])
    assert r.route([1, 2, 3], max_new_tokens=2).engine == "a"
    clk[0] += 6.0
    assert r.route([4, 5, 6], max_new_tokens=2).status == "rejected"
    d.put("a", _blob("a", ttl_s=2.0, seq=2))
    assert r.route([7, 8, 9], max_new_tokens=2).engine == "a"


def test_incarnation_supersession_and_late_blob_rejected():
    d, _, r = _stub_fleet([_blob("a", start=1.0, token="t1")],
                          clock=lambda: 100.0)
    r.refresh()
    assert r._seen["a"]["key"] == (0, 1.0)
    d.put("a", _blob("a", start=2.0, token="t2", seq=7))
    r.refresh()
    assert r._seen["a"]["key"] == (0, 2.0) and r._seen["a"]["token"] == "t2"
    d.put("a", _blob("a", start=1.0, token="t1", seq=99))
    r.refresh()
    assert r._seen["a"]["key"] == (0, 2.0)
    d.put("a", _blob("a", start=2.0, token="imposter", seq=100))
    r.refresh()
    assert r._seen["a"]["token"] == "t2"
    d.put("a", _blob("a", gen=1, start=0.5, token="t3"))
    r.refresh()
    assert r._seen["a"]["key"] == (1, 0.5)


def test_ejected_name_readmits_only_on_newer_incarnation():
    d, _, r = _stub_fleet([_blob("a", start=1.0), _blob("b")])
    r.refresh()
    r._eject("a", "test")
    assert r.route([1, 2, 3], max_new_tokens=2).engine == "b"
    d.put("a", _blob("a", start=1.0, seq=5))
    r.refresh()
    assert "a" in r._ejected
    d.put("a", _blob("a", start=9.0, token="t9"))
    r.refresh()
    assert "a" not in r._ejected and r._seen["a"]["key"] == (0, 9.0)


# ------------------------------------------------------- retry backoff


def test_injected_drops_backoff_without_ejection():
    sleeps = []
    pol = RetryPolicy(max_attempts=4, base_delay=0.1, max_delay=10.0,
                      multiplier=2.0, jitter=0.0, retry_on=(OSError,),
                      sleep=sleeps.append)
    _, clients, r = _stub_fleet(
        [_blob("a")], retry=pol,
        fault_schedule=RouteFaultSchedule.parse(
            "drop@submit:1,drop@submit:2"))
    t = r.route([1, 2, 3], max_new_tokens=2)
    assert t.engine == "a" and t.status == "queued" and t.attempts == 3
    assert sleeps == [pytest.approx(0.1), pytest.approx(0.2)]
    assert r.counters["ejections"] == 0 and not r._fail_counts
    assert clients["a"].submits == [t.id]


def test_real_transport_failure_avoids_engine_and_counts():
    pol = RetryPolicy(max_attempts=4, base_delay=0.01, jitter=0.0,
                      retry_on=(OSError,), sleep=lambda s: None)
    _, clients, r = _stub_fleet([_blob("a"), _blob("b", queue=9)],
                                retry=pol, eject_after=2)
    clients["a"].fail_next = 1
    t = r.route([1, 2, 3], max_new_tokens=2)
    assert t.engine == "b" and r._fail_counts.get("a") == 1
    assert r.counters["ejections"] == 0
    clients["a"].fail_next = 1
    assert r.route([4, 5, 6], max_new_tokens=2).engine == "b"
    assert "a" in r._ejected and r.counters["ejections"] == 1


def test_requeue_limit_terminalizes_orbiting_ticket():
    _, clients, r = _stub_fleet([_blob("a"), _blob("b")], requeue_limit=2)
    t = r.route([1, 2, 3], max_new_tokens=2)
    for _ in range(3):
        clients[t.engine].requests.pop(t.id, None)
        r.poll()
        if t.finished:
            break
    assert t.status == "failed" and "requeue limit" in t.error
    assert t.requeues == 2


# ------------------------------------------------------ parity with JAX


def _parity_scenario(pkg, retry_cls):
    """One scripted fleet story through ``pkg``'s router: affinity and
    spill placements, injected drops (backoff), a real submit failure, a
    chaos kill at the route site, a stale heartbeat, ejection and
    requeue. Returns everything a decision shows."""
    clk = [100.0]
    sleeps = []
    pol = retry_cls(max_attempts=4, base_delay=0.05, max_delay=1.0,
                    multiplier=2.0, jitter=0.5, retry_on=(OSError,),
                    sleep=sleeps.append, rng=random.Random(3))
    group = list(range(1, 12))
    d, clients, r = _stub_fleet(
        [_blob("a", prefix_keys=[prefix_digest(group[:8])], ttl_s=2.0),
         _blob("b", queue=1, ttl_s=2.0), _blob("c", ttl_s=2.0),
         _blob("z", state="draining")],
        clock=lambda: clk[0], pkg=pkg, retry=pol, eject_after=2,
        fault_schedule=pkg.RouteFaultSchedule.parse(
            "drop@submit:2,drop@submit:3,kill@route:6,slow@status:2:0.0"))
    clients["c"].fail_next = 1
    rs = np.random.RandomState(4)
    log = []
    for i in range(9):
        prompt = group + [i] if i % 3 == 0 else rs.randint(1, 64, 6).tolist()
        t = r.route(prompt, max_new_tokens=4, request_id=f"q{i}")
        log.append(("route", t.id, t.engine, t.status, t.attempts))
    for rnd in range(7):
        clk[0] += 1.0
        for name in ("a", "b"):          # c's heartbeat stopped at seq 1
            b = d.blobs[name]
            d.put(name, dict(b, seq=b["seq"] + 1))
        done = r.poll()
        log.append(("poll", rnd, sorted(t.id for t in done),
                    sorted(r._ejected),
                    sorted((t.id, t.engine, t.requeues, t.status)
                           for t in r._tickets.values())))
    view = r.fleet_view()
    return (log, dict(r.counters), sleeps,
            {n: v["state"] for n, v in view["doors"].items()},
            {n: c.submits for n, c in clients.items()})


def test_router_parity_with_jax():
    tout = _parity_scenario(tserving, RetryPolicy)
    jout = _parity_scenario(jserving, JaxRetryPolicy)
    assert tout[0] == jout[0]                       # decisions, in order
    assert tout[1] == jout[1]                       # counters
    assert tout[2] == pytest.approx(jout[2])        # retry delays
    assert tout[3] == jout[3] and tout[4] == jout[4]
    counters = tout[1]
    assert counters["affinity_hits"] >= 1 and counters["spills"] >= 2
    assert counters["ejections"] == 2 and counters["requeues"] >= 3
    assert len(tout[2]) >= 3
    assert tout[3]["c"] == "ejected" and tout[3]["z"] == "draining"


# ----------------------------------------- engine door + submit-id dedup


def test_door_state_lifecycle_and_submit_id_dedup(models):
    eng = DecodeEngine(models[1], max_slots=2, max_len=48, block_size=8,
                       prefill_chunk=8, kv_blocks=24)
    door = eng.door_state()
    assert door["state"] == "accepting"
    assert door["free_slots"] == 2 and door["queue_depth"] == 0
    assert door["block_size"] == 8 and door["prefix_keys"] == []
    assert door["pool_gen"] is None and door["pool_hits"] == 0
    prompt = list(range(1, 13))
    a = eng.submit(prompt, max_new_tokens=3, request_id="rid-1")
    assert eng.door_state()["queue_depth"] == 1
    assert eng.submit([9, 9, 9], max_new_tokens=7, request_id="rid-1") is a
    eng.run()
    assert a.status == "done" and len(a.output_tokens) == 3
    door = eng.door_state()
    assert prefix_digest(prompt[:8]) in door["prefix_keys"]
    assert all(isinstance(k, str) and len(k) == 16
               for k in door["prefix_keys"])
    steps = eng.decode_steps
    assert eng.submit(prompt, max_new_tokens=3, request_id="rid-1") is a
    eng.run()
    assert eng.decode_steps == steps
    b = eng.submit([4, 5, 6], max_new_tokens=2)
    assert b is not a
    eng.run()
    eng.begin_drain(grace_s=5.0)
    assert eng.door_state()["state"] in ("draining", "drained")
    eng.drain(grace_s=5.0)
    assert eng.door_state()["state"] == "drained"
    json.dumps(eng.door_state())


# --------------------------------------------------- integration fixtures


def _mk_fleet(model, names=("eng0", "eng1"), **router_kw):
    directory = LocalDirectory()
    engines, endpoints = {}, {}

    def make(name):
        eng = DecodeEngine(model, max_slots=2, max_len=48, block_size=8,
                           prefill_chunk=8, kv_blocks=24)
        engines[name] = eng
        endpoints[name] = EngineEndpoint(eng, name, directory, ttl_s=5.0)
        endpoints[name].publish()
        return eng

    router_kw.setdefault("fault_schedule", NO_FAULTS)
    router_kw.setdefault("stale_after", 1e9)
    router = Router(directory, **router_kw)
    for n in names:
        make(n)
        router.attach(n, LocalEngineClient(engines[n]))

    def step(check_invariants=False):
        for n, eng in list(engines.items()):
            client = router._clients.get(n)
            if client is not None and getattr(client, "dead", False):
                continue            # SIGKILL stand-in: nobody steps it
            eng.step()
            endpoints[n].publish()
            if check_invariants:
                eng.check_invariants()

    return directory, engines, endpoints, router, make, step


def test_rolling_restart_drops_nothing(models):
    jm, tm = models
    (_, engines, endpoints, router, make, step) = _mk_fleet(tm)
    restarted = []

    def restart(name):
        restarted.append(name)
        old = engines[name]
        endpoints[name].deregister()
        eng = make(name)
        router.attach(name, LocalEngineClient(eng))
        old.close()

    rng = np.random.RandomState(3)
    tickets = [router.route(rng.randint(1, 64, 6).tolist(),
                            max_new_tokens=4) for _ in range(4)]
    old_incs = {n: dict(endpoints[n].incarnation) for n in engines}
    router.rolling_restart(grace_s=30.0, restart=restart, step=step,
                           wait_s=60.0)
    router.join(tickets, step=step, timeout_s=60)
    assert [t.status for t in tickets] == ["done"] * 4
    assert sorted(restarted) == sorted(engines)
    assert router.counters["rejected"] == 0
    assert sum(t.requeues for t in tickets) >= 1
    for t in tickets:
        assert t.tokens == greedy_from(jm, _req(t))
    for n, ep in endpoints.items():
        assert (ep.incarnation["gen"], ep.incarnation["start"]) > \
            (old_incs[n]["gen"], old_incs[n]["start"]) or \
            ep.incarnation["token"] != old_incs[n]["token"]


class _req:
    """A ticket seen as a request by ``greedy_from``."""

    def __init__(self, ticket):
        self.prompt = ticket.prompt
        self.output_tokens = ticket.tokens


def test_chaos_gate_scripted_route_faults(models, monkeypatch):
    """Two in-process engines behind the router under a scripted
    PADDLE_ROUTE_FAULT (drop, slow and a kill at the sixth status poll):
    invariants after every step, every ticket done with the JAX model's
    greedy tokens, requeues and ejections both fired, the same id never
    generates twice, and the survivor builds no program after warm-up."""
    jm, tm = models
    monkeypatch.setenv(ROUTE_FAULT_ENV,
                       "drop@submit:2,slow@status:2:0.001,kill@status:6")
    _, engines, _, router, _, step = _mk_fleet(
        tm, eject_after=2, fault_schedule=None)   # None -> from_env
    assert router._faults is not None and router._faults.entries
    for eng in engines.values():
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run()
    warm = {n: e.compile_count for n, e in engines.items()}
    rng = np.random.RandomState(11)
    tickets = [router.route(rng.randint(1, 64, 6).tolist(),
                            max_new_tokens=6, request_id=f"cg-{i}")
               for i in range(4)]
    deadline = time.monotonic() + 120
    while not all(t.finished for t in tickets):
        assert time.monotonic() < deadline, [t.status for t in tickets]
        step(check_invariants=True)
        router.poll()
    assert [t.status for t in tickets] == ["done"] * 4
    for t in tickets:
        assert t.tokens == greedy_from(jm, _req(t))
    assert router.counters["requeues"] >= 1
    assert router.counters["ejections"] >= 1
    dead = [n for n, c in router._clients.items()
            if getattr(c, "dead", False)]
    assert len(dead) == 1
    survivor = next(n for n in engines if n not in dead)
    assert all(t.engine == survivor for t in tickets if t.requeues)
    t0 = next(t for t in tickets if t.requeues)
    steps_before = engines[survivor].decode_steps
    view = router._clients[survivor].submit(t0.prompt, 6, None, t0.id)
    assert view["status"] == "done" and view["tokens"] == t0.tokens
    step()
    assert engines[survivor].decode_steps == steps_before
    assert engines[survivor].compile_count == warm[survivor]
    for eng in engines.values():
        eng.check_invariants()


def test_affinity_colocates_and_round_robin_does_not(models):
    """Serialized same-prefix requests: affinity lands each on the engine
    that parked the prefix (a prefix hit there), round-robin alternates;
    every stream is the JAX model's greedy one under both policies."""
    jm, tm = models
    prefix = list(range(5, 21))                 # two whole blocks
    rates = {}
    for policy in ("affinity", "round_robin"):
        _, engines, _, router, _, step = _mk_fleet(tm, policy=policy)
        tickets = []
        for i in range(4):
            t = router.route(prefix + [30 + i], max_new_tokens=3,
                             request_id=f"{policy}-{i}")
            router.join([t], step=step, timeout_s=60)
            tickets.append(t)
        for t in tickets:
            assert t.status == "done"
            assert t.tokens == greedy_from(jm, _req(t))
        rates[policy] = router.fleet_view()["affinity_hit_rate"]
        hits = sum(e.door_state()["prefix_hits"] for e in engines.values())
        if policy == "affinity":
            assert len({t.engine for t in tickets}) == 1
            assert hits == 3
        else:
            assert [t.engine for t in tickets] == ["eng0", "eng1"] * 2
            assert hits == 2
    assert rates["affinity"] == 0.75 and rates["round_robin"] == 0.0


# ------------------------------------------------- telemetry surfaces


def _load_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import importlib
        mod = importlib.import_module(name)
        return importlib.reload(mod)
    finally:
        sys.path.pop(0)


def test_metrics_summary_router_section_and_requeue_storm(tmp_path):
    path = str(tmp_path / "run.jsonl")
    tmon.enable(path, flush_every=1)
    try:
        d, clients, r = _stub_fleet([_blob("e0"),
                                     _blob("e1", state="draining")])
        tickets = [r.route([i, 2, 3], max_new_tokens=2,
                           request_id=f"st-{i}") for i in range(3)]
        assert all(t.engine == "e0" for t in tickets)
        d.put("e0", _blob("e0", state="draining", seq=2))
        d.put("e1", _blob("e1", seq=2))
        for t in tickets:
            clients["e0"].requests[t.id]["status"] = "rejected_draining"
        r.poll()
        assert all(t.engine == "e1" for t in tickets)
        assert r.counters["requeues"] == 3 and r.counters["ejections"] == 0
        r.emit_state()
    finally:
        tmon.disable()
    ms = _load_tool("metrics_summary")
    buf = io.StringIO()
    assert ms.summarize([path], out=buf) == 0
    out = buf.getvalue()
    assert "== router ==" in out
    assert "requeues 3" in out and "ejections 0" in out
    assert "requeues[drain_flush] x3" in out
    assert "WARNING" in out and "requeue-storm" in out


def test_fleet_top_renders_port_route_state(tmp_path):
    """The port's ``route_state`` records (a real router's emit_state)
    render in tools/fleet_top.py's router panel."""
    path = str(tmp_path / "route.jsonl")
    tmon.enable(path, flush_every=1)
    try:
        _, _, r = _stub_fleet([_blob("eng0"), _blob("eng1")])
        for i in range(3):
            r.route([i, 1, 2], max_new_tokens=2)
        r._eject("eng1", "test")
        r.emit_state()
    finally:
        tmon.disable()
    ft = _load_tool("fleet_top")
    meta, fleets, warns, routes = ft.load_stream(path, routes=True)
    assert routes
    frame = ft.render(meta, fleets, warns, now=time.time(), routes=routes)
    assert "router: 2 engines" in frame
    assert "eng1" in frame and "ejected" in frame
