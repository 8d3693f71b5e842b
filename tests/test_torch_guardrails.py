"""The port's serving guardrail plane against the JAX package's, in fp32
on the CPU: deadlines, cancellation, drain (and SIGTERM drain through
``drain_on_preemption``), idempotent request ids, the dispatch watchdog
and the ``PADDLE_SERVE_FAULT`` chaos seam (``serving/guardrails.py``).

The cases of ``tests/test_guardrails.py`` run on the port's engine, with
every generated token held to the JAX model's greedy tokens
(``greedy_from``); ``test_guardrail_parity_with_jax`` drives the JAX
engine and the port's through the same requests, fault schedule, cancel,
drain and step-counting fake clock, and asks for the same statuses,
errors, tokens and counters. The watchdog tests script their hang so
that no timing margin decides it: the threshold stays at 60 s but inside
the faulted call, which waits for the watchdog's callback (at most 30
s)."""
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from paddle_tpu.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.serving import FaultSchedule as JaxFaultSchedule
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.distributed.preemption import PreemptionWatcher
from paddle_tpu_torch.serving import (TERMINAL_STATUSES, DecodeEngine,
                                      EngineHangError, FaultSchedule,
                                      InjectedFault)
from paddle_tpu_torch.serving import guardrails
from paddle_tpu_torch.serving.scheduler import Request

from test_torch_serving import _model_pair, greedy_from

GEOM = dict(max_slots=4, max_len=48, block_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def models():
    return _model_pair(seed=7)


@pytest.fixture(scope="module")
def engine(models):
    """Shared paged chunked engine; every test leaves it idle and NOT
    draining."""
    eng = DecodeEngine(models[1], **GEOM)
    eng.submit([1, 2, 3], max_new_tokens=2)
    eng.run()
    yield eng
    eng.close()


def _greedy_ok(jm, req):
    assert list(req.output_tokens) == greedy_from(jm, req), req.prompt


# the watchdog's threshold outside the scripted hang: no healthy call on a
# loaded host comes near it; inside the hang it drops to HANG_S
CALM_S = 60.0
HANG_S = 0.05


def _hang_on_event(eng):
    """Script the engine's ``slow`` faults as a hang the watchdog sees
    however loaded the host is: the engine is built with ``hang_s=CALM_S``,
    and a ``slow`` fault lowers the threshold to ``HANG_S`` inside its own
    armed window, then waits until the watchdog has fired (at most 30 s)
    and restores it. No healthy call can trip it. Returns the event."""
    fired = threading.Event()
    wd = eng._watchdog
    on_hang = wd._on_hang

    def hook(info, elapsed_s):
        try:
            on_hang(info, elapsed_s)
        finally:
            fired.set()

    def hang(_s):
        with wd._cond:
            wd.hang_s = HANG_S
            wd._cond.notify()
        fired.wait(30.0)
        wd.hang_s = CALM_S
    wd._on_hang = hook
    eng._faults.sleep = hang
    return fired


# ------------------------------------------------------------- terminal set


def test_terminal_status_set_poller_regression(models):
    assert TERMINAL_STATUSES == {"done", "failed", "rejected_overload",
                                 "rejected_draining", "expired",
                                 "cancelled"}
    eng = DecodeEngine(models[1], max_slots=2, max_len=32, block_size=8,
                       prefill_chunk=8, max_queue=2)
    good = eng.submit([1, 2, 3], max_new_tokens=2)
    q = eng.submit([4, 5, 6], max_new_tokens=2)
    over = eng.submit([7, 8, 9], max_new_tokens=2)
    assert over.status == "rejected_overload" and over.finished
    bad = eng.submit([], max_new_tokens=2)
    assert bad.status == "failed" and bad.finished
    eng.run()
    assert good.finished and q.finished
    for status in TERMINAL_STATUSES:
        r = Request([1], max_new_tokens=1)
        r.status = status
        assert r.finished, status
    r = Request([1], max_new_tokens=1)
    for status in ("queued", "prefilling", "running"):
        r.status = status
        assert not r.finished, status


# ---------------------------------------------------------------- deadlines


def test_deadline_precedence_unit():
    r = Request([1, 2], max_new_tokens=4, ttft_deadline_s=1.0,
                deadline_s=5.0)
    t0 = r.t_submit
    assert r.deadline_exceeded(t0 + 0.5) is None
    assert r.deadline_exceeded(t0 + 2.0) == "ttft"
    r.t_first_token = t0 + 0.5
    assert r.deadline_exceeded(t0 + 2.0) is None
    assert r.deadline_exceeded(t0 + 6.0) == "total"
    r2 = Request([1], max_new_tokens=1, ttft_deadline_s=1.0, deadline_s=2.0)
    assert r2.deadline_exceeded(r2.t_submit + 3.0) == "total"
    with pytest.raises(ValueError, match="deadline_s"):
        Request([1], max_new_tokens=1, deadline_s=-1.0)
    with pytest.raises(ValueError, match="ttft_deadline_s"):
        Request([1], max_new_tokens=1, ttft_deadline_s=-0.5)


def test_expiry_in_queue_and_mid_decode(engine, models):
    rng = np.random.RandomState(10)
    survivor = engine.submit(rng.randint(1, 64, 5).tolist(),
                             max_new_tokens=10)
    doomed_q = engine.submit(rng.randint(1, 64, 4).tolist(),
                             max_new_tokens=4, deadline_s=0.0)
    fin = engine.step()
    engine.check_invariants()
    assert doomed_q in fin and doomed_q.status == "expired"
    assert "queue" in doomed_q.error and doomed_q.slot is None
    assert not doomed_q.tokens
    doomed_d = engine.submit(rng.randint(1, 64, 4).tolist(),
                             max_new_tokens=30, deadline_s=120.0)
    while doomed_d.status != "running":
        engine.step()
    free_before = engine._pager.free_blocks + engine._pager.lru_blocks
    real = engine._clock
    try:
        engine._clock = lambda: time.time() + 600.0
        fin = engine.step()
    finally:
        engine._clock = real
    engine.check_invariants()
    assert doomed_d in fin and doomed_d.status == "expired"
    assert "mid-decode" in doomed_d.error and len(doomed_d.tokens) >= 1
    assert engine._pager.free_blocks + engine._pager.lru_blocks \
        > free_before
    engine.run()
    assert survivor.status == "done"
    _greedy_ok(models[0], survivor)
    assert engine.stats()["guardrails"]["expired"] >= 2


def test_ttft_expiry_mid_chunked_prefill(engine):
    rng = np.random.RandomState(11)
    req = engine.submit(rng.randint(1, 64, 20).tolist(), max_new_tokens=4,
                        ttft_deadline_s=300.0)
    engine.step()
    assert req.status == "prefilling"
    real = engine._clock
    try:
        engine._clock = lambda: time.time() + 600.0
        fin = engine.step()
    finally:
        engine._clock = real
    engine.check_invariants()
    assert req in fin and req.status == "expired"
    assert "mid-prefill" in req.error
    assert engine.live_count == 0 and not engine._prefilling
    probe = engine.submit([5, 6, 7], max_new_tokens=2)
    engine.run()
    assert probe.status == "done"


def test_triple_point_preempt_requeue_expire(models):
    """A follower sharing the leader's prefix is preempted by pool
    pressure, requeued, and expires while it waits: its blocks release
    exactly once and the leader's tokens stay greedy."""
    jm, tm = models
    eng = DecodeEngine(tm, kv_blocks=9, **GEOM)
    rng = np.random.RandomState(12)
    prefix = rng.randint(1, 64, 8).tolist()
    lead = eng.submit(prefix + rng.randint(1, 64, 4).tolist(),
                      max_new_tokens=24)
    while lead.status != "running":
        eng.step()
        eng.check_invariants()
    follower = eng.submit(prefix + rng.randint(1, 64, 12).tolist(),
                          max_new_tokens=24, deadline_s=900.0)
    steps = 0
    while follower.preemptions == 0:
        eng.step()
        eng.check_invariants()
        steps += 1
        assert steps < 200, "pool never forced a preemption"
    assert follower.status == "queued"
    real = eng._clock
    try:
        eng._clock = lambda: time.time() + 3600.0
        fin = eng.step()
    finally:
        eng._clock = real
    eng.check_invariants()
    assert follower in fin and follower.status == "expired"
    assert "queue" in follower.error
    eng.run()
    eng.check_invariants()
    assert lead.status == "done"
    _greedy_ok(jm, lead)
    pg = eng._pager
    assert pg.free_blocks + pg.lru_blocks == pg.usable_blocks
    assert (pg._ref == 0).all()


# ------------------------------------------------------------ cancellation


def test_cancel_queue_prefill_decode(engine, models):
    rng = np.random.RandomState(13)
    keeper = engine.submit(rng.randint(1, 64, 4).tolist(),
                           max_new_tokens=12)
    while keeper.status != "running":
        engine.step()
    fillers = [engine.submit(rng.randint(1, 64, 4).tolist(),
                             max_new_tokens=8) for _ in range(3)]
    queued = engine.submit(rng.randint(1, 64, 4).tolist(), max_new_tokens=8)
    assert engine.cancel(queued) is True
    assert queued.status == "cancelled" and "queued" in queued.error
    fin = engine.run()
    assert queued in fin
    mid = engine.submit(rng.randint(1, 64, 20).tolist(), max_new_tokens=8)
    engine.step()
    assert mid.status == "prefilling"
    assert engine.cancel(mid.id) is True
    engine.check_invariants()
    assert mid.status == "cancelled" and "prefill" in mid.error
    dec = engine.submit(rng.randint(1, 64, 4).tolist(), max_new_tokens=30)
    while dec.status != "running":
        engine.step()
    assert engine.cancel(dec.id) is True
    engine.check_invariants()
    assert dec.status == "cancelled" and "decode" in dec.error
    assert engine.cancel(dec) is False and engine.cancel(999999) is False
    engine.run()
    assert keeper.status == "done"
    assert all(f.status == "done" for f in fillers)
    _greedy_ok(models[0], keeper)


# ------------------------------------------------------------- request ids


def test_request_id_dedup_and_door_bounce(models):
    """A duplicate id returns the existing Request (live, or terminal in
    the window) and never generates twice; a drain bounce is forgotten so
    the id stays resubmittable elsewhere."""
    eng = DecodeEngine(models[1], **GEOM)
    a = eng.submit([1, 2, 3], max_new_tokens=4, request_id="r-1")
    assert eng.submit([9, 9], max_new_tokens=2, request_id="r-1") is a
    eng.run()
    steps = eng.decode_steps
    assert eng.submit([1, 2, 3], max_new_tokens=4, request_id="r-1") is a
    eng.run()
    assert eng.decode_steps == steps and a.status == "done"
    eng.begin_drain()
    b = eng.submit([4, 5], max_new_tokens=2, request_id="r-2")
    assert b.status == "rejected_draining"
    assert "r-2" not in eng._by_id and "r-2" not in eng._done_ids
    eng.step()
    assert eng.drained and eng.drains == 1


# ------------------------------------------------------------------- drain


def test_drain_door_grace_and_completion(models):
    eng = DecodeEngine(models[1], max_slots=2, max_len=48, block_size=8,
                       prefill_chunk=8)
    rng = np.random.RandomState(14)
    fast = eng.submit(rng.randint(1, 64, 4).tolist(), max_new_tokens=3)
    slow = eng.submit(rng.randint(1, 64, 4).tolist(), max_new_tokens=40)
    while eng.live_count < 2:
        eng.step()
    queued = eng.submit(rng.randint(1, 64, 4).tolist(), max_new_tokens=4)
    eng.begin_drain(grace_s=900.0)
    assert eng.draining and not eng.drained
    late = eng.submit(rng.randint(1, 64, 4).tolist(), max_new_tokens=4)
    assert late.status == "rejected_draining" and "draining" in late.error
    assert eng.door_state()["state"] == "draining"
    fin = eng.step()
    assert queued in fin and queued.status == "rejected_draining"
    while fast.status != "done":
        eng.step()
    assert slow.status == "running"
    real = eng._clock
    try:
        eng._clock = lambda: time.time() + 3600.0
        fin = eng.step()
    finally:
        eng._clock = real
    eng.check_invariants()
    assert slow in fin and slow.status == "expired"
    assert "drain grace" in slow.error
    assert eng.drained and eng.drains == 1
    assert eng.door_state()["state"] == "drained"
    assert eng.step() == [] and eng.drains == 1


def test_drain_method_blocks_until_empty(models):
    eng = DecodeEngine(models[1], max_slots=2, max_len=32, block_size=8,
                       prefill_chunk=8)
    a = eng.submit([1, 2, 3], max_new_tokens=3)
    b = eng.submit([4, 5, 6], max_new_tokens=5)
    while eng.live_count == 0:
        eng.step()
    out = eng.drain()
    assert eng.drained and a in out and b in out
    assert a.status == b.status == "done"


def test_drain_on_preemption_sigterm(models, tmp_path):
    """SIGTERM to this process -> the watcher records it -> the next step
    begins a drain: the live slot finishes, the queue bounces as
    ``rejected_draining``, and the monitor hears ``serve_drain_begin`` /
    ``serve_drain_end``."""
    path = str(tmp_path / "drain.jsonl")
    prev = signal.getsignal(signal.SIGTERM)
    tmon.enable(path)
    try:
        eng = DecodeEngine(models[1], max_slots=1, max_len=48, block_size=8,
                           kv_blocks=16, prefill_chunk=8)
        with PreemptionWatcher() as w:
            assert eng.drain_on_preemption(w, grace_s=600.0) is w
            live = eng.submit([1, 2, 3, 4], max_new_tokens=6)
            waiting = eng.submit([5, 6, 7], max_new_tokens=6)
            while live.status != "running":
                eng.step()
            os.kill(os.getpid(), signal.SIGTERM)
            steps = 0
            while not eng.drained:
                eng.step()
                steps += 1
                assert steps < 100
            assert w.signum == signal.SIGTERM
        assert live.status == "done" and len(live.tokens) == 6
        assert waiting.status == "rejected_draining"
        assert eng.drains == 1
        tmon.get().flush()
        kinds = [json.loads(l).get("kind") for l in open(path)]
        assert "serve_drain_begin" in kinds and "serve_drain_end" in kinds
        assert tmon.snapshot()["counters"]["serve/drained"] == 1
    finally:
        tmon.disable()
    assert signal.getsignal(signal.SIGTERM) == prev


# ---------------------------------------------------- watchdog + chaos seam


def test_fault_schedule_parsing():
    fs = FaultSchedule.parse("slow@decode:3:0.2, raise@admit:1,"
                             "raise@alloc:5")
    assert fs.entries[0] == ("slow", "decode", 3, 0.2)
    assert fs.entries[1][3] > 0
    assert [e[1:3] for e in fs.entries] \
        == [e[1:3] for e in JaxFaultSchedule.parse(
            "slow@decode:3:0.2, raise@admit:1,raise@alloc:5").entries]
    for bad in ("explode@decode:1", "raise@gpu:1", "raise@decode:0",
                "raise@decode", "slow@chunk:x"):
        with pytest.raises(ValueError):
            FaultSchedule.parse(bad)
    fs = FaultSchedule.parse("raise@admit:2")
    fs.fire("admit")
    with pytest.raises(InjectedFault):
        fs.fire("admit")
    fs.fire("admit")
    assert fs.fired("admit") == 3
    assert guardrails.FAULT_SITES == ("decode", "chunk", "admit", "alloc",
                                      "verify", "spec_reserve", "export",
                                      "fetch", "adopt")


def test_injected_admission_fault_fails_one_request(models):
    eng = DecodeEngine(models[1], max_slots=2, max_len=32, block_size=8,
                       prefill_chunk=8,
                       fault_schedule=FaultSchedule.parse("raise@admit:2"))
    a = eng.submit([1, 2, 3], max_new_tokens=4)
    b = eng.submit([4, 5, 6], max_new_tokens=4)
    fin = eng.run()
    eng.check_invariants()
    assert a.status == "done"
    assert b.status == "failed" and "injected admit fault" in b.error
    assert b in fin


def test_watchdog_hang_warn_dump_and_loud_failure(models, tmp_path):
    path = str(tmp_path / "hang.jsonl")
    tmon.enable(path)
    eng = DecodeEngine(models[1], max_slots=2, max_len=32, block_size=8,
                       prefill_chunk=8, hang_s=CALM_S,
                       fault_schedule=FaultSchedule.parse("slow@decode:2"))
    try:
        fired = _hang_on_event(eng)
        req = eng.submit([1, 2, 3], max_new_tokens=4)
        with pytest.warns(RuntimeWarning, match="dispatch hang"):
            with pytest.raises(EngineHangError, match="decode dispatch"):
                eng.run()
        assert fired.is_set()
        eng.check_invariants()
        assert req.status == "failed" and "engine failed" in req.error
        assert eng.live_count == 0 and not eng._prefilling
        assert tmon.snapshot()["counters"]["serve/hang_warns"] == 1
        assert eng.stats()["guardrails"]["hang_warns"] == 1
        assert os.path.exists(str(tmp_path / "hang.flight.json"))
        ok = eng.submit([7, 8, 9], max_new_tokens=2)
        fin = eng.run()
        assert ok.status == "done" and req in fin
        tmon.get().flush()
        hang = [r for r in map(json.loads, open(path))
                if r.get("kind") == "serve_hang"]
        assert len(hang) == 1 and hang[0]["path"] == "decode"
        assert hang[0]["elapsed_s"] >= HANG_S
    finally:
        eng.close()
        tmon.disable()


def test_hang_then_raise_does_not_poison_next_dispatch(models):
    eng = DecodeEngine(models[1], max_slots=2, max_len=32, block_size=8,
                       prefill_chunk=8, hang_s=CALM_S,
                       fault_schedule=FaultSchedule.parse(
                           "slow@decode:2,raise@decode:2"))
    try:
        fired = _hang_on_event(eng)
        doomed = eng.submit([1, 2, 3], max_new_tokens=4)
        with pytest.warns(RuntimeWarning, match="dispatch hang"):
            with pytest.raises(InjectedFault):
                eng.run()
        assert fired.is_set() and doomed.status == "failed"
        ok = eng.submit([4, 5, 6], max_new_tokens=3)
        eng.run()
        assert ok.status == "done"
        eng.check_invariants()
    finally:
        eng.close()


def test_watchdog_quiet_when_healthy(models):
    """Armed on every call, a healthy engine never fires: same tokens as
    the unguarded engine and no hang counted."""
    jm, tm = models
    eng = DecodeEngine(tm, hang_s=30.0, **GEOM)
    try:
        reqs = [eng.submit([3, 1, 4, 1, 5], max_new_tokens=6),
                eng.submit(list(range(2, 20)), max_new_tokens=5)]
        eng.run()
        for r in reqs:
            _greedy_ok(jm, r)
        assert eng._watchdog.hangs == 0
        assert eng.stats()["guardrails"]["hang_warns"] == 0
    finally:
        eng.close()
    assert eng._watchdog is None


def test_chaos_gate_mixed_schedule(models, monkeypatch):
    """A scripted PADDLE_SERVE_FAULT schedule (the env path) over a
    pressure-sized pool, with expiry, cancel, injected alloc/admit faults,
    preemption and a drain: every request ends terminal, invariants hold
    after every step, and no program is built in steady state."""
    monkeypatch.setenv("PADDLE_SERVE_FAULT",
                       "raise@alloc:25,raise@alloc:31,raise@admit:6,"
                       "slow@chunk:4:0.005,slow@decode:7:0.005")
    jm, tm = models
    eng = DecodeEngine(tm, kv_blocks=9, **GEOM)
    assert eng._faults is not None
    warm = eng.submit([1, 2, 3], max_new_tokens=2)
    eng.run()
    assert warm.status == "done"
    base = eng.compile_count
    rng = np.random.RandomState(15)
    prefix = rng.randint(1, 64, 8).tolist()
    reqs = []
    for i in range(8):
        p = prefix + rng.randint(1, 64, int(rng.randint(2, 12))).tolist()
        kw = {"deadline_s": 0.0} if i in (2, 5) else {}
        reqs.append(eng.submit(p, max_new_tokens=int(rng.randint(4, 16)),
                               **kw))
    steps = 0
    while not all(r.finished for r in reqs):
        if steps == 2:
            assert eng.cancel(reqs[3]) is True
        if steps == 6:
            eng.begin_drain(grace_s=600.0)
        eng.step()
        eng.check_invariants()
        steps += 1
        assert steps < 400, "chaos schedule wedged the engine"
    if not eng.draining:
        eng.begin_drain(grace_s=600.0)
        eng.step()
    assert eng.drained
    statuses = {r.status for r in reqs}
    assert statuses <= TERMINAL_STATUSES
    assert "expired" in statuses and "cancelled" in statuses
    assert eng.expired >= 2 and eng.cancelled == 1
    assert eng.preemptions >= 1
    assert eng.compile_count == base
    for r in reqs:
        if r.status == "done":
            _greedy_ok(jm, r)
    pg = eng._pager
    assert pg.free_blocks + pg.lru_blocks == pg.usable_blocks
    assert (pg._ref == 0).all()


# ------------------------------------------------------- parity with JAX


def _parity_run(eng, prompts):
    """Warm, then drive ``eng`` through the shared schedule under a clock
    that advances one second a step. Returns (requests, per-step terminal
    ids)."""
    eng.submit([1, 2, 3], max_new_tokens=2)
    eng.run()
    t_ref = time.time()
    k = [0]
    eng._clock = lambda: t_ref + float(k[0])
    reqs = []
    for i, (p, n) in enumerate(prompts):
        kw = {}
        if i == 1:
            kw["deadline_s"] = 0.0             # expires in the queue
        if i == 2:
            kw["deadline_s"] = 5.5             # expires mid-decode
        if i == 4:
            kw["ttft_deadline_s"] = 2.5        # met: admitted at once
        if i == 6:
            kw["ttft_deadline_s"] = 3.5        # expires requeued
        reqs.append(eng.submit(p, max_new_tokens=n, request_id=f"p{i}",
                               **kw))
    log = []
    while not all(r.finished for r in reqs):
        if k[0] == 3:
            assert eng.cancel("p5") is True    # mid-decode
        if k[0] == 9:
            eng.begin_drain(grace_s=30.0)      # bounces the queue
        log.append(sorted(str(r.id) for r in eng.step()))
        k[0] += 1
        assert k[0] < 300
    return reqs, log


def test_guardrail_parity_with_jax(models):
    """The same tiny weights, requests, PADDLE_SERVE_FAULT schedule,
    cancel, drain and clock on the JAX engine and on the port's: the same
    status, error and tokens per request, the same step at which each
    ended, and the same expired / cancelled / preemptions / drains
    counters. Prompts fit one chunk, so no slot is mid-prefill at a decode
    step (where the JAX engine's decode writes through the slot's table)
    and the two engines' tokens agree exactly."""
    jm, tm = models
    rng = np.random.RandomState(21)
    prompts = [(rng.randint(1, 64, int(rng.randint(3, 9))).tolist(),
                int(rng.randint(10, 22))) for _ in range(8)]
    spec = ("raise@admit:5,raise@alloc:9,raise@alloc:14,"
            "slow@decode:3:0.001,slow@chunk:2:0.001")
    jeng = JaxDecodeEngine(jm, kv_blocks=9,
                           fault_schedule=JaxFaultSchedule.parse(spec),
                           **GEOM)
    teng = DecodeEngine(tm, kv_blocks=9,
                        fault_schedule=FaultSchedule.parse(spec), **GEOM)
    jreqs, jlog = _parity_run(jeng, prompts)
    treqs, tlog = _parity_run(teng, prompts)
    assert tlog == jlog
    for jr, tr in zip(jreqs, treqs):
        assert (tr.status, tr.error) == (jr.status, jr.error), tr.id
        assert list(tr.tokens) == list(jr.tokens), tr.id
        assert tr.preemptions == jr.preemptions, tr.id
        if tr.status == "done":
            _greedy_ok(jm, tr)
    statuses = {r.status for r in treqs}
    assert statuses == {"done", "expired", "cancelled", "failed",
                        "rejected_draining"}
    jg, tg = jeng.stats()["guardrails"], teng.stats()["guardrails"]
    for key in ("expired", "cancelled", "drains"):
        assert tg[key] == jg[key], key
    assert teng.preemptions == jeng.preemptions >= 1
    for site in ("admit", "alloc", "decode", "chunk"):
        assert teng._faults.fired(site) == jeng._faults.fired(site), site
    jeng.close()
    teng.close()


# -------------------------------------------------------------- telemetry


def test_monitor_guardrail_counters(models, tmp_path):
    path = str(tmp_path / "guard.jsonl")
    tmon.enable(path)
    eng = DecodeEngine(models[1], max_slots=2, max_len=32, block_size=8,
                       prefill_chunk=8)
    try:
        live = eng.submit([1, 2, 3], max_new_tokens=6)
        gone = eng.submit([4, 5, 6], max_new_tokens=6, deadline_s=0.0)
        vict = eng.submit([7, 8, 9], max_new_tokens=6)
        eng.step()
        assert gone.status == "expired"
        eng.cancel(vict)
        eng.drain(grace_s=60.0)
        assert live.status == "done"
        c = tmon.snapshot()["counters"]
        assert c["serve/expired"] == 1 and c["serve/cancelled"] == 1
        assert c["serve/drained"] == 1
        tmon.get().flush()
        kinds = [json.loads(l).get("kind") for l in open(path)]
        for k in ("serve_expire", "serve_cancel", "serve_drain_begin",
                  "serve_drain_end"):
            assert k in kinds, k
    finally:
        tmon.disable()


def test_trace_phases_for_guardrail_terminals(models, tmp_path):
    from paddle_tpu_torch.monitor import trace
    t = trace.enable(str(tmp_path / "t.jsonl"), sample=1.0)
    eng = DecodeEngine(models[1], max_slots=2, max_len=32, block_size=8,
                       prefill_chunk=8)
    try:
        gone = eng.submit([1, 2, 3], max_new_tokens=4, deadline_s=0.0)
        vict = eng.submit([4, 5, 6], max_new_tokens=20)
        eng.step()
        assert gone.status == "expired"
        eng.cancel(vict)
        eng.run()
        t.flush()
        recs = [json.loads(l) for l in open(t.path)]
    finally:
        trace.disable()
    ends = {r["attrs"]["request"]: r for r in recs
            if r.get("kind") == "trace" and r.get("attrs", {}).get("status")
            in ("expired", "cancelled")}
    assert ends[gone.id]["attrs"]["status"] == "expired"
    assert ends[vict.id]["attrs"]["status"] == "cancelled"
    spans = [r for r in recs if r.get("kind") == "span"
             and r["trace"] == ends[vict.id]["trace"] and r["span"] != 0]
    assert spans and all(sp["dur_s"] >= 0 for sp in spans)
    root = next(r for r in recs if r.get("kind") == "span"
                and r["trace"] == ends[vict.id]["trace"] and r["span"] == 0)
    assert max(sp["ts"] + sp["dur_s"] for sp in spans) \
        <= root["ts"] + root["dur_s"] + 1e-6


def test_speculative_fault_sites(models):
    """``raise@spec_reserve`` degrades one step to a plain one-token
    verify (the tokens stay greedy); ``raise@verify`` fails the engine
    loudly with every request failed, invariants held, and the engine
    serves again after."""
    from paddle_tpu_torch.serving import PromptLookupDrafter
    jm, tm = models
    prompt = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6]
    eng = DecodeEngine(tm, drafter=PromptLookupDrafter(),
                       fault_schedule=FaultSchedule.parse(
                           "raise@spec_reserve:1"), **GEOM)
    r = eng.submit(prompt, max_new_tokens=8)
    eng.run()
    assert r.status == "done" and eng._faults.fired("spec_reserve") >= 1
    _greedy_ok(jm, r)
    eng.check_invariants()
    eng = DecodeEngine(tm, drafter=PromptLookupDrafter(),
                       fault_schedule=FaultSchedule.parse("raise@verify:1"),
                       **GEOM)
    doomed = eng.submit(prompt, max_new_tokens=8)
    with pytest.raises(InjectedFault):
        eng.run()
    assert doomed.status == "failed" and "engine failed" in doomed.error
    eng.check_invariants()
    ok = eng.submit(prompt, max_new_tokens=8)
    eng.run()
    assert ok.status == "done"
    _greedy_ok(jm, ok)


def test_watchdog_sees_a_window_armed_while_it_idles():
    """A window armed while the watchdog thread idles (in its untimed
    wait, woken by ``arm``) is reported once it has lasted ``hang_s``,
    with its ``info``, and latched in ``fired`` until the next ``arm``."""
    fired = threading.Event()
    seen = []

    def on_hang(info, elapsed_s):
        seen.append((info["kind"], elapsed_s))
        fired.set()
    wd = guardrails.DispatchWatchdog(0.05, on_hang)
    try:
        time.sleep(0.01)                 # the thread is in its idle wait
        t0 = time.monotonic()
        wd.arm(kind="decode", bucket=None)
        assert fired.wait(30.0)
        wd.disarm()
        assert seen[0][0] == "decode" and seen[0][1] >= 0.05
        assert time.monotonic() - t0 >= 0.05
        assert wd.hangs == 1 and wd.fired["kind"] == "decode"
        wd.arm(kind="chunk", bucket=8)
        assert wd.fired is None
        wd.disarm()
    finally:
        wd.stop()
