"""The port's cross-process prefix tier (``serving/kvpool.py``, the block
codec of ``distributed/reshard/snapshot.py`` and the engine's pool path)
against the JAX package's, in fp32 on the CPU.

The cases of ``tests/test_kvpool.py`` run on the port: pool round trips
(``LocalPool``, ``KVPool`` over the port's own ``KVServer``), a cold
engine adopting a warm engine's exported prefix blocks with the no-pool
engine's tokens, the chaos sites (export, fetch, adopt), the generation
bump of ``drop_prefix_cache``, the restart-adopt drill under the router,
the router's admission queue and incremental streaming, and the
summary's pool section. Added: the codec in both directions between the
packages, bit for bit at bf16 and fp32, the two packages' ``KVPool`` on
one master, and a JAX engine's exported blocks adopted by the port's
engine (its K/V within 1e-5 of the port's own prefill, its greedy tokens
the JAX model's)."""
import io
import os
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.reshard import snapshot as jsnap
from paddle_tpu.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.serving import KVPool as JaxKVPool
from paddle_tpu.serving import LocalPool as JaxLocalPool
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.distributed.launch.master import KVClient, KVServer
from paddle_tpu_torch.distributed.reshard import snapshot as tsnap
from paddle_tpu_torch.serving import (DecodeEngine, DoorServer,
                                      EngineEndpoint, FaultSchedule, KVPool,
                                      LocalDirectory, LocalEngineClient,
                                      LocalPool, RouteFaultSchedule, Router,
                                      prefix_digest, resolve_kv_pool)

from test_torch_serving import _model_pair, greedy_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_FAULTS = RouteFaultSchedule.parse("")

SHARED = [int(t) for t in np.random.RandomState(0).randint(1, 64, 16)] \
    + [40, 50, 60]                       # 2 full blocks + a 3-token tail


@pytest.fixture(scope="module")
def models():
    return _model_pair(seed=13)


@pytest.fixture(scope="module")
def master():
    srv = KVServer(0, host="127.0.0.1")
    srv.start()
    yield srv
    srv.stop()


def _mk_engine(model, pool=None, faults=None):
    return DecodeEngine(model, max_slots=2, max_len=48, block_size=8,
                        prefill_chunk=8, kv_pool=pool, fault_schedule=faults)


def _serve(eng, prompt=SHARED, n=4):
    r = eng.submit(prompt, max_new_tokens=n)
    eng.run()
    assert r.status == "done", r.error
    eng.check_invariants()
    return r


# ------------------------------------------------------------------ codec


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_block_codec_crosses_packages_bit_for_bit(dtype):
    rs = np.random.RandomState(1)
    a = rs.normal(size=(2, 2, 8, 2, 16)).astype(np.float32)
    if dtype == "bfloat16":
        a[0, 0, 0, 0, :4] = [np.inf, -np.inf, np.nan, -0.0]
        ja = a.astype(ml_dtypes.bfloat16)
        # the same bits on both sides (the two libraries round a NaN to
        # different bf16 payloads, which is not the codec's business)
        ta = torch.from_numpy(ja.view(np.int16).copy()).view(torch.bfloat16)
        bits = lambda t: t.view(torch.int16).numpy()
        jbits = lambda x: x.view(np.int16)
    else:
        ja, ta = a, torch.from_numpy(a.copy())
        bits = lambda t: t.view(torch.int32).numpy()
        jbits = lambda x: x.view(np.int32)
    # JAX -> port
    payload, meta = jsnap.encode_block(ja)
    assert meta == {"shape": [2, 2, 8, 2, 16], "dtype": dtype}
    got = tsnap.decode_block(payload, meta)
    assert got.dtype == ta.dtype and tuple(got.shape) == a.shape
    np.testing.assert_array_equal(bits(got), jbits(ja))
    # port -> JAX
    payload2, meta2 = tsnap.encode_block(ta)
    assert meta2 == meta and payload2 == payload
    back = jsnap.decode_block(payload2, meta2)
    np.testing.assert_array_equal(jbits(back), bits(ta))


def test_block_codec_rejects_bad_payloads():
    payload, meta = tsnap.encode_block(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="bytes"):
        tsnap.decode_block(payload[:-4], meta)
    with pytest.raises(ValueError, match="dtype"):
        tsnap.decode_block(payload, dict(meta, dtype="complex64x"))
    scalar = tsnap.decode_block(*tsnap.encode_block(torch.tensor(2.5)))
    assert scalar.shape == () and float(scalar) == 2.5
    # the decoded tensor owns its bytes
    buf = bytearray(payload)
    t = tsnap.decode_block(bytes(buf), meta)
    t += 1
    assert tsnap.decode_block(bytes(buf), meta).sum() == 0


# ----------------------------------------------------------- pool round trips


def test_localpool_roundtrip_capacity_and_generation():
    p = LocalPool(capacity=2)
    assert p.generation() == 0 and len(p) == 0
    assert p.put("a", b"xx", {"tokens": 8})
    assert p.put("b", b"yy", {"tokens": 16})
    data, meta = p.get("a")
    assert data == b"xx" and meta["tokens"] == 8
    assert p.put("c", b"zz", {})
    assert len(p) == 2 and p.get("b") is None and p.get("a") is not None
    assert p.bump_generation() == 1
    assert p.generation() == 1 and len(p) == 0 and p.get("a") is None
    assert p.counters["gen_bumps"] == 1 and p.counters["misses"] == 2


def test_kvpool_master_roundtrip_generation_and_torn_entry(master):
    client = KVClient(master.address, timeout=5.0)
    pool = KVPool(client, job="t-rt")
    assert pool.generation() == 0
    payload = np.arange(8, dtype=np.float32).tobytes()
    assert pool.put("d1", payload, {"tokens": 8, "gen": 0})
    got = pool.get("d1")
    assert got is not None and got[0] == payload and got[1]["tokens"] == 8
    pool2 = KVPool(KVClient(master.address, timeout=5.0), job="t-rt")
    assert pool2.get("d1")[0] == payload
    assert pool.bump_generation() == 1
    assert pool.get("d1") is None and pool2.generation() == 1
    client.put("/t-rt/kvpool/blk/1/torn", "not json {")
    assert pool.get("torn") is None


def test_kvpool_entries_cross_packages_on_one_master(master):
    """The JAX package's KVPool and the port's read each other's entries
    on the port's KVServer: same keys, envelope and generation."""
    from paddle_tpu.distributed.launch.master import KVClient as JaxKVClient
    jp = JaxKVPool(JaxKVClient(master.address, timeout=5.0), job="x")
    tp = KVPool(KVClient(master.address, timeout=5.0), job="x")
    assert jp.put("j", b"\x01\x02", {"tokens": 8})
    assert tp.get("j") == (b"\x01\x02", {"tokens": 8})
    assert tp.put("t", b"\x03", {"tokens": 16})
    assert jp.get("t") == (b"\x03", {"tokens": 16})
    assert tp.bump_generation() == jp.generation() == 1
    assert jp.get("t") is None


def test_resolve_kv_pool_by_env(monkeypatch, master):
    monkeypatch.delenv("PADDLE_SERVE_MASTER", raising=False)
    monkeypatch.delenv("PADDLE_CKPT_MASTER", raising=False)
    assert isinstance(resolve_kv_pool(), LocalPool)
    monkeypatch.setenv("PADDLE_CKPT_MASTER", master.address)
    assert isinstance(resolve_kv_pool(), KVPool)
    monkeypatch.setenv("PADDLE_SERVE_MASTER", master.address)
    pool = resolve_kv_pool(job="env")
    assert isinstance(pool, KVPool) and pool.generation() == 0


def test_kv_pool_requires_paged(models):
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(models[1], paged=False, kv_pool=LocalPool())


# -------------------------------------------------------- cold-start adoption


def test_cold_engine_adopts_from_pool(models, tmp_path):
    """Warm engine A exports its parked prefix blocks; cold engine B's
    first shared-prompt admission fetches and adopts them (one chunk of
    prefill instead of three), with the no-pool engine's tokens and the
    JAX model's greedy ones; a second identical prompt is served locally
    with no fetch and no program built."""
    jm, tm = models
    tmon.enable(str(tmp_path / "pool.jsonl"))
    try:
        shared_pool = LocalPool()
        ea = _mk_engine(tm, pool=shared_pool)
        ra = _serve(ea)
        assert ea.pool_stats()["exports"] == 2 and len(shared_pool) == 2
        eb = _mk_engine(tm, pool=shared_pool)
        assert not eb._pager._registry
        rb = _serve(eb)
        ps = eb.pool_stats()
        assert ps["fetch_hits"] == 2 and ps["adopted_blocks"] == 2
        assert ps["adopted_tokens"] == 16
        assert eb._pager.pool_hits == 1 and eb._pager.pool_hit_tokens == 16
        assert eb._pager.prefix_hits == 1
        assert rb.prefill_chunks == 1 and ra.prefill_chunks == 3
        ec = _mk_engine(tm)
        rc = _serve(ec)
        assert rc.output_tokens == rb.output_tokens == ra.output_tokens
        assert list(rb.output_tokens) == greedy_from(jm, rb)
        compiles, fetches = eb.compile_count, ps["fetches"]
        rb2 = _serve(eb)
        assert eb.compile_count == compiles
        assert eb.pool_stats()["fetches"] == fetches
        assert rb2.output_tokens == rb.output_tokens
        snap = tmon.snapshot()
        assert snap["gauges"]["pool/fetch_hits"] == 2
        assert snap["gauges"]["pool/adopted_tokens"] == 16
        assert snap["gauges"]["serve/pool_hits"] == 1
        assert eb.stats()["pool"]["adopted_blocks"] == 2
        door = eb.door_state()
        assert door["pool_gen"] == 0 and door["pool_hits"] == 1
    finally:
        tmon.disable()


def test_kv_pool_over_master_between_engines(models, master):
    """Two engines, each with its own KVPool client on the port's
    KVServer: the bytes cross the wire and the cold engine adopts."""
    jm, tm = models
    mk = lambda: KVPool(KVClient(master.address, timeout=5.0), job="eng")
    ea = _mk_engine(tm, pool=mk())
    _serve(ea)
    eb = _mk_engine(tm, pool=mk())
    rb = _serve(eb)
    assert eb.pool_stats()["adopted_blocks"] == 2
    assert list(rb.output_tokens) == greedy_from(jm, rb)


def test_jax_exported_blocks_adopt_in_the_port(models):
    """A JAX engine's exported blocks, moved entry for entry into the
    port's pool, adopt in the port's engine: the adopted K/V is within
    1e-5 of the port's own prefill of the same prompt and the tokens are
    the JAX model's greedy ones."""
    jm, tm = models
    jpool = JaxLocalPool()
    jeng = JaxDecodeEngine(jm, max_slots=2, max_len=48, block_size=8,
                           prefill_chunk=8, kv_pool=jpool)
    jeng.submit(SHARED, max_new_tokens=4)
    jeng.run()
    assert len(jpool) == 2
    tpool = LocalPool()
    for dig, (payload, meta) in jpool._entries.items():
        assert meta["geom"] == [2, 8, 2, 16] and meta["dtype"] == "float32"
        tpool.put(dig, payload, meta)
    eb = _mk_engine(tm, pool=tpool)
    rb = _serve(eb)
    assert eb.pool_stats()["adopted_blocks"] == 2
    assert list(rb.output_tokens) == greedy_from(jm, rb)
    # the adopted rows against the port's own prefill of the prompt
    ec = _mk_engine(tm)
    _serve(ec)
    for k in (1, 2):
        dig = prefix_digest(tuple(SHARED[:8 * k]))
        blk_b = eb._pager._registry[tuple(SHARED[:8 * k])]
        blk_c = ec._pager._registry[tuple(SHARED[:8 * k])]
        payload, meta = jpool._entries[dig]
        jrows = tsnap.decode_block(payload, meta)
        torch.testing.assert_close(eb._kv[:, :, blk_b], jrows,
                                   rtol=0, atol=0)
        torch.testing.assert_close(eb._kv[:, :, blk_b],
                                   ec._kv[:, :, blk_c], rtol=0, atol=1e-5)


def test_chaos_export_fetch_and_adopt_sites_degrade_cold(models):
    jm, tm = models
    shared_pool = LocalPool()
    ea = _mk_engine(tm, pool=shared_pool,
                    faults=FaultSchedule.parse("raise@export:1"))
    _serve(ea)
    ps = ea.pool_stats()
    assert ps["export_errors"] == 1 and ps["exports"] == 1
    assert len(shared_pool) == 1
    _serve(_mk_engine(tm, pool=shared_pool))
    assert len(shared_pool) == 2
    ctrl = _serve(_mk_engine(tm))
    for site in ("adopt", "fetch"):
        eb = _mk_engine(tm, pool=shared_pool,
                        faults=FaultSchedule.parse(f"raise@{site}:1"))
        rb = _serve(eb)
        assert eb.pool_stats()["adopted_blocks"] == 0, site
        assert eb._pager.pool_hits == 0
        assert rb.output_tokens == ctrl.output_tokens
        assert eb._faults.fired(site) == 1
    assert eb.pool_stats()["fetch_misses"] == 1


def test_drop_prefix_cache_bumps_pool_generation(models):
    jm, tm = models
    shared_pool = LocalPool()
    ea = _mk_engine(tm, pool=shared_pool)
    _serve(ea)
    assert len(shared_pool) == 2 and ea.pool_stats()["gen"] == 0
    assert ea.drop_prefix_cache() >= 2
    assert shared_pool.generation() == 1 and ea.pool_stats()["gen"] == 1
    assert len(shared_pool) == 0
    _serve(ea)
    assert len(shared_pool) == 2
    eb = _mk_engine(tm, pool=shared_pool)
    assert eb.pool_stats()["gen"] == 1
    _serve(eb)
    assert eb.pool_stats()["fetch_hits"] == 2
    # an engine still at the old generation misses every entry
    stale = _mk_engine(tm, pool=shared_pool)
    stale._pool_gen = 0
    _serve(stale)
    assert stale.pool_stats()["adopted_blocks"] == 0
    assert stale.pool_stats()["fetch_misses"] == 1


def test_other_geometry_is_a_miss(models):
    jm, tm = models
    shared_pool = LocalPool()
    _serve(DecodeEngine(tm, max_slots=2, max_len=48, block_size=8,
                        prefill_chunk=8, kv_pool=shared_pool))
    dig, (payload, meta) = next(iter(shared_pool._entries.items()))
    shared_pool.put(dig, payload, dict(meta, geom=[2, 8, 2, 8]))
    eb = _mk_engine(tm, pool=shared_pool)
    rb = _serve(eb)
    assert eb.pool_stats()["adopted_blocks"] == 0
    assert list(rb.output_tokens) == greedy_from(jm, rb)


# ------------------------------------------- restart-adopt under the router


def test_restart_adopt_under_router(models):
    jm, tm = models
    shared_pool = LocalPool()
    directory = LocalDirectory()
    engines, endpoints = {}, {}

    def make(name):
        eng = DecodeEngine(tm, max_slots=2, max_len=48, block_size=8,
                           prefill_chunk=8, kv_blocks=24,
                           kv_pool=shared_pool)
        engines[name] = eng
        endpoints[name] = EngineEndpoint(eng, name, directory, ttl_s=5.0)
        endpoints[name].publish()
        return eng

    router = Router(directory, fault_schedule=NO_FAULTS, stale_after=1e9)
    for n in ("eng0", "eng1"):
        make(n)
        router.attach(n, LocalEngineClient(engines[n]))

    def step():
        for n, eng in list(engines.items()):
            client = router._clients.get(n)
            if client is not None and getattr(client, "dead", False):
                continue
            eng.step()
            eng.check_invariants()
            endpoints[n].publish()

    expect = _serve(_mk_engine(tm)).output_tokens
    t1 = router.route(SHARED, max_new_tokens=4)
    router.join([t1], step=step, timeout_s=60)
    assert t1.status == "done" and t1.tokens == list(expect)
    victim = t1.engine
    survivor = next(n for n in engines if n != victim)
    while len(shared_pool) < 2:
        step()
    mid = [router.route(SHARED, max_new_tokens=6, request_id=f"mw-{i}")
           for i in range(2)]
    router._clients[victim].kill()
    router.join(mid, step=step, timeout_s=90)
    assert all(t.status == "done" for t in mid)
    endpoints[victim].deregister()
    replacement = make(victim)
    router.attach(victim, LocalEngineClient(replacement))
    engines[survivor].begin_drain(grace_s=10.0)
    endpoints[survivor].publish()
    assert not replacement._pager._registry
    t2 = router.route(SHARED, max_new_tokens=4)
    router.join([t2], step=step, timeout_s=90)
    assert t2.status == "done" and t2.engine == victim
    ps = replacement.pool_stats()
    assert ps["fetch_hits"] >= 2 and ps["adopted_blocks"] >= 2, ps
    assert replacement._pager.pool_hits >= 1
    assert t2.tokens == list(expect)
    view = router.fleet_view()
    assert view["doors"][victim]["pool_gen"] == 0
    assert view["doors"][victim]["pool_hits"] >= 1


# ------------------------------------------------- router admission queue


class _BouncyClient:
    """Door double that bounces submits as rejected_overload while
    ``bounce`` is set."""

    def __init__(self):
        self.dead = False
        self.bounce = True
        self.requests = {}

    def submit(self, prompt, max_new_tokens, eos_token_id, request_id):
        rid = str(request_id)
        if self.bounce:
            return {"id": rid, "status": "rejected_overload",
                    "error": "admission queue full", "tokens": []}
        view = {"id": rid, "status": "queued", "error": None, "tokens": []}
        self.requests[rid] = view
        return dict(view)

    def status(self, request_id, since=None):
        v = self.requests.get(str(request_id))
        return dict(v) if v is not None else None

    def door(self):
        return {}

    def begin_drain(self, grace_s=None):
        pass

    def kill(self):
        self.dead = True


def _queue_fleet(clock, **router_kw):
    d = LocalDirectory()
    for n in ("a", "b"):
        d.put(n, {"name": n, "inc": {"gen": 0, "start": 1.0, "token": "t"},
                  "seq": 1, "ts": 0.0, "ttl_s": 3.0, "addr": None,
                  "door": {"state": "accepting", "free_slots": 0,
                           "queue_depth": 4, "active": 2, "free_blocks": 0,
                           "block_size": 8, "prefix_keys": [],
                           "prefix_hits": 0}})
    clients = {n: _BouncyClient() for n in ("a", "b")}
    r = Router(d, clock=clock, fault_schedule=NO_FAULTS, stale_after=1e9,
               **router_kw)
    for n, c in clients.items():
        r.attach(n, c)
    return clients, r


def test_router_queues_when_all_doors_at_capacity(tmp_path):
    tmon.enable(str(tmp_path / "q.jsonl"))
    try:
        now = [1000.0]
        clients, r = _queue_fleet(lambda: now[0], max_queue=4,
                                  queue_deadline_s=30.0)
        t = r.route([1, 2, 3], max_new_tokens=4)
        assert t.status == "queued_router" and not t.finished
        assert r.counters["queued"] == 1 and r.counters["rejected"] == 0
        r.poll()
        assert t.status == "queued_router" and r.counters["queued"] == 1
        for c in clients.values():
            c.bounce = False
        r.poll()
        assert t.engine in ("a", "b") and t.status == "queued"
        assert tmon.snapshot()["counters"]["route/queued"] == 1
    finally:
        tmon.disable()


def test_router_queue_deadline_and_overflow():
    now = [1000.0]
    clients, r = _queue_fleet(lambda: now[0], max_queue=1,
                              queue_deadline_s=5.0)
    t1 = r.route([1, 2, 3], max_new_tokens=4)
    assert t1.status == "queued_router"
    t2 = r.route([4, 5, 6], max_new_tokens=4)
    assert t2.status == "rejected" and r.counters["rejected"] == 1
    now[0] += 6.0
    r.poll()
    assert t1.status == "expired" and "deadline" in t1.error
    assert r.counters["queue_expired"] == 1
    r2 = Router(LocalDirectory(), fault_schedule=NO_FAULTS, max_queue=4)
    assert r2.route([1, 2, 3], max_new_tokens=4).status == "rejected"


# ------------------------------------------------ incremental streaming


def _fake_req(tokens, status="running"):
    return types.SimpleNamespace(id="r1", status=status, error=None,
                                 tokens=list(tokens))


def test_door_status_since_cursor(models):
    door = DoorServer(_mk_engine(models[1]))
    door.start()
    try:
        door._requests["r1"] = _fake_req([10, 11, 12, 13])
        full = door._status("r1")
        assert full["tokens"] == [10, 11, 12, 13] and "since" not in full
        inc = door._status("r1", since=2)
        assert inc["tokens"] == [12, 13] and inc["since"] == 2 \
            and inc["n_tokens"] == 4
        assert door._status("r1", since=99) == dict(
            id="r1", status="running", error=None, tokens=[], since=4,
            n_tokens=4)
        door._requests["r1"] = _fake_req([10])
        clamped = door._status("r1", since=3)
        assert clamped["since"] == 1 and clamped["tokens"] == []
        assert door._status("nope")["error_code"] == "unknown_request"
    finally:
        door.stop()


def test_router_poll_reconstructs_incremental_stream():
    d = LocalDirectory()
    d.put("a", {"name": "a", "inc": {"gen": 0, "start": 1.0, "token": "t"},
                "seq": 1, "ts": 0.0, "ttl_s": 3.0, "addr": None,
                "door": {"state": "accepting", "free_slots": 2,
                         "queue_depth": 0, "active": 0, "free_blocks": 8,
                         "block_size": 8, "prefix_keys": [],
                         "prefix_hits": 0}})
    r = Router(d, fault_schedule=NO_FAULTS, stale_after=1e9)

    class IncClient(_BouncyClient):
        def __init__(self):
            super().__init__()
            self.bounce = False
            self.since_seen = []
            self.view = {"id": "", "status": "running", "error": None,
                         "tokens": []}

        def submit(self, prompt, max_new_tokens, eos_token_id, request_id):
            self.view["id"] = str(request_id)
            return dict(self.view, tokens=[])

        def status(self, request_id, since=None):
            self.since_seen.append(since)
            toks = self.view["tokens"]
            eff = min(max(0, int(since or 0)), len(toks))
            return dict(self.view, tokens=toks[eff:], since=eff,
                        n_tokens=len(toks))

    c = IncClient()
    r.attach("a", c)
    t = r.route([1, 2, 3], max_new_tokens=8)
    c.view["tokens"] = [10, 11]
    r.poll()
    assert t.tokens == [10, 11] and c.since_seen[-1] == 0
    c.view["tokens"] = [10, 11, 12]
    r.poll()
    assert t.tokens == [10, 11, 12] and c.since_seen[-1] == 2
    c.view["tokens"] = [10]
    r.poll()
    assert t.tokens == [10]
    c.view["tokens"] = [10, 21, 22]
    c.view["status"] = "done"
    r.poll()
    assert t.tokens == [10, 21, 22] and t.status == "done"


# ------------------------------------------------------ metrics_summary


def _load_metrics_summary():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "metrics_summary", os.path.join(REPO, "tools", "metrics_summary.py"))
    ms = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ms)
    return ms


def test_summary_kv_pool_section_from_port_records(models, tmp_path):
    """The port engine's own ``pool/*`` gauges render the summary's kv
    pool line with no cold-start WARN."""
    tm = models[1]
    path = str(tmp_path / "run.jsonl")
    tmon.enable(path)
    try:
        shared_pool = LocalPool()
        _serve(_mk_engine(tm, pool=shared_pool))
        _serve(_mk_engine(tm, pool=shared_pool))
    finally:
        tmon.disable()
    out = io.StringIO()
    assert _load_metrics_summary().summarize([path], out=out) == 0
    text = out.getvalue()
    assert "kv pool: gen 0" in text
    assert "adopted 2 blocks / 16 tokens" in text
    assert "cold-start-never-adopts" not in text
