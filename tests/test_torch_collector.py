"""The port's fleet telemetry plane (``monitor/collector.py``) against
the JAX package's, on the CPU.

The cases of ``tests/test_fleet_collector.py`` run on the port's
collector, registry, sink and monitor: delta publishing, the fold into
``run.fleet.jsonl``, the straggler / liveness / divergence / weight-digest
checks, incarnation restarts, the KV transport over the port's own
``KVServer``, ``monitor.enable(fleet=)`` and ``monitor.fleet_state()``,
and the ``tools/`` renderers. ``test_aggregators_agree_with_jax`` feeds
the same published blobs to both packages' aggregators and asks for equal
fleet records."""
import io
import json
import os
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from paddle_tpu.monitor.collector import Aggregator as JaxAggregator  # noqa
from paddle_tpu_torch import monitor  # noqa: E402
from paddle_tpu_torch.distributed.launch.master import KVServer  # noqa
from paddle_tpu_torch.monitor import collector  # noqa: E402
from paddle_tpu_torch.monitor.collector import (  # noqa: E402
    Aggregator, KVTransport, LocalTransport, Publisher,
    FLEET_SCHEMA_VERSION)
from paddle_tpu_torch.monitor.registry import Registry  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_plane():
    yield
    collector.stop()
    collector._pending_elastic = None
    monitor.disable()


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _mk_rank(transport, rank, interval=0.1):
    reg = Registry()
    return reg, Publisher(reg, transport, rank, interval=interval)


def _steps(reg, n, dur):
    for _ in range(n):
        reg.counter("train_step/steps").inc()
        reg.histogram("train_step/dispatch_s").observe(dur)


# ------------------------------------------------------------ delta encoding


def test_registry_delta_snapshot():
    reg = Registry()
    reg.counter("a").inc(3)
    reg.gauge("g").set(7)
    reg.histogram("h").observe(0.5)
    s1 = reg.snapshot()
    assert Registry.delta(None, s1) is s1  # first publish is full
    # nothing changed -> empty delta
    d = Registry.delta(s1, reg.snapshot())
    assert d == {"counters": {}, "gauges": {}, "histograms": {}}
    # only the touched metrics re-send, values stay CUMULATIVE
    reg.counter("a").inc(2)
    reg.counter("b").inc()
    d = Registry.delta(s1, reg.snapshot())
    assert d["counters"] == {"a": 5, "b": 1}
    assert d["gauges"] == {} and d["histograms"] == {}
    # histogram deltas key on observation count
    reg.histogram("h").observe(0.1)
    d = Registry.delta(s1, reg.snapshot())
    assert d["histograms"]["h"]["count"] == 2


def test_histogram_snapshot_has_p95():
    reg = Registry()
    h = reg.histogram("h")
    for v in (1e-4, 1e-3, 0.5):
        h.observe(v)
    s = h.snapshot()
    assert s["p50"] <= s["p95"] <= s["p99"]


# -------------------------------------------------------- fold + fleet stream


def test_local_aggregation_sum_min_max_per_rank(tmp_path):
    t = LocalTransport()
    fleet = str(tmp_path / "run.fleet.jsonl")
    r0, p0 = _mk_rank(t, 0)
    r1, p1 = _mk_rank(t, 1)
    agg = Aggregator(t, world=2, fleet_path=fleet, interval=0.1)
    _steps(r0, 5, 0.01)
    _steps(r1, 7, 0.01)
    r0.gauge("shard/world_size").set(2)
    r1.gauge("shard/world_size").set(2)
    assert p0.publish_once() and p1.publish_once()
    rec = agg.poll_once()
    assert rec["ranks"] == [0, 1] and rec["stale"] == []
    c = rec["metrics"]["counters"]["train_step/steps"]
    assert c == {"sum": 12, "min": 5, "max": 7,
                 "per_rank": {"0": 5, "1": 7}}
    g = rec["metrics"]["gauges"]["shard/world_size"]
    assert g["max"] == 2 and set(g["per_rank"]) == {"0", "1"}
    h = rec["metrics"]["histograms"]["train_step/dispatch_s"]
    assert h["count"] == 12 and "0" in h["per_rank"]
    assert h["p95"] >= h["p50"] > 0
    agg.stop(final=False)
    recs = _read_jsonl(fleet)
    assert recs[0]["kind"] == "fleet_meta"
    assert all(r["v"] == FLEET_SCHEMA_VERSION for r in recs)
    assert any(r["kind"] == "fleet" for r in recs)


def test_fleet_sink_never_gains_proc_suffix(tmp_path, monkeypatch):
    """The fleet stream is rank 0's single-writer file: the launcher env
    contract must NOT reroute it to .proc0 (one stream, one path, one
    dashboard tail)."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    fleet = str(tmp_path / "run.fleet.jsonl")
    agg = Aggregator(LocalTransport(), world=4, fleet_path=fleet,
                     interval=0.1)
    agg.stop(final=False)
    assert os.path.exists(fleet)
    assert not os.path.exists(str(tmp_path / "run.fleet.proc0.jsonl"))


def test_delta_publish_only_resends_changes(tmp_path):
    t = LocalTransport()
    r0, p0 = _mk_rank(t, 0)
    _steps(r0, 3, 0.01)
    p0.publish_once()
    slots = t.fetch_all()[0]
    first = json.loads(slots["delta"])
    assert first["full"] and "train_step/steps" in first["counters"]
    # the full also lands in its own slot (the aggregator's recovery anchor)
    assert json.loads(slots["full"])["seq"] == first["seq"]
    # untouched window -> near-empty delta blob (the compact steady-state
    # wire; only the publisher's own fleet/publish_s self-measurement moves)
    p0.publish_once()
    idle = json.loads(t.fetch_all()[0]["delta"])
    assert not idle["full"] and idle["base"] == first["seq"]
    assert idle["counters"] == {} and idle["gauges"] == {}
    assert set(idle["hists"]) <= {"fleet/publish_s"}
    # a LATE-joining aggregator (or one that missed intermediate blobs)
    # reconstructs EXACT state from the full slot + the latest delta: the
    # settled counters survive even though the delta omits them
    agg = Aggregator(t, world=1, fleet_path=None, interval=0.1)
    rec = agg.poll_once()
    assert rec["metrics"]["counters"]["train_step/steps"]["sum"] == 3


# ------------------------------------------------------- straggler detection


def test_straggler_warn_names_slow_rank(tmp_path):
    t = LocalTransport()
    fleet = str(tmp_path / "run.fleet.jsonl")
    r0, p0 = _mk_rank(t, 0)
    r1, p1 = _mk_rank(t, 1)
    agg = Aggregator(t, world=2, fleet_path=fleet, interval=0.1,
                     skew_warn=2.0)
    _steps(r0, 10, 0.01)
    _steps(r1, 10, 0.05)  # 5x slower: the deliberate straggler
    p0.publish_once(), p1.publish_once()
    rec = agg.poll_once()
    assert rec["derived"]["fleet/step_skew"] == pytest.approx(5.0, rel=0.01)
    assert rec["derived"]["fleet/slowest_rank"] == 1
    warns = [r for r in _read_jsonl(fleet) if r["kind"] == "fleet_warn"]
    assert len(warns) == 1 and warns[0]["warn"] == "straggler"
    assert warns[0]["rank"] == 1 and "rank 1" in warns[0]["msg"]
    # a PERSISTING breach is one episode, not one warn per poll
    _steps(r0, 10, 0.01)
    _steps(r1, 10, 0.05)
    p0.publish_once(), p1.publish_once()
    agg.poll_once()
    warns = [r for r in _read_jsonl(fleet) if r["kind"] == "fleet_warn"]
    assert len(warns) == 1
    # recovery re-arms: a later breach warns again
    _steps(r0, 10, 0.01)
    _steps(r1, 10, 0.01)
    p0.publish_once(), p1.publish_once()
    rec = agg.poll_once()
    assert rec["derived"]["fleet/step_skew"] == pytest.approx(1.0, rel=0.05)
    _steps(r0, 10, 0.01)
    _steps(r1, 10, 0.05)
    p0.publish_once(), p1.publish_once()
    agg.poll_once()
    warns = [r for r in _read_jsonl(fleet) if r["kind"] == "fleet_warn"]
    assert len(warns) == 2
    agg.stop(final=False)


def test_single_active_rank_no_skew(tmp_path):
    """One rank stepping alone (others idle) must not divide by silence."""
    t = LocalTransport()
    r0, p0 = _mk_rank(t, 0)
    r1, p1 = _mk_rank(t, 1)
    agg = Aggregator(t, world=2, fleet_path=None, interval=0.1)
    _steps(r0, 5, 0.01)
    p0.publish_once(), p1.publish_once()
    rec = agg.poll_once()
    assert rec["derived"]["fleet/step_skew"] == 1.0
    assert "fleet/slowest_rank" not in rec["derived"]


# ------------------------------------------------------ liveness/incarnation


def test_stale_rank_detection_and_incarnation_restart(tmp_path):
    """Satellite: publisher death -> stale gauge + WARN within the stale
    window, without wedging the aggregator; a restarted publisher (new
    incarnation) resumes cleanly and the dead incarnation's late blob is
    rejected."""
    t = LocalTransport()
    fleet = str(tmp_path / "run.fleet.jsonl")
    r0, p0 = _mk_rank(t, 0)
    r1, p1 = _mk_rank(t, 1)
    agg = Aggregator(t, world=2, fleet_path=fleet, interval=0.1,
                     stale_after=0.2)
    _steps(r0, 3, 0.01)
    _steps(r1, 3, 0.01)
    p0.publish_once(), p1.publish_once()
    dead_blob = t.fetch_all()[1]["delta"]  # the incarnation about to "die"
    rec = agg.poll_once()
    assert rec["derived"]["fleet/ranks_stale"] == 0

    # rank 1 dies (publishes nothing); rank 0 keeps beating
    time.sleep(0.25)
    _steps(r0, 3, 0.01)
    p0.publish_once()
    rec = agg.poll_once()
    assert rec["derived"]["fleet/ranks_stale"] == 1
    assert rec["stale"] == [1] and rec["live"] == [0]
    warns = [r for r in _read_jsonl(fleet) if r["kind"] == "fleet_warn"]
    assert [w for w in warns if w["warn"] == "stale" and w["rank"] == 1]

    # restart: NEW incarnation (same rank, higher start / generation)
    r1b = Registry()
    p1b = Publisher(r1b, t, 1, interval=0.1, generation=1)
    _steps(r1b, 2, 0.01)
    p1b.publish_once()
    rec = agg.poll_once()
    assert rec["derived"]["fleet/ranks_stale"] == 0
    # cumulative counters RESET with the incarnation (2, not 3+2)
    assert rec["metrics"]["counters"]["train_step/steps"][
        "per_rank"]["1"] == 2

    # the dead incarnation's late blob must not regress the revived state
    t.publish(1, dead_blob)
    rec = agg.poll_once()
    assert rec["metrics"]["counters"]["train_step/steps"][
        "per_rank"]["1"] == 2
    agg.stop(final=False)


def test_never_heard_rank_counts_stale_after_grace(tmp_path):
    """A rank killed before its FIRST publish still shows up stale (the
    aggregator knows the expected world size)."""
    t = LocalTransport()
    r0, p0 = _mk_rank(t, 0)
    agg = Aggregator(t, world=2, fleet_path=None, interval=0.05,
                     stale_after=0.1)
    p0.publish_once()
    rec = agg.poll_once()
    assert rec["derived"]["fleet/ranks_stale"] == 0  # inside the grace
    time.sleep(0.12)
    p0.publish_once()
    rec = agg.poll_once()
    assert rec["stale"] == [1]


def test_seq_replay_ignored():
    t = LocalTransport()
    r0, p0 = _mk_rank(t, 0)
    agg = Aggregator(t, world=1, fleet_path=None, interval=0.1)
    _steps(r0, 4, 0.01)
    p0.publish_once()
    blob = t.fetch_all()[0]["delta"]
    agg.poll_once()
    _steps(r0, 4, 0.01)
    p0.publish_once()
    assert agg.poll_once()["metrics"]["counters"][
        "train_step/steps"]["sum"] == 8
    t.publish(0, blob)  # transport replays the older blob
    assert agg.poll_once()["metrics"]["counters"][
        "train_step/steps"]["sum"] == 8


# ------------------------------------------------------ divergence tripwires


def test_divergence_tripwire_flags_lone_rank(tmp_path):
    t = LocalTransport()
    fleet = str(tmp_path / "run.fleet.jsonl")
    r0, p0 = _mk_rank(t, 0)
    r1, p1 = _mk_rank(t, 1)
    agg = Aggregator(t, world=2, fleet_path=fleet, interval=0.1)

    def divergence_warns():
        return [r for r in _read_jsonl(fleet)
                if r["kind"] == "fleet_warn" and r["warn"] == "divergence"]

    # fleet-wide startup compile, but rank 1's blob arrives one poll LATE
    # (publish windows are not synchronized): a one-poll lead must not warn
    _steps(r0, 2, 0.01)
    _steps(r1, 2, 0.01)
    r0.counter("train_step/recompiles").inc()
    r1.counter("train_step/recompiles").inc()
    p0.publish_once()
    agg.poll_once()
    p1.publish_once()
    agg.poll_once()
    agg.poll_once()
    assert not divergence_warns()
    # rank 1 recompiles ALONE and stays ahead -> the one-rank signature
    # fires on the second consecutive poll, naming rank and counter
    r1.counter("train_step/recompiles").inc()
    p0.publish_once(), p1.publish_once()
    agg.poll_once()
    assert not divergence_warns()  # one poll ahead: could be publish lag
    agg.poll_once()
    warns = divergence_warns()
    assert len(warns) == 1 and warns[0]["rank"] == 1
    assert warns[0]["counter"] == "train_step/recompiles"
    # still ahead on later polls: the episode already warned, no spam
    agg.poll_once()
    assert len(divergence_warns()) == 1
    agg.stop(final=False)


def test_weight_divergence_digest_flags_forked_rank(tmp_path):
    """The health plane's cross-rank channel: a rank whose weight DIGEST
    disagrees with every sibling at the newest shared digest step is
    flagged (two-poll streak, warn once, named rank + derived gauges),
    and the flag clears when the digests re-agree."""
    t = LocalTransport()
    fleet = str(tmp_path / "run.fleet.jsonl")
    r0, p0 = _mk_rank(t, 0)
    r1, p1 = _mk_rank(t, 1)
    agg = Aggregator(t, world=2, fleet_path=fleet, interval=0.1)

    def set_digest(reg, step, v0, v1):
        reg.gauge("health/digest_step").set(step)
        reg.gauge("health/digest/p0").set(v0)
        reg.gauge("health/digest/p1").set(v1)

    def div_warns():
        return [r for r in _read_jsonl(fleet)
                if r["kind"] == "fleet_warn"
                and r["warn"] == "weight_divergence"]

    def publish_poll():
        _steps(r0, 1, 0.01), _steps(r1, 1, 0.01)
        p0.publish_once(), p1.publish_once()
        return agg.poll_once()

    # agreement: bitwise-equal digests at the same step -> no flag
    set_digest(r0, 10, 1.25, -3.5)
    set_digest(r1, 10, 1.25, -3.5)
    rec = publish_poll()
    assert rec["derived"]["fleet/weight_divergence"] == 0.0
    assert "fleet/weight_diverged_rank" not in rec["derived"]

    # rank 1's weights fork at step 20 (beyond the relative tolerance);
    # one poll of disagreement could be a torn read -> no warn yet
    set_digest(r0, 20, 2.0, -1.0)
    set_digest(r1, 20, 2.1, -1.0)
    rec = publish_poll()
    assert not div_warns()
    assert rec["derived"]["fleet/weight_divergence"] == 0.0
    # second consecutive poll: forked for real -> warn names the rank
    rec = publish_poll()
    warns = div_warns()
    assert len(warns) == 1 and warns[0]["rank"] == 1
    assert warns[0]["step"] == 20
    assert "WEIGHTS" in warns[0]["msg"]
    assert rec["derived"]["fleet/weight_divergence"] == 1.0
    assert rec["derived"]["fleet/weight_diverged_rank"] == 1
    # episode already warned: later polls do not spam
    rec = publish_poll()
    assert len(div_warns()) == 1

    # recovery: the rank is restored, digests re-agree -> flag clears
    set_digest(r0, 30, 4.0, 2.0)
    set_digest(r1, 30, 4.0, 2.0)
    rec = publish_poll()
    assert rec["derived"]["fleet/weight_divergence"] == 0.0
    assert "fleet/weight_diverged_rank" not in rec["derived"]
    assert len(div_warns()) == 1
    agg.stop(final=False)


def test_weight_divergence_within_tolerance_silent(tmp_path):
    """Sub-tolerance digest wobble (fp reduction-order noise between
    otherwise-identical ranks) must NOT flag."""
    t = LocalTransport()
    r0, p0 = _mk_rank(t, 0)
    r1, p1 = _mk_rank(t, 1)
    agg = Aggregator(t, world=2, fleet_path=None, interval=0.1)
    for reg, v in ((r0, 100.0), (r1, 100.0 + 100.0 * 1e-6)):
        reg.gauge("health/digest_step").set(5)
        reg.gauge("health/digest/p0").set(v)
    for _ in range(3):
        _steps(r0, 1, 0.01), _steps(r1, 1, 0.01)
        p0.publish_once(), p1.publish_once()
        rec = agg.poll_once()
        assert rec["derived"]["fleet/weight_divergence"] == 0.0
    agg.stop(final=False)


# --------------------------------------------------------- elastic crosscheck


class _FakeElastic:
    def __init__(self, n):
        self.n = n

    def peers(self):
        return [f"host:{i}" for i in range(self.n)]


def test_elastic_membership_crosscheck(tmp_path):
    """The ElasticManager's peer view and the telemetry liveness view are
    cross-checked every poll; a PERSISTING disagreement warns (one poll of
    lag is normal — the two planes sample at different instants)."""
    t = LocalTransport()
    fleet = str(tmp_path / "run.fleet.jsonl")
    r0, p0 = _mk_rank(t, 0)
    r1, p1 = _mk_rank(t, 1)
    agg = Aggregator(t, world=2, fleet_path=fleet, interval=0.1)
    mgr = _FakeElastic(2)
    agg.attach_elastic(mgr)
    p0.publish_once(), p1.publish_once()
    rec = agg.poll_once()
    assert rec["derived"]["fleet/elastic_peers"] == 2
    warns = lambda: [r for r in _read_jsonl(fleet)  # noqa: E731
                     if r.get("warn") == "membership_disagree"]
    assert not warns()
    mgr.n = 1  # elastic lost a peer telemetry still sees
    agg.poll_once()
    assert not warns()  # first disagreement poll: could be sampling lag
    agg.poll_once()
    assert len(warns()) == 1
    w = warns()[0]
    assert w["elastic_peers"] == 1 and w["telemetry_live"] == 2
    agg.stop(final=False)


def test_attach_elastic_before_and_after_start(tmp_path):
    """``collector.attach_elastic`` wires any manager with ``peers()``:
    before start() the next start picks it up, after start() the active
    aggregator gets it (the port has no ElasticManager of its own)."""
    mgr = _FakeElastic(1)
    collector.attach_elastic(mgr)
    mon = monitor.enable(str(tmp_path / "run.jsonl"), fleet=True)
    col = collector.get_active()
    assert col is not None and col.aggregator._elastic is mgr
    other = _FakeElastic(1)
    collector.attach_elastic(other)
    assert col.aggregator._elastic is other
    rec = col.aggregator.poll_once()
    assert rec["derived"]["fleet/elastic_peers"] == 1
    assert mon.registry is col.publisher.registry


# ----------------------------------------------- KV transport/publisher death


def test_kv_transport_publisher_death_restart(tmp_path):
    """The same protocol over the REAL KV master (launch/master.py): blobs
    land under /<job>/telemetry/<rank>, a silent publisher goes stale, a
    restarted incarnation takes over."""
    srv = KVServer(0, host="127.0.0.1")
    srv.start()
    port = srv.port
    try:
        t0 = KVTransport(f"127.0.0.1:{port}", job_id="jfleet")
        t1 = KVTransport(f"127.0.0.1:{port}", job_id="jfleet")
        r0, p0 = _mk_rank(t0, 0)
        r1, p1 = _mk_rank(t1, 1)
        agg = Aggregator(t0, world=2,
                         fleet_path=str(tmp_path / "f.jsonl"),
                         interval=0.1, stale_after=0.2)
        _steps(r0, 2, 0.01)
        _steps(r1, 2, 0.01)
        assert p0.publish_once() and p1.publish_once()
        rec = agg.poll_once()
        assert rec["ranks"] == [0, 1]
        assert rec["metrics"]["counters"]["train_step/steps"]["sum"] == 4
        time.sleep(0.25)  # rank 1 "SIGKILLed": no unpublish, just silence
        p0.publish_once()
        rec = agg.poll_once()
        assert rec["stale"] == [1]
        r1b = Registry()
        p1b = Publisher(r1b, t1, 1, interval=0.1, generation=1)
        _steps(r1b, 1, 0.01)
        p1b.publish_once()
        rec = agg.poll_once()
        assert rec["stale"] == [] and rec["metrics"]["counters"][
            "train_step/steps"]["per_rank"]["1"] == 1
        agg.stop(final=False)
    finally:
        srv.stop()


# --------------------------------------------------- monitor/dump integration


def test_monitor_enable_fleet_and_dump(tmp_path):
    """monitor.enable(fleet=True) stands the plane up over the session's
    registry; dump() carries the last fleet snapshot; disable tears the
    collector down with the session."""
    path = str(tmp_path / "run.jsonl")
    mon = monitor.enable(path, fleet=True)
    col = collector.get_active()
    assert col is not None and col.publisher.registry is mon.registry
    assert col.fleet_path == str(tmp_path / "run.fleet.jsonl")
    mon.registry.counter("train_step/steps").inc(4)
    col.publisher.publish_once()
    col.aggregator.poll_once()
    dump_path = monitor.dump()
    doc = json.load(open(dump_path))
    assert doc["fleet"]["kind"] == "fleet"
    assert doc["fleet"]["metrics"]["counters"]["train_step/steps"][
        "sum"] == 4
    assert monitor.fleet_state()["ranks"] == [0]
    monitor.disable()
    assert collector.get_active() is None
    assert monitor.fleet_state() is None


def test_enable_from_env_fleet(tmp_path, monkeypatch):
    """The worker path: PADDLE_MONITOR + PADDLE_MONITOR_FLEET env bring the
    whole plane up without code changes (launcher exports the master)."""
    path = str(tmp_path / "run.jsonl")
    monkeypatch.setenv("PADDLE_MONITOR_FLEET", "1")
    monitor.enable(path)
    col = collector.get_active()
    assert col is not None
    assert col.fleet_path == str(tmp_path / "run.fleet.jsonl")
    monitor.disable()


def test_collector_without_monitor_warns():
    with pytest.warns(RuntimeWarning, match="not enabled"):
        assert collector.start() is None


# ------------------------------------------------------------- tools smokes


def test_fleet_top_render_smoke(tmp_path):
    """fleet_top renders a one-screen dashboard from a real fleet stream:
    per-rank rows, straggler warning, stale tagging."""
    t = LocalTransport()
    fleet = str(tmp_path / "run.fleet.jsonl")
    r0, p0 = _mk_rank(t, 0)
    r1, p1 = _mk_rank(t, 1)
    agg = Aggregator(t, world=2, fleet_path=fleet, interval=0.1,
                     stale_after=0.2, skew_warn=2.0)
    _steps(r0, 8, 0.01)
    _steps(r1, 8, 0.05)
    r0.counter("serve/tokens").inc(10)
    p0.publish_once(), p1.publish_once()
    agg.poll_once()
    _steps(r0, 8, 0.01)
    r0.counter("serve/tokens").inc(30)
    p0.publish_once()
    time.sleep(0.25)
    agg.poll_once()  # rank 1 now stale
    agg.stop(final=False)

    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import fleet_top
    finally:
        sys.path.pop(0)
    meta, fleets, warns = fleet_top.load_stream(fleet)
    assert meta["world"] == 2 and len(fleets) == 2
    frame = fleet_top.render(meta, fleets, warns)
    # one row per rank, slow rank named, dead rank tagged
    assert "rank" in frame and "step p95" in frame
    assert "straggler" in frame and "rank 1" in frame.split("warnings")[1]
    assert "<< STALE" in frame
    assert "tokens/s fleet-wide" in frame
    # the CLI entry point renders the same frame
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fleet_top.main([fleet, "--once"])
    assert rc == 0 and "fleet_top" in buf.getvalue()


def test_metrics_summary_accepts_fleet_stream(tmp_path):
    """Satellite: the offline summarizer reads the ONLINE stream too, and
    every histogram now renders real p50/p95/p99 columns."""
    path = str(tmp_path / "run.jsonl")
    mon = monitor.enable(path, fleet=True, flush_every=1)
    col = collector.get_active()
    mon.registry.counter("train_step/steps").inc(3)
    mon.registry.histogram("train_step/dispatch_s").observe(0.01)
    col.publisher.publish_once()
    col.aggregator.poll_once()
    fleet = col.fleet_path
    monitor.disable()

    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import metrics_summary
    finally:
        sys.path.pop(0)
    buf = io.StringIO()
    rc = metrics_summary.summarize([path, fleet], out=buf)
    out = buf.getvalue()
    assert rc == 0
    assert "fleet (online aggregation)" in out
    # one explicit poll + the teardown flush poll
    assert "rounds 2" in out
    # the histogram table's new percentile columns
    assert "p50" in out and "p95" in out and "p99" in out


# ------------------------------------------------------- parity with JAX


def _strip_ts(rec):
    return {k: v for k, v in rec.items() if k != "ts"}


def test_aggregators_agree_with_jax(tmp_path):
    """The same blobs, published by the port's publishers from the same
    registry snapshots (a straggler, a lone-rank recompile, a forked
    weight digest), folded by both packages' aggregators over three polls
    at the same instants: equal fleet records and equal warnings."""
    t = LocalTransport()
    regs, pubs = zip(*[_mk_rank(t, r) for r in range(3)])
    aggs = [cls(t, world=3, fleet_path=str(tmp_path / f"{name}.jsonl"),
                interval=0.1, stale_after=1e6, skew_warn=1.5)
            for name, cls in (("port", Aggregator), ("jax", JaxAggregator))]
    now = time.time()
    for rnd in range(3):
        for r, reg in enumerate(regs):
            _steps(reg, 4, 0.01 if r != 2 else 0.04)
            reg.gauge("health/digest_step").set(rnd + 1)
            for d in range(2):
                reg.gauge(f"health/digest/p{d}").set(
                    1.0 + d + (0.5 if r == 1 and rnd > 0 else 0.0))
        if rnd > 0:
            regs[0].counter("train_step/recompiles").inc()
        for p in pubs:
            assert p.publish_once()
        recs = [agg.poll_once(now=now + rnd) for agg in aggs]
        assert _strip_ts(recs[0]) == _strip_ts(recs[1]), rnd
    for agg in aggs:
        agg.stop(final=False)
    warns = [sorted((r["warn"], r.get("rank")) for r in _read_jsonl(
        str(tmp_path / f"{name}.jsonl")) if r.get("kind") == "fleet_warn")
        for name in ("port", "jax")]
    assert warns[0] == warns[1]
    kinds = {w for w, _ in warns[0]}
    assert kinds == {"straggler", "divergence", "weight_divergence"}, kinds
    assert recs[0]["derived"]["fleet/weight_divergence"] == 1.0


def test_fleet_modules_import_no_jax():
    """The fleet plane's modules import neither jax nor the JAX package."""
    import subprocess
    code = (
        "import sys\n"
        "import paddle_tpu_torch.monitor.collector\n"
        "import paddle_tpu_torch.distributed.launch\n"
        "import paddle_tpu_torch.distributed.reshard\n"
        "import paddle_tpu_torch.serving.router, "
        "paddle_tpu_torch.serving.endpoint\n"
        "import paddle_tpu_torch.serving.kvpool, "
        "paddle_tpu_torch.serving.guardrails\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
