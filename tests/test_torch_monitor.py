"""The port's monitor (paddle_tpu_torch.monitor) against the JAX package's
(paddle_tpu.monitor), on the CPU.

* the registry and its Prometheus text: the same scripted operations on
  both registries give equal ``snapshot()``s (exactly: both sum and
  compare in Python floats) and equal ``prom.render`` text;
* the sink and the flight recorder: the same records give the same lines,
  apart from ``ts`` and ``pid`` (a 0-d ``torch.Tensor`` serialises as the
  number a numpy scalar does);
* ``TrainStep`` integration: a tiny GPT (tests/test_torch_train.py's
  ``SMALL``, weights from numpy through ``convert.py``) runs 4 steps under
  ``monitor.enable(path, trace=True)`` with ``PADDLE_HEALTH_SAMPLE=2`` in
  both packages (the JAX step on its slow path, ``fast_path=False``, the
  counterpart of the port's eager step: its first call at a signature is
  the mint): the same sequence of record kinds, one ``recompile``, the
  same ``accumulation`` at K = 2 and ``remat`` under "selective", a
  scaler overflow's ``skip_update``, and the health gauges within 1e-5
  (relative; the weight and gradient digests relative to the digested
  leaves' L1 norm, their natural scale: a digest is a sum of +-x);
* the shared ``tools/`` read the port's files unchanged;
* a registry lint: no metric name is claimed by two instrument types, and
  every name the port registers (in its source and at run time) is one
  the JAX package registers too, so the tools read both.

Environment variables are set with ``monkeypatch`` only: each package
reads ``PADDLE_MONITOR`` at import.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor as jmon
from paddle_tpu.monitor import prom as jprom
from paddle_tpu.monitor import registry as jregistry
from paddle_tpu.monitor import sink as jsink
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.monitor import health as _thealth
from paddle_tpu_torch.monitor import prom as tprom
from paddle_tpu_torch.monitor import registry as tregistry
from paddle_tpu_torch.monitor import sink as tsink
from test_torch_accum_amp import SGD
from test_torch_train import _batch, _pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEALTH_REL = 1e-5
_ENV = ("PADDLE_HEALTH", "PADDLE_HEALTH_SAMPLE", "PADDLE_HEALTH_FAULT",
        "PADDLE_HEALTH_OVERFLOW", "PADDLE_HEALTH_DIGEST", "PADDLE_TRACE",
        "PADDLE_TRACE_SAMPLE", "PADDLE_PEAK_FLOPS", "PADDLE_MONITOR_FLEET",
        "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID")


@pytest.fixture(autouse=True)
def _both_off(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    jmon.disable()
    tmon.disable()
    yield
    jmon.disable()
    tmon.disable()


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ------------------------------------------------------------------ registry


def _script(reg):
    c = reg.counter("train_step/steps")
    c.inc()
    c.inc(4)
    reg.counter("serve/requests").inc(3)
    g = reg.gauge("serve/live_slots")
    g.set(7)
    g.add(-2.5)
    reg.gauge("goodput/fraction").set(0.123456789)
    h = reg.histogram("train_step/dispatch_s")
    for v in (3e-6, 2e-4, 0.0, 0.05, 0.05, 7.0, 400.0, 1e-3):
        h.observe(v)
    hb = reg.histogram("serve/request_tokens", buckets=(4, 16, 64, 1))
    for v in (1, 2, 8, 100, 16):
        hb.observe(v)
    reg.gauge("mfu/train_bucket1/flops").set(1.5e12)
    reg.gauge("health/grad_norm.gpt.h.0.attn.qkv_proj").set(0.25)
    reg.gauge("health/digest/p0").set(-3.0)
    reg.counter("health/nan_trips").inc()
    reg.gauge("mfu/train_bucket2/flops").set(2.0)
    reg.remove_prefix("mfu/train_bucket2")


def test_registry_snapshot_and_prom_text_match_jax():
    j, t = jregistry.Registry(), tregistry.Registry()
    _script(j)
    _script(t)
    assert t.names() == j.names()
    assert t.snapshot() == j.snapshot()
    assert tprom.render(t.snapshot()) == jprom.render(j.snapshot())
    prev_j, prev_t = j.snapshot(), t.snapshot()
    for reg in (j, t):
        reg.counter("serve/requests").inc()
        reg.histogram("train_step/dispatch_s").observe(0.5)
    assert tregistry.Registry.delta(prev_t, t.snapshot()) == \
        jregistry.Registry.delta(prev_j, j.snapshot())


def test_registry_type_collision_and_buckets_raise_as_in_jax():
    for mod in (jregistry, tregistry):
        reg = mod.Registry()
        reg.gauge("serve/queue_depth")
        with pytest.raises(TypeError, match="already registered as Gauge"):
            reg.counter("serve/queue_depth")
        reg.histogram("h", buckets=(1.0, 2.0))
        with pytest.raises(ValueError, match="already registered"):
            reg.histogram("h", buckets=(1.0, 3.0))
    assert tregistry._DEFAULT_BUCKETS == jregistry._DEFAULT_BUCKETS


def test_prom_render_of_live_registry_matches_jax(tmp_path):
    for mod in (jmon, tmon):
        mod.enable(None)
        _script(mod.get().registry)
    jt, tt = jmon.prom_render(), tmon.prom_render()
    # the goodput gauges are clocks of the two sessions: compare the rest
    keep = re.compile(r"paddle_goodput_")
    assert [ln for ln in tt.splitlines() if not keep.search(ln)] == \
        [ln for ln in jt.splitlines() if not keep.search(ln)]
    assert "paddle_goodput_fraction" in tt


# ---------------------------------------------------------- sink & recorder


class _Odd:
    def __repr__(self):
        return "<odd>"


def _sink_records(tensor_scalar):
    return [{"v": 1, "kind": "step", "dur_s": 0.25},
            {"v": 1, "kind": "x", "n": np.int64(3), "f": np.float32(0.5),
             "t": tensor_scalar, "nested": {"a": [1, 2.5, None]},
             "odd": _Odd(), "dtype": np.dtype("float32")}]


def test_sink_lines_match_jax(tmp_path):
    js = jsink.JsonlSink(str(tmp_path / "j.jsonl"), flush_every=1)
    ts = tsink.JsonlSink(str(tmp_path / "t.jsonl"), flush_every=1)
    for rec in _sink_records(np.float32(1.5)):
        js.write(rec)
    for rec in _sink_records(torch.tensor(1.5)):
        ts.write(rec)
    js.close()
    ts.close()
    with open(js.path) as a, open(ts.path) as b:
        assert a.read() == b.read()
    assert ts.records_written == js.records_written == 2


def test_sink_per_process_suffix_matches_jax(tmp_path, monkeypatch):
    base = str(tmp_path / "run.jsonl")
    assert tsink.resolve_sink_path(base) == jsink.resolve_sink_path(base)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    assert tsink.resolve_sink_path(base) == jsink.resolve_sink_path(base) \
        == str(tmp_path / "run.proc2.jsonl")


def _strip(rec):
    """A record without its clocks: ``ts``/``pid``/``start``, and of a
    counters record's snapshot the counters only (its goodput gauges are
    the session's own clock)."""
    out = {k: v for k, v in rec.items()
           if k not in ("ts", "pid", "start", "dumped_at")}
    if out.get("kind") == "counters":
        out["metrics"] = out["metrics"]["counters"]
    return out


def test_flight_dump_matches_jax(tmp_path):
    dumps = {}
    for name, mod in (("jax", jmon), ("port", tmon)):
        mon = mod.enable(str(tmp_path / f"{name}.jsonl"), ring=4)
        for i in range(6):
            mon.emit("step", dur_s=0.01 * i)
        mon.registry.counter("train_step/steps").inc(6)
        path = mon.dump()
        with open(path) as f:
            dumps[name] = json.load(f)
        mod.disable()
    j, t = dumps["jax"], dumps["port"]
    assert t["kind"] == j["kind"] == "flight_dump"
    # meta, 6 steps and the counters record the dump emits first
    assert t["events_seen"] == j["events_seen"] == 8
    assert [_strip(e) for e in t["events"]] == \
        [_strip(e) for e in j["events"]]
    assert t["metrics"]["counters"] == j["metrics"]["counters"]


def test_disabled_path_records_nothing(tmp_path):
    """Monitor and tracer off: the step is the plain step (no observation,
    no record, no trace state touched)."""
    _, _, tm = _pair()
    ids, labels = _batch()
    step = TrainStep(tm, SGD(learning_rate=0.1, parameters=tm.parameters()))
    step._observed = None          # the monitored path must not be reached
    step(torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
    assert tmon.get() is None and step._mon_sigs == {} \
        and step._trace_n == 0 and step._health_n == 0
    assert tmon.snapshot() is None and tmon.prom_render() == "" \
        and tmon.dump() is None


# -------------------------------------------------------- TrainStep records


def _run_both(tmp_path, monkeypatch, steps=4, jkw=None, tkw=None,
              inputs=None, cfg=None, before_last=None):
    """``steps`` TrainStep calls in both packages under monitor + trace with
    PADDLE_HEALTH_SAMPLE=2 (``cfg(jax_model, port_model)`` first,
    ``before_last(model)`` on each package's model before its last call).
    Returns {pkg: (records, trace records, final gauges, monitor, step)}
    and "grad_l1", the L1 norms of the port's sampled gradients."""
    monkeypatch.setenv("PADDLE_HEALTH_SAMPLE", "2")
    jm, _, tm = _pair()
    if cfg is not None:
        cfg(jm, tm)
    ids, labels = _batch() if inputs is None else inputs
    out = {}
    grad_l1 = []
    real_grads = _thealth.DeviceStats.grads

    def grads(self, gs):
        # the L1 norm of the sampled gradients: the scale the gradient
        # digests are held at
        grad_l1.append(sum(float(g.abs().sum()) for g in gs))
        return real_grads(self, gs)
    monkeypatch.setattr(_thealth.DeviceStats, "grads", grads)
    for name, mod in (("jax", jmon), ("port", tmon)):
        path = str(tmp_path / f"{name}.jsonl")
        mon = mod.enable(path, trace=True)
        if name == "jax":
            opt = paddle.optimizer.SGD(learning_rate=0.1,
                                       parameters=jm.parameters())
            step = paddle.jit.TrainStep(jm, opt, fast_path=False,
                                        **(jkw or {}))
            args = (paddle.to_tensor(ids), paddle.to_tensor(labels))
        else:
            opt = SGD(learning_rate=0.1, parameters=tm.parameters())
            # the eager step, as the JAX step's slow path (the fast path's
            # records: tests/test_torch_train_graph.py)
            step = TrainStep(tm, opt, **dict(dict(fast_path=False),
                                             **(tkw or {})))
            args = (torch.from_numpy(ids).long(),
                    torch.from_numpy(labels).long())
        for i in range(steps):
            if before_last is not None and i == steps - 1:
                before_last(jm if name == "jax" else tm)
            step(*args)
        gauges = mod.snapshot()["gauges"]
        mod.disable()
        out[name] = (_records(path),
                     _records(str(tmp_path / f"{name}.trace.jsonl")),
                     gauges, mon, step)
    out["grad_l1"] = grad_l1
    return out


def _kinds(recs):
    return [r["kind"] for r in recs]


@pytest.fixture(scope="module")
def plain_runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        for k in _ENV:
            mp.delenv(k, raising=False)
        yield _run_both(tmp_path_factory.mktemp("plain"), mp)
    finally:
        mp.undo()
        jmon.disable()
        tmon.disable()


def test_train_step_record_kinds_match_jax(plain_runs):
    jrecs, trecs = plain_runs["jax"][0], plain_runs["port"][0]
    assert _kinds(trecs) == _kinds(jrecs)
    assert _kinds(trecs) == ["meta", "exec_cost", "recompile", "step",
                             "step", "step", "counters"]
    rc = [r for r in trecs if r["kind"] == "recompile"]
    assert len(rc) == 1 and rc[0]["count"] == 1 and rc[0]["path"] == "eager"
    assert rc[0]["compile_s"] is None and rc[0]["divergent"] == []
    assert rc[0]["trace"]                 # embedded: the step's trace id
    ec = [r for r in trecs if r["kind"] == "exec_cost"][0]
    jec = [r for r in jrecs if r["kind"] == "exec_cost"][0]
    assert ec["analytic_flops"] == pytest.approx(jec["analytic_flops"],
                                                 rel=1e-12)
    assert ec["tokens_per_call"] == jec["tokens_per_call"]
    assert ec["flops"] > 0                # measured (the JAX slow path: None)


def test_train_step_trace_spans_match_jax(plain_runs):
    def shape(trs):
        spans = [r for r in trs if r["kind"] == "span"]
        return [(r["name"], r["span_kind"], [e["name"] for e in
                                              r.get("events", [])])
                for r in spans]
    jt, tt = plain_runs["jax"][1], plain_runs["port"][1]
    assert shape(tt) == shape(jt)
    assert [r["kind"] for r in tt].count("trace") == 4


def test_health_gauges_match_jax(plain_runs):
    """Sampled at steps 2 and 4: every health gauge the JAX package sets,
    within 1e-5; digests within 1e-5 of the digested leaves' L1 norm (both
    are fp32 sums of +-x in different orders: their rounding scales with
    that norm, not with the sum)."""
    jg, tg = plain_runs["jax"][2], plain_runs["port"][2]
    jh = {k: v for k, v in jg.items() if k.startswith("health/")}
    th = {k: v for k, v in tg.items() if k.startswith("health/")}
    assert set(th) == set(jh)
    assert th["health/digest_step"] == jh["health/digest_step"] == 4
    step = plain_runs["port"][4]
    params = [p for p in step._opt._parameter_list if p.requires_grad]
    l1_w = sum(float(p.detach().abs().sum()) for p in params)
    l1_g = plain_runs["grad_l1"][-1]          # step 4's gradients
    for k in sorted(jh):
        if k.startswith("health/digest/"):
            scale = l1_w if "/p" in k else l1_g
            assert abs(th[k] - jh[k]) <= HEALTH_REL * scale, k
        else:
            assert th[k] == pytest.approx(jh[k], rel=HEALTH_REL, abs=1e-12), k


def test_goodput_gauges_sum_to_wall(plain_runs):
    from paddle_tpu_torch.monitor.goodput import GOODPUT_STATES
    g = plain_runs["port"][2]
    total = sum(g[f"goodput/{s}_s"] for s in GOODPUT_STATES)
    assert total == pytest.approx(g["goodput/wall_s"], rel=1e-9)
    assert g["goodput/compile_s"] > 0 and g["goodput/productive_s"] > 0


def test_accumulation_remat_and_skip_update_records_match_jax(tmp_path,
                                                              monkeypatch):
    """K = 2 under "selective" recompute with a GradScaler, 3 steps, a NaN
    planted in the position embedding of both models before the third:
    the ``accumulation`` record, the ``remat`` record (regions, policy,
    named bytes) and the third step's ``skip_update`` as the JAX
    package's; the step trace escalated, the update skipped."""
    ids, labels = _batch()
    stacked = (np.stack([ids, ids]), np.stack([labels, labels]))

    def selective(jm, tm):
        jm.gpt.enable_recompute("selective")
        tm.enable_recompute("selective")

    def poison(model):
        if isinstance(model, torch.nn.Module):
            with torch.no_grad():
                model.gpt.wpe.weight[0, 0] = float("nan")
            return
        p = dict(model.named_parameters())["gpt.wpe.weight"]
        a = np.array(p.numpy(), dtype=np.float32)
        a[0, 0] = np.nan
        p.set_value(a)

    def scaler(pkg):
        kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=1000,
                  decr_every_n_nan_or_inf=1000)
        return (paddle.amp.GradScaler(**kw) if pkg == "jax"
                else GradScaler(**kw))
    monkeypatch.setenv("PADDLE_HEALTH", "0")
    runs = _run_both(tmp_path, monkeypatch, steps=3,
                     jkw=dict(accumulate_steps=2, grad_scaler=scaler("jax")),
                     tkw=dict(accumulate_steps=2,
                              grad_scaler=scaler("port")),
                     inputs=stacked, cfg=selective, before_last=poison)
    jrecs, trecs = runs["jax"][0], runs["port"][0]
    assert _kinds(trecs) == _kinds(jrecs)
    for kind in ("accumulation", "remat", "skip_update"):
        j = [_strip(r) for r in jrecs if r["kind"] == kind]
        t = [_strip(r) for r in trecs if r["kind"] == kind]
        assert len(t) == 1, kind
        t[0].pop("trace", None)
        j[0].pop("trace", None)
        assert t == j, kind
    remat = [r for r in trecs if r["kind"] == "remat"][0]
    assert remat["regions"] == 2 and remat["policy"] == "selective"
    skip = [r for r in trecs if r["kind"] == "skip_update"][0]
    assert skip["microbatches"] == 2 and skip["trace"]
    summaries = [r for r in runs["port"][1] if r["kind"] == "trace"]
    assert summaries[-1]["escalated"] == "skip_update"
    g = runs["port"][2]
    assert g["remat/regions"] == 2 and g["train_step/accumulate_steps"] == 2
    assert g["health/loss_scale"] == runs["jax"][2]["health/loss_scale"]
    assert runs["port"][3].registry.counter(
        "train_step/skipped_updates").value == 1


def test_crash_writes_flight_dump(tmp_path):
    """An exception escaping TrainStep dumps the flight ring once, with the
    exception and the escalated step trace."""
    mon = tmon.enable(str(tmp_path / "run.jsonl"), trace=True)
    _, _, tm = _pair()
    step = TrainStep(tm, SGD(learning_rate=0.1, parameters=tm.parameters()),
                     accumulate_steps=3)
    ids, _ = _batch()
    with pytest.raises(ValueError, match="accumulate_steps"):
        step(torch.from_numpy(ids).long(), torch.from_numpy(ids).long())
    tmon.disable()
    dump = str(tmp_path / "run.flight.json")
    with open(dump) as f:
        payload = json.load(f)
    assert payload["exception"]["type"] == "ValueError"
    assert len(payload["trace"]["open"]) == 1     # the crashing step's
    summary = [r for r in _records(str(tmp_path / "run.trace.jsonl"))
               if r["kind"] == "trace"]
    assert summary[0]["escalated"] == "crash"
    assert summary[0]["trace"] == payload["trace"]["open"][0]
    crash = [r for r in _records(str(tmp_path / "run.jsonl"))
             if r["kind"] == "crash"]
    assert len(crash) == 1 and crash[0]["dump"] == dump
    assert mon.flight.events_seen >= 2


# -------------------------------------------------------------- shared tools


def _tool(name, *args):
    return subprocess.run([sys.executable, os.path.join(REPO, "tools", name),
                           *args], capture_output=True, text=True,
                          timeout=120)


def test_shared_tools_read_port_files(plain_runs, tmp_path):
    port_jsonl = os.path.join(os.path.dirname(
        plain_runs["port"][3].sink.path), "port.jsonl")
    trace_jsonl = port_jsonl.replace(".jsonl", ".trace.jsonl")
    summary = _tool("metrics_summary.py", port_jsonl)
    assert summary.returncode == 0, summary.stderr
    assert "recompile" in summary.stdout
    report = _tool("goodput_report.py", port_jsonl)
    assert report.returncode == 0, report.stderr
    assert "goodput" in report.stdout.lower()
    view = _tool("trace_view.py", trace_jsonl)
    assert view.returncode == 0, view.stderr
    assert "step" in view.stdout and "dispatch" in view.stdout
    prom = _tool("fleet_prom.py", port_jsonl)
    assert prom.returncode == 0, prom.stderr
    assert "paddle_train_step_steps_total" in prom.stdout


# ------------------------------------------------------------- registry lint

_CALL = re.compile(
    r"""\b(counter|gauge|histogram|g|c)\(\s*(f?)(["'])(.+?)\3""")


def _source_names(pkg_dir, health):
    """{pattern: instrument type} of every metric-name literal the
    package's monitor sources register (``g``/``c`` are the modules'
    aliases of ``registry.gauge``/``registry.counter``); an f-string's
    fields become wildcards, the digest name constants their values."""
    kinds = {"g": "gauge", "c": "counter"}
    out = {re.escape(health.DIGEST_STEP_GAUGE): {"gauge"}}
    for fn in sorted(os.listdir(pkg_dir)):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(pkg_dir, fn)) as f:
            src = f.read()
        for m in _CALL.finditer(src):
            kind = kinds.get(m.group(1), m.group(1))
            lit = m.group(4).replace("{DIGEST_PREFIX}", health.DIGEST_PREFIX)
            if "/" not in lit:
                continue
            pat = re.escape(lit) if not m.group(2) else "".join(
                ".+" if part.startswith("{") else re.escape(part)
                for part in re.split(r"(\{[^}]*\})", lit))
            out.setdefault(pat, set()).add(kind)
    return out


def test_registry_lint_port_names_are_jax_names(plain_runs):
    from paddle_tpu.monitor import health as jhealth
    jnames = _source_names(os.path.join(REPO, "paddle_tpu", "monitor"),
                           jhealth)
    tnames = _source_names(os.path.join(REPO, "paddle_tpu_torch",
                                        "monitor"), _thealth)
    clash = {p: k for p, k in tnames.items() if len(k) > 1}
    assert not clash, f"names claimed by two instrument types: {clash}"
    missing = {p: k for p, k in tnames.items()
               if p not in jnames or not k <= jnames[p]}
    assert not missing, f"port names the JAX package never registers: " \
                        f"{missing}"
    # ... and at run time: every name the port's session registered
    jpats = [(re.compile(p + "$"), k) for p, k in jnames.items()]
    snap = plain_runs["port"][3].registry.snapshot()
    for kind, names in (("counter", snap["counters"]),
                        ("gauge", snap["gauges"]),
                        ("histogram", snap["histograms"])):
        for name in names:
            assert any(rx.match(name) and kind in k for rx, k in jpats), \
                f"{kind} {name!r} is not a JAX package name"
