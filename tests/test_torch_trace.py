"""The port's span tracer (paddle_tpu_torch.monitor.trace) and the
engine's request traces against the JAX package's, on the CPU.

* a scripted trace under an injected clock (both modules' ``time``
  replaced by one deterministic counter) gives the same records, field
  for field;
* head sampling keeps the same traces (the credit accumulator: no PRNG),
  ``escalate`` keeps a dropped trace, floating spans are adopted by kind;
* a tiny paged engine (tests/test_torch_serving.py's ``TINY`` and weights,
  a pool small enough to preempt) serves 3 requests with monitor and
  tracer on in both packages: each request's span names and event kinds
  match, the ``serve_*`` record kinds and counts match, and the port's
  ``compile_count`` is the same as with the monitor off; a prompt-lookup
  drafter's run gives the JAX package's ``serve_spec`` records and spec
  counters;
* ``tools/trace_view.py`` reads the port's trace file.
"""
import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu import monitor as jmon
from paddle_tpu.monitor import trace as jtrace
from paddle_tpu.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.serving import PromptLookupDrafter as JaxLookup
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.monitor import trace as ttrace
from paddle_tpu_torch.serving import DecodeEngine, PromptLookupDrafter
from test_torch_serving import _model_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = dict(max_slots=3, max_len=48, block_size=8, kv_blocks=9,
              prefill_chunk=8)
REQUESTS = ((12, 9), (20, 10), (5, 12))        # (prompt length, new tokens)


@pytest.fixture(autouse=True)
def _all_off(monkeypatch):
    for k in ("PADDLE_TRACE", "PADDLE_TRACE_SAMPLE", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ID", "PADDLE_MONITOR_FLEET"):
        monkeypatch.delenv(k, raising=False)
    for mod in (jmon, tmon, jtrace, ttrace):
        mod.disable()
    yield
    for mod in (jmon, tmon, jtrace, ttrace):
        mod.disable()


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class _Clock:
    """``time`` stand-in: perf_counter advances 1 ms a read, time() is a
    fixed wall anchor plus the same count."""

    def __init__(self):
        self.n = 0

    def perf_counter(self):
        self.n += 1
        return 100.0 + 1e-3 * self.n

    def time(self):
        return 1.7e9 + 1e-3 * self.n


def _script(mod, path):
    t = mod.enable(path, sample=0.5, ring=8)
    for i in range(4):
        tr = t.start_trace("req", kind="request", current=False, n=i)
        q = tr.span("queue")
        q.event("page_reject", free=1, needed=2)
        q.end()
        p = tr.span("prefill", slot=i)
        p.event("chunk", p0=0, end=8)
        p.set(chunks=1)
        p.end()
        t0 = mod.get().wall(0) and 100.5
        tr.record("decode", t0, t0 + 0.01, tokens=3)
        if i == 1:
            tr.escalate("health_nan")
        tr.end(status="done", tokens=3)
    t.floating("loader_wait", 100.0, 100.002, adopt_kind="step", qsize=2)
    st = t.start_trace("train_step", kind="step", step=1)
    st.event("recompile", count=1, path="eager")
    st.end()
    info = t.snapshot_info()
    mod.disable()
    return info


def test_scripted_trace_records_match_jax(tmp_path, monkeypatch):
    infos = {}
    for name, mod in (("jax", jtrace), ("port", ttrace)):
        monkeypatch.setattr(mod, "time", _Clock())
        infos[name] = _script(mod, str(tmp_path / f"{name}.jsonl"))
    j = _records(str(tmp_path / "jax.jsonl"))
    t = _records(str(tmp_path / "port.jsonl"))
    assert t == j
    kinds = collections.Counter(r["kind"] for r in t)
    # credit 1.0 + 0.5 a start: requests 0, 1 and 3 kept (1 escalated as
    # well), request 2 and the step dropped
    assert kinds["trace"] == 3
    for key in ("sample", "started", "sampled", "escalated",
                "escalated_reasons", "current", "recent", "open"):
        assert infos["port"][key] == infos["jax"][key], key


@pytest.mark.parametrize("sample", [0.1, 0.25, 0.0, 1.0])
def test_head_sampling_keeps_the_same_traces(tmp_path, sample):
    kept = {}
    for name, mod in (("jax", jtrace), ("port", ttrace)):
        t = mod.enable(None, sample=sample)
        kept[name] = []
        for _ in range(30):
            tr = t.start_trace("r", kind="request", current=False)
            kept[name].append(tr.sampled)
            tr.end()
        mod.disable()
    assert kept["port"] == kept["jax"]
    if sample == 0.1:
        assert sum(kept["port"]) == 3       # every 10th, the first kept


def test_escalate_keeps_a_dropped_trace(tmp_path):
    for mod in (jtrace, ttrace):
        t = mod.enable(str(tmp_path / f"{mod.__name__}.jsonl"), sample=0.0)
        tr = t.start_trace("r", kind="request", current=False)
        sp = tr.span("queue")
        sp.end()
        mod.escalate("serve_hang")          # every open trace
        tr.end()
        dropped = t.start_trace("r2", kind="request", current=False)
        dropped.end()
        mod.disable()
        recs = _records(str(tmp_path / f"{mod.__name__}.jsonl"))
        summaries = [r for r in recs if r["kind"] == "trace"]
        assert len(summaries) == 1 and summaries[0]["escalated"] == \
            "serve_hang" and summaries[0]["spans"] == 2


def test_floating_spans_adopted_by_kind():
    got = {}
    for name, mod in (("jax", jtrace), ("port", ttrace)):
        t = mod.enable(None)
        t.floating("ckpt_save", 1.0, 2.0, adopt_kind="step")
        req = t.start_trace("r", kind="request", current=False)
        req.end()
        step = t.start_trace("s", kind="step")
        step.end()
        got[name] = [(r["name"], r["trace"] == step.trace_id)
                     for r in t.ring if r["name"] == "ckpt_save"]
        mod.disable()
    assert got["port"] == got["jax"] == [("ckpt_save", True)]


def test_per_process_trace_path(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    paths = []
    for mod in (jtrace, ttrace):
        paths.append(mod.enable(str(tmp_path / "run.trace.jsonl")).path)
        mod.disable()
    assert paths[0] == paths[1] == str(tmp_path / "run.trace.proc1.jsonl")


# ------------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def models():
    return _model_pair()


def _serve(Engine, model, drafter=None):
    eng = Engine(model, drafter=drafter, **ENGINE)
    rs = np.random.RandomState(0)
    reqs = []
    for n, m in REQUESTS:
        prompt = rs.randint(0, 16, n).tolist()     # repeats: lookup hits
        reqs.append(eng.submit(prompt, max_new_tokens=m))
    eng.run()
    return eng, reqs


def _run(tmp_path, name, mod, Engine, model, drafter=None):
    path = str(tmp_path / f"{name}.jsonl")
    mod.enable(path, trace=True)
    eng, reqs = _serve(Engine, model, drafter)
    counters = mod.snapshot()["counters"]
    mod.disable()
    return (_records(path), _records(str(tmp_path / f"{name}.trace.jsonl")),
            counters, eng)


def _request_shapes(trace_recs):
    spans = collections.defaultdict(list)
    for r in trace_recs:
        if r["kind"] == "span":
            spans[r["trace"]].append(
                (r["name"], [e["name"] for e in r.get("events", [])]))
    return sorted(spans.values())


@pytest.fixture(scope="module")
def engine_runs(models, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine")
    jm, tm = models
    out = {"jax": _run(tmp, "jax", jmon, JaxDecodeEngine, jm),
           "port": _run(tmp, "port", tmon, DecodeEngine, tm)}
    out["trace_path"] = str(tmp / "port.trace.jsonl")
    return out


def test_engine_request_spans_match_jax(engine_runs):
    j, t = engine_runs["jax"], engine_runs["port"]
    assert _request_shapes(t[1]) == _request_shapes(j[1])
    names = {tuple(n for n, _ in s) for s in _request_shapes(t[1])}
    # the pool preempts: one request requeues (queue, prefill, queue...)
    assert ("request", "queue", "prefill", "decode") in names
    events = [e for s in _request_shapes(t[1]) for _, ev in s for e in ev]
    assert {"chunk", "decode_step", "preempt"} <= set(events)


def test_engine_serve_records_match_jax(engine_runs):
    def serve_kinds(recs):
        return collections.Counter(r["kind"] for r in recs
                                   if r["kind"].startswith("serve_"))
    j, t = engine_runs["jax"], engine_runs["port"]
    assert serve_kinds(t[0]) == serve_kinds(j[0])
    assert serve_kinds(t[0])["serve_compile"] == t[3].compile_count == 2
    for key in ("serve/requests", "serve/admissions", "serve/completions",
                "serve/decode_steps", "serve/tokens", "serve/preemptions",
                "serve/page_rejects", "serve/compiles"):
        assert t[2].get(key) == j[2].get(key), key
    assert t[2]["serve/preemptions"] >= 1


def test_engine_compile_count_flat_with_the_monitor_on(models, engine_runs):
    _, tm = models
    eng, _ = _serve(DecodeEngine, tm)            # monitor off
    assert eng.compile_count == engine_runs["port"][3].compile_count


def test_trace_view_reads_the_port_engine_trace(engine_runs):
    out = subprocess.run([sys.executable,
                          os.path.join(REPO, "tools", "trace_view.py"),
                          engine_runs["trace_path"], "--kind", "request"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "request" in out.stdout


def test_spec_engine_records_match_jax(models, tmp_path):
    jm, tm = models
    j = _run(tmp_path, "jax", jmon, JaxDecodeEngine, jm, JaxLookup())
    t = _run(tmp_path, "port", tmon, DecodeEngine, tm, PromptLookupDrafter())
    spec = [r for r in t[0] if r["kind"] == "serve_spec"]
    assert [(r["drafter"], r["drafted"] > 0) for r in spec] == \
        [(r["drafter"], r["drafted"] > 0)
         for r in j[0] if r["kind"] == "serve_spec"]
    for key in ("serve/spec_steps", "serve/tokens",
                "serve/spec_emitted.prompt_lookup"):
        assert t[2][key] == j[2][key], key
    assert t[2]["serve/spec_steps"] == t[3].stats()["spec"]["steps"]
    events = [e for s in _request_shapes(t[1]) for _, ev in s for e in ev]
    assert "spec_step" in events
