"""The port's health plane (paddle_tpu_torch.monitor.health) against the
JAX package's, on the CPU.

* the same gradients and updates give the same per-group statistics
  (non-finite count, max finite |g|, finite sum of squares, the update
  and weight norms; fp32, 1e-5 relative) and the same digests (1e-5 of the
  leaves' L1 norm: both are fp32 sums of +-x in different orders), the
  port indexing an ``nn.Linear`` weight, stored transposed, in the JAX
  layout;
* the same payload gives the same gauges and trips through the host half
  (``on_sample``), the same loss series the same spike decisions, the
  same fault strings the same ``FaultPlan``;
* the port's ``TrainStep``: a NaN planted by ``PADDLE_HEALTH_FAULT``
  trips at the next sample with a WARN naming the leaf's group and the
  leaf, one ``health_nan`` record and one flight dump; the overflow
  tripwire; ``PADDLE_HEALTH=0``; an unsampled step builds no statistics;
  a recompute region's replay does not tap its activations twice.
"""
import json
import math
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import monitor as jmon
from paddle_tpu.monitor import health as jh
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.monitor import health as th
from test_torch_accum_amp import SGD
from test_torch_train import _batch, _pair

REL = 1e-5
NAMES = ["h.0.attn.qkv_proj.weight", "h.0.attn.qkv_proj.bias",
         "h.0.mlp.fc_in.weight", "ln_f.weight", "wte.weight"]
SHAPES = [(16, 48), (48,), (16, 64), (16,), (40, 16)]
_ENV = ("PADDLE_HEALTH", "PADDLE_HEALTH_SAMPLE", "PADDLE_HEALTH_FAULT",
        "PADDLE_HEALTH_OVERFLOW", "PADDLE_HEALTH_DIGEST")


@pytest.fixture(autouse=True)
def _off(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    jmon.disable()
    tmon.disable()
    yield
    jmon.disable()
    tmon.disable()


def _leaves(seed, nonfinite=False):
    rs = np.random.RandomState(seed)
    out = [rs.normal(0, 0.1, s).astype(np.float32) for s in SHAPES]
    if nonfinite:
        out[0][3, 5] = np.nan
        out[0][0, 0] = np.inf
        out[3][2] = -np.inf
    return out


@pytest.mark.parametrize("nonfinite", [False, True])
def test_group_stats_match_jax(nonfinite):
    grads = _leaves(0, nonfinite)
    old = _leaves(1)
    new = [o - 0.01 * np.nan_to_num(g, nan=0.0, posinf=1.0, neginf=-1.0)
           for o, g in zip(old, grads)]
    spec = jh.CompiledHealth(types.SimpleNamespace(digest_probes=2), NAMES)
    jgrad = np.asarray(spec.grad_stats([jnp.asarray(g) for g in grads]),
                       np.float64)
    jratio = np.asarray(spec.ratio_stats([jnp.asarray(n) for n in new],
                                         [jnp.asarray(o) for o in old]),
                        np.float64)
    stats = th.DeviceStats(types.SimpleNamespace(digest_probes=0), NAMES)
    upd = [torch.from_numpy(o.copy()) for o in old]
    stats.grads([torch.from_numpy(g) for g in grads])
    stats.before_update(upd)
    for u, n in zip(upd, new):
        u.copy_(torch.from_numpy(n))          # the update, in place
    stats.after_update()
    got = stats.read(torch.tensor(2.5))
    assert stats.groups == spec.groups == ["h.0.attn.qkv_proj",
                                           "h.0.mlp.fc_in", "ln_f", "wte"]
    np.testing.assert_allclose(got["grad"], jgrad, rtol=REL)
    np.testing.assert_allclose(got["ratio"], jratio, rtol=REL)
    np.testing.assert_array_equal(got["loss2"], [0.0, 2.5])
    if nonfinite:
        assert got["grad"][0, 0] == 2 and got["grad"][2, 0] == 1


@pytest.mark.parametrize("transposed", [False, True])
def test_digests_match_jax(transposed):
    """The same leaves (in the JAX layout) digest alike; the port given a
    2-D leaf transposed, with its flag, digests it as the JAX layout."""
    leaves = _leaves(2)
    spec = jh.CompiledHealth(types.SimpleNamespace(digest_probes=3), NAMES)
    want = np.asarray(spec.digest([jnp.asarray(x) for x in leaves]),
                      np.float64)
    flags = [transposed and x.ndim == 2 for x in leaves]
    tl = [torch.from_numpy(np.ascontiguousarray(x.T) if f else x)
          for x, f in zip(leaves, flags)]
    got = th.digest(tl, 3, flags).numpy().astype(np.float64)
    l1 = sum(float(np.abs(x).sum()) for x in leaves)
    assert np.abs(got - want).max() <= REL * l1
    assert [th.probe_salt(j, d) for j in range(4) for d in range(3)] == \
        [jh.probe_salt(j, d) for j in range(4) for d in range(3)]


def test_digest_chunking_and_cache_agree(monkeypatch):
    """A leaf hashed in several chunks gives the one-chunk digest, and the
    session's cached int8 probes (bf16 leaves too) give the same."""
    leaves = [torch.from_numpy(x) for x in _leaves(3)]
    flags = [x.dim() == 2 for x in leaves]
    whole = th.digest(leaves, 2, flags)
    cache = th.ProbeCache()
    for typed in (leaves, [x.to(torch.bfloat16) for x in leaves]):
        want = th.digest(typed, 2, flags).numpy()
        np.testing.assert_allclose(cache.digest(typed, 2, flags).numpy(),
                                   want, rtol=1e-5, atol=1e-6)
    assert cache._bytes == 4 * 2 * sum(x.numel() for x in leaves)
    monkeypatch.setattr(th, "_PROBE_CACHE_CPU_BYTES", 0)   # over budget
    np.testing.assert_allclose(th.ProbeCache().digest(leaves, 2, flags)
                               .numpy(), whole.numpy(), rtol=1e-6)
    monkeypatch.setattr(th, "_DIGEST_CHUNK", 37)
    np.testing.assert_allclose(th.digest(leaves, 2, flags).numpy(),
                               whole.numpy(), rtol=1e-6)


def test_leaf_groups_match_jax():
    names = NAMES + ["a", "b.c", "h.0.attn.qkv_proj.extra"]
    assert th.leaf_groups(names) == jh.leaf_groups(names)


SERIES = {
    "steady": [2.0 - 0.01 * i for i in range(40)],
    "spike": [2.0 + 0.001 * (i % 3) for i in range(20)] + [9.0]
    + [2.0] * 5,
    "nonfinite": [1.0] * 10 + [float("nan"), 1.0, float("inf"), 1.0],
}


@pytest.mark.parametrize("series", sorted(SERIES))
def test_spike_decisions_match_jax(series):
    jd, td = jh.SpikeDetector(window=8, min_fill=4), \
        th.SpikeDetector(window=8, min_fill=4)
    for v in SERIES[series]:
        a, b = jd.observe(v), td.observe(v)
        assert (a is None) == (b is None)
        if a is not None:
            assert a["nonfinite"] == b["nonfinite"]
            assert (a["median"], a["mad"]) == (b["median"], b["mad"])
    assert list(jd.vals) == list(td.vals)


@pytest.mark.parametrize("spec", [
    "nan@param:3", "nan@param:3:fc_in", "scale@param:8:16",
    " nan@param:2 , scale@param:5", "bogus@param:1,nan@param:4",
    "nan@grad:2", "", None])
def test_fault_plans_match_jax(spec):
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        jp = jh.FaultPlan.parse(spec)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        tp = th.FaultPlan.parse(spec)
    assert (jp is None) == (tp is None)
    if jp is not None:
        assert tp.entries == jp.entries
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]


def test_host_half_matches_jax(tmp_path, monkeypatch):
    """The same payload through both HealthPlanes' ``on_sample``: the same
    gauges and the same overflow trip."""
    monkeypatch.setenv("PADDLE_HEALTH_OVERFLOW", "0.2")
    rs = np.random.RandomState(4)
    groups = 4
    payload = {"loss2": np.array([0.0, 3.0]),
               "grad": np.abs(rs.normal(0, 0.2, (groups, 3))),
               "ratio": np.abs(rs.normal(0, 1, (groups, 2))),
               "pdig": rs.normal(0, 1, 2), "gdig": rs.normal(0, 1, 2),
               "act": {"attn_qkv": 0.5}}
    payload["grad"][:, 0] = 0
    payload["grad"][1, 1] = 0.5             # over the 0.2 threshold
    gauges = {}
    for name, mod, spec in (
            ("jax", jmon, jh.CompiledHealth(
                types.SimpleNamespace(digest_probes=2), NAMES)),
            ("port", tmon, th.DeviceStats(
                types.SimpleNamespace(digest_probes=2), NAMES))):
        mon = mod.enable(str(tmp_path / f"{name}.jsonl"))
        with pytest.warns(RuntimeWarning, match="overflow threshold"):
            out = mon.health.on_sample(spec, 6, 3.0, payload)
        assert out["overflow"] is not None and out["nan"] is None
        gauges[name] = mon.registry.snapshot()
        mod.disable()
    assert gauges["port"]["counters"] == gauges["jax"]["counters"]
    tg = {k: v for k, v in gauges["port"]["gauges"].items()
          if k.startswith("health/")}
    jg = {k: v for k, v in gauges["jax"]["gauges"].items()
          if k.startswith("health/")}
    assert tg == jg


# ------------------------------------------------------------ the TrainStep


def _port_step(monkeypatch, tmp_path, steps, sample=2, fast_path=True,
               **env):
    monkeypatch.setenv("PADDLE_HEALTH_SAMPLE", str(sample))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, _, tm = _pair()
    ids, labels = _batch()
    mon = tmon.enable(str(tmp_path / "run.jsonl"), trace=True)
    step = TrainStep(tm, SGD(learning_rate=0.1, parameters=tm.parameters()),
                     fast_path=fast_path)
    losses = [float(step(torch.from_numpy(ids).long(),
                         torch.from_numpy(labels).long()))
              for _ in range(steps)]
    return mon, step, losses


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_chaos_nan_trips_at_the_next_sample(monkeypatch, tmp_path):
    with pytest.warns(RuntimeWarning, match="non-finite values") as rec:
        mon, step, losses = _port_step(
            monkeypatch, tmp_path, 4,
            PADDLE_HEALTH_FAULT="nan@param:3:wpe")
    assert all(math.isfinite(x) for x in losses[:2])
    assert not math.isfinite(losses[2])
    msgs = [str(w.message) for w in rec
            if "non-finite values" in str(w.message)]
    assert len(msgs) == 1 and "at step 4" in msgs[0]
    assert "gpt.wpe" in msgs[0] and "gpt.wpe.weight" in msgs[0]
    assert "[trace " in msgs[0]
    assert mon.health.nan_trips == 1
    assert mon.registry.counter("health/nan_trips.gpt.wpe").value == 1
    tmon.disable()
    recs = _records(str(tmp_path / "run.jsonl"))
    fault = [r for r in recs if r["kind"] == "health_fault"]
    assert [(r["call"], r["action"], r["leaf"]) for r in fault] == \
        [(3, "nan", "gpt.wpe.weight")]
    trips = [r for r in recs if r["kind"] == "health_nan"]
    assert len(trips) == 1 and trips[0]["step"] == 4
    assert "gpt.wpe" in trips[0]["groups"] and trips[0]["loss_nonfinite"]
    assert any(b["leaf"] == "gpt.wpe.weight" for b in trips[0]["leaves"])
    with open(trips[0]["dump"]) as f:
        assert json.load(f)["kind"] == "flight_dump"
    assert mon.health._dumps == 1


def test_overflow_tripwire(monkeypatch, tmp_path):
    with pytest.warns(RuntimeWarning, match="overflow threshold"):
        mon, _, _ = _port_step(monkeypatch, tmp_path, 2,
                               PADDLE_HEALTH_OVERFLOW="1e-12")
    assert mon.health.overflow_trips == 1
    assert mon.registry.counter("health/overflow_trips").value == 1


def test_health_opt_out(monkeypatch, tmp_path):
    mon, _, _ = _port_step(monkeypatch, tmp_path, 2, PADDLE_HEALTH="0")
    assert not mon.health.enabled
    assert not [k for k in mon.registry.names() if k.startswith("health/")]


def test_unsampled_steps_build_no_statistics(monkeypatch, tmp_path):
    built = []
    real = th.HealthPlane.device_stats

    def counting(self, *a, **k):
        built.append(1)
        return real(self, *a, **k)
    monkeypatch.setattr(th.HealthPlane, "device_stats", counting)
    # the eager step (the fast path's program takes its statistics in
    # every call: tests/test_torch_train_graph.py)
    mon, step, _ = _port_step(monkeypatch, tmp_path, 6, sample=3,
                              fast_path=False)
    assert len(built) == 2 and step._health_n == 6
    assert mon.registry.gauge("health/digest_step").value == 6


def test_replayed_forward_taps_once(monkeypatch, tmp_path):
    """Activation RMS under "full" recompute equals the plain step's: the
    replay in the backward does not tap (the named bytes count once)."""
    got = {}
    for gran in ("none", "full"):
        monkeypatch.setenv("PADDLE_HEALTH_SAMPLE", "1")
        _, _, tm = _pair()
        tm.enable_recompute(gran)
        ids, labels = _batch()
        mon = tmon.enable(None)
        step = TrainStep(tm, SGD(learning_rate=0.1,
                                 parameters=tm.parameters()))
        step(torch.from_numpy(ids).long(), torch.from_numpy(labels).long())
        got[gran] = {k: v for k, v in mon.registry.snapshot()["gauges"]
                     .items() if k.startswith(("health/act_rms", "remat/"))}
        tmon.disable()
    acts = {k: v for k, v in got["none"].items() if "act_rms" in k}
    assert set(acts) == {"health/act_rms.attn_qkv",
                         "health/act_rms.attn_context",
                         "health/act_rms.attn_out",
                         "health/act_rms.mlp_hidden"}
    for k, v in acts.items():
        assert got["full"][k] == pytest.approx(v, rel=1e-6), k
    assert got["full"]["remat/regions"] == 2
