"""End-to-end drills of the port's serving fleet plane across processes,
on the CPU: the SIGTERM drain of ``tests/test_serve_drain_e2e.py``, the
HTTP fleet of ``tests/test_router_e2e.py`` and the two-rank fleet stream of
``tests/test_fleet_e2e.py``, with the port's own ``KVServer`` as the
master. The port has no launcher, so the test starts its workers by hand:
this file is also the worker script (``python test_torch_fleet_e2e.py
drain|replica ...``), and the workers import only the port.

Every worker serves the same tiny GPT weights, drawn by the JAX package's
test recipe and carried in an ``.npz`` through ``convert.
load_paddle_state``, so every routed stream is held to the JAX model's
greedy tokens (``greedy_from``). Waits are bounded polls on what the
processes report, never sleeps sized to a margin."""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)
JOB = "fleet-e2e"
PUBLISH_S = 0.25


# ------------------------------------------------------------------ workers


def _load_model(weights):
    from paddle_tpu_torch.convert import load_paddle_state
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
               max_position_embeddings=64, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0)
    m = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    with np.load(weights) as z:
        load_paddle_state(m, {k: z[k] for k in z.files})
    return m.eval()


def _drain_worker(weights, grace_s):
    """A serving process with ``drain_on_preemption``: READY once
    decoding; on SIGTERM the next step begins the drain, late submits
    bounce, and the process exits 0 with a JSON summary."""
    from paddle_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(_load_model(weights), max_slots=2, max_len=48,
                       block_size=8, prefill_chunk=8)
    watcher = eng.drain_on_preemption(grace_s=grace_s)
    rng = np.random.RandomState(0)
    reqs = []

    def refill():
        while eng.queue_depth + eng.active_count < eng.max_slots:
            reqs.append(eng.submit(rng.randint(1, 64, 5).tolist(),
                                   max_new_tokens=24))

    refill()
    while eng.decode_steps == 0:
        eng.step()
    print("READY", flush=True)
    bounced = 0
    deadline = time.time() + 120.0
    while time.time() < deadline:
        if not eng.draining:
            refill()
        else:
            late = eng.submit(rng.randint(1, 64, 5).tolist(),
                              max_new_tokens=4)
            assert late.status == "rejected_draining", late.status
            bounced += 1
        eng.step()
        if eng.drained:
            break
    else:
        print(json.dumps({"error": "drain never completed"}), flush=True)
        return 3
    late = eng.submit([1, 2, 3], max_new_tokens=4)
    assert late.status == "rejected_draining"
    bounced += 1
    statuses = {}
    for r in reqs:
        assert r.finished, r.status
        statuses[r.status] = statuses.get(r.status, 0) + 1
    eng.check_invariants()
    print(json.dumps({"drained": eng.drained, "signal": watcher.signum,
                      "statuses": statuses, "bounced": bounced,
                      "drains": eng.drains, "invariants": "ok"}),
          flush=True)
    return 0


def _replica_worker(weights, name, kv, out_dir):
    """One replica of an HTTP fleet: engine + DoorServer + EngineEndpoint
    on a KVDirectory, with the monitor's fleet plane on (rank and world
    from the env, blobs over the master). READY <addr> once warm; steps
    until drained, then exits 0 with a JSON summary."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.serving import (DecodeEngine, DoorServer,
                                          EngineEndpoint, KVDirectory)
    monitor.enable(os.path.join(out_dir, "run.jsonl"), fleet=True)
    eng = DecodeEngine(_load_model(weights), max_slots=2, max_len=48,
                       block_size=8, prefill_chunk=8, kv_blocks=24)
    warm = eng.submit([60, 61, 62, 63, 60], max_new_tokens=2)
    eng.run()
    assert warm.status == "done"
    lock = threading.Lock()
    ep = EngineEndpoint(eng, name, KVDirectory(endpoint=kv, job_id=JOB),
                        ttl_s=2.0)
    door = DoorServer(eng, lock=lock, endpoint=ep)
    ep.addr = door.address
    door.start()
    ep.publish()
    ep.start_publishing(lock=lock)
    print(f"READY {door.address}", flush=True)
    deadline = time.time() + 240.0
    while time.time() < deadline:
        with lock:
            eng.step()
            done = eng.drained
        if done:
            break
        time.sleep(0.002)
    else:
        print(json.dumps({"error": "never drained"}), flush=True)
        return 3
    # linger so the router's drain wait sees the drained door
    t_end = time.time() + 1.0
    while time.time() < t_end:
        with lock:
            eng.step()
        time.sleep(0.01)
    ep.close()
    door.stop()
    eng.check_invariants()
    summary = {"name": name, "drained": eng.drained,
               "decode_steps": int(eng.decode_steps), "invariants": "ok",
               "fleet": monitor.fleet_state() is not None}
    monitor.disable()
    print(json.dumps(summary), flush=True)
    return 0


# ------------------------------------------------------------ test plumbing


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX model of the shared recipe and its weights as an npz."""
    from test_torch_serving import _model_pair
    jm, tm = _model_pair(seed=17)
    path = str(tmp_path_factory.mktemp("weights") / "tiny.npz")
    np.savez(path, **{name: np.asarray(p.numpy())
                      for name, p in jm.named_parameters()})
    return jm, path


def _env(extra=None):
    env = dict(os.environ)
    for k in ("PADDLE_MONITOR", "PADDLE_SERVE_FAULT", "PADDLE_ROUTE_FAULT",
              "PADDLE_ELASTIC_RESTART", "PADDLE_MONITOR_FLEET",
              "PADDLE_SERVE_HANG_S", "PADDLE_TRACE"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    env.update(extra or {})
    return env


def _spawn(args, env):
    return subprocess.Popen([sys.executable, HERE] + args,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=REPO)


def _wait_ready(proc, timeout=180.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        line = proc.stdout.readline()
        if line.startswith("READY"):
            return line.split()[1:]
        if not line and proc.poll() is not None:
            break
    proc.kill()
    out, _ = proc.communicate()
    raise AssertionError(f"worker never reached READY:\n{out}")


def _summary(proc, timeout=120.0):
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"worker rc={proc.returncode}:\n{out}"
    tail = [l for l in out.splitlines() if l.startswith("{")]
    assert tail, out
    return json.loads(tail[-1])


class _req:
    def __init__(self, ticket):
        self.prompt = ticket.prompt
        self.output_tokens = ticket.tokens


def _read_jsonl(path):
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass              # a torn tail
    return out


# -------------------------------------------------------------------- tests


def test_sigterm_drains_and_exits_zero(weights):
    _, path = weights
    proc = _spawn(["drain", path, "60"], _env())
    try:
        _wait_ready(proc)
        proc.send_signal(signal.SIGTERM)
        summary = _summary(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert summary["drained"] is True and summary["invariants"] == "ok"
    assert summary["signal"] == int(signal.SIGTERM)
    assert summary["drains"] == 1 and summary["bounced"] >= 1
    assert summary["statuses"].get("done", 0) >= 1
    assert set(summary["statuses"]) <= {"done", "expired",
                                        "rejected_draining"}


def test_http_fleet_kill_requeue_drain_and_fleet_stream(weights, tmp_path):
    """Two replicas over HTTP behind the router (this process): SIGKILL
    rank 1 mid-decode -> it goes stale, is ejected, its tickets requeue
    under the same ids and every ticket ends done with the JAX model's
    greedy tokens; a duplicate submit at the survivor's door answers from
    its dedup window; rank 0's ``run.fleet.jsonl`` held both ranks and
    then marks rank 1 stale; the survivor drains over HTTP and exits 0."""
    from paddle_tpu_torch.distributed.launch.master import KVServer
    from paddle_tpu_torch.serving import (KVDirectory, RouteFaultSchedule,
                                          Router)
    from test_torch_serving import greedy_from
    jm, path = weights
    srv = KVServer(0, host="127.0.0.1")
    srv.start()
    kv = srv.address
    procs = {}
    try:
        for rank, name in enumerate(("w0", "w1")):
            out_dir = str(tmp_path / name)
            os.makedirs(out_dir)
            procs[name] = _spawn(
                ["replica", path, name, kv, out_dir],
                _env({"PADDLE_TRAINER_ID": str(rank),
                      "PADDLE_TRAINERS_NUM": "2",
                      "PADDLE_MONITOR_MASTER": kv, "PADDLE_JOB_ID": JOB,
                      "PADDLE_MONITOR_PUBLISH_S": str(PUBLISH_S)}))
        for proc in procs.values():
            _wait_ready(proc)
        router = Router(KVDirectory(endpoint=kv, job_id=JOB),
                        policy="round_robin", eject_after=2,
                        fault_schedule=RouteFaultSchedule.parse(""))
        deadline = time.time() + 60
        while sorted(router.refresh()) != ["w0", "w1"]:
            assert time.time() < deadline, router.refresh()
            time.sleep(0.1)
        fleet = str(tmp_path / "w0" / "run.fleet.jsonl")
        # both ranks reach rank 0's stream before anything dies
        deadline = time.time() + 60
        while not any(set(r.get("ranks") or []) >= {0, 1}
                      for r in _read_jsonl(fleet)
                      if r.get("kind") == "fleet"):
            assert time.time() < deadline, _read_jsonl(fleet)[-3:]
            time.sleep(0.1)
        rng = np.random.RandomState(7)
        tickets = [router.route(rng.randint(1, 60, 6).tolist(),
                                max_new_tokens=12, request_id=f"e2e-{i}")
                   for i in range(4)]
        assert sorted(t.engine for t in tickets) == ["w0", "w0", "w1", "w1"]
        procs["w1"].send_signal(signal.SIGKILL)
        procs["w1"].wait(timeout=30)
        router.join(tickets, step=lambda: time.sleep(0.02), timeout_s=180)
        assert [t.status for t in tickets] == ["done"] * 4, \
            [(t.status, t.error) for t in tickets]
        for t in tickets:
            assert t.engine == "w0"
            assert t.tokens == greedy_from(jm, _req(t))
        assert "w1" in router._ejected and router.counters["ejections"] == 1
        assert router.counters["requeues"] >= 2
        assert router.counters["rejected"] == 0
        moved = next(t for t in tickets if t.requeues)
        view = router._clients["w0"].submit(moved.prompt, 12, None, moved.id)
        assert view["status"] == "done" and view["tokens"] == moved.tokens
        # rank 0's aggregator marks the killed rank stale
        deadline = time.time() + 60
        while not any(1 in (r.get("stale") or [])
                      for r in _read_jsonl(fleet)
                      if r.get("kind") == "fleet"):
            assert time.time() < deadline, _read_jsonl(fleet)[-3:]
            time.sleep(0.1)
        recs = _read_jsonl(fleet)
        assert [w for w in recs if w.get("kind") == "fleet_warn"
                and w.get("warn") == "stale" and w.get("rank") == 1]
        served = [r for r in recs if r.get("kind") == "fleet" and
                  (r["metrics"]["counters"].get("serve/tokens") or {})]
        assert served, "the replicas' serve/* counters never aggregated"
        # drain the survivor over HTTP: it exits 0 with clean invariants
        router._clients["w0"].begin_drain(10.0)
        summary = _summary(procs["w0"])
        assert summary["drained"] and summary["invariants"] == "ok"
        assert summary["fleet"] is True
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        srv.stop()


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "drain":
        sys.exit(_drain_worker(sys.argv[2], float(sys.argv[3])))
    sys.exit(_replica_worker(*sys.argv[2:6]))
