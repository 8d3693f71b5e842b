"""The port's single-card checkpointing (paddle_tpu_torch.distributed
.checkpoint, .preemption, utils.retry, TrainStep's four checkpoint
methods, the optimizer's state_dict and convert_paddle_optimizer_state) on
the CPU, against the JAX package's contract:

* the commit protocol: manifests, only committed snapshots visible,
  checksum and truncation quarantine with fall-back, explicit-step
  diagnostics, rotted manifest fields, the re-save and set-aside windows,
  emergency size-only manifests, pruning, retry and its backoff, async
  semantics and error surfacing, the scaler in ``extra``, a multi-layer
  optimizer round trip without cross-wiring, the preemption watcher on and
  off the main thread (the counterparts of tests/test_checkpoint_ft.py's
  cases outside hapi);
* the kill-9 drill of tests/test_kill_resume.py: a training worker (this
  file run with ``--worker``) SIGKILLed between the payload's rename and
  its COMMIT resumes from the last committed snapshot and ends bit for bit
  where an uninterrupted run does;
* the rollback drill of tests/test_health.py: a planted loss spike rolls
  back to the snapshot committed before it, the exact step-6 weights, then
  the tail;
* save and resume of tiny GPT and LLaMA runs bit for bit, and a JAX run's
  parameters and optimizer state carried into the port continuing the JAX
  trajectory within tests/test_torch_train.py's tolerances.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import monitor
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.preemption import PreemptionWatcher
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as port_lr
from paddle_tpu_torch.utils.retry import RetryPolicy, backoff_delay

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
_HEALTH_ENV = ("PADDLE_HEALTH", "PADDLE_HEALTH_SAMPLE",
               "PADDLE_HEALTH_SPIKE_MIN", "PADDLE_HEALTH_FAULT",
               "PADDLE_CKPT_FAULT")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _HEALTH_ENV:
        monkeypatch.delenv(k, raising=False)
    monitor.disable()
    yield
    monitor.disable()


@pytest.fixture
def mon():
    m = monitor.enable(None)  # flight-recorder-only session, no sink file
    yield m
    monitor.disable()


def _net(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Linear(4, 4)


def _train_and_save(directory, steps, keep=3, seed=0):
    """Train a tiny net, snapshotting at each step in ``steps``; returns the
    net, its optimizer and {step: weight} at each save."""
    net = _net(seed)
    opt = Adam(learning_rate=1e-2, parameters=net.parameters())
    x = torch.ones(2, 4)
    seen = {}
    for step in steps:
        (net(x) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
        ckpt.save_checkpoint(str(directory), step, model=net, optimizer=opt,
                             extra={"lr": 0.01}, keep=keep)
        seen[step] = net.weight.detach().clone()
    return net, opt, seen


def _set_weight(net, value):
    with torch.no_grad():
        net.weight.fill_(value)


# ----------------------------------------------------------- commit protocol


def test_commit_manifest_and_roundtrip(tmp_path):
    net, opt, seen = _train_and_save(tmp_path, [7], keep=3)
    base = tmp_path / "step_7"
    assert base.is_dir() and not (tmp_path / "step_7.tmp").exists()
    m = ckpt.read_manifest(str(base))
    assert m["schema"] == ckpt.SCHEMA_VERSION and m["step"] == 7
    assert m["world_size"] >= 1
    assert sorted(m["files"]) == ["extra.pt", "model/state.pt",
                                  "optimizer.pt"]
    for meta in m["files"].values():
        assert set(meta) == {"sha256", "bytes"}
    assert ckpt.verify_snapshot(str(base)) == []

    net2 = _net(1)
    info = ckpt.load_checkpoint(str(tmp_path), model=net2)
    assert info["step"] == 7 and info["lr"] == 0.01
    assert torch.equal(net2.weight, seen[7])


def test_latest_and_resume_only_see_committed(tmp_path, mon):
    _train_and_save(tmp_path, [10])
    # a torn snapshot (no COMMIT) with a HIGHER step, plus an in-flight tmp
    torn = tmp_path / "step_99"
    torn.mkdir()
    (torn / "garbage.bin").write_bytes(b"\x00" * 64)
    (tmp_path / "step_50.tmp").mkdir()

    assert ckpt.latest_checkpoint(str(tmp_path)) == 10
    assert ckpt.committed_steps(str(tmp_path)) == [10]

    info = ckpt.load_checkpoint(str(tmp_path), model=_net(1))
    assert info["step"] == 10
    # the torn dir was quarantined out of the resume scan; tmp left alone
    assert not torn.exists()
    assert (tmp_path / "step_99.corrupt").is_dir()
    assert (tmp_path / "step_50.tmp").is_dir()
    assert mon.registry.counter("ckpt/corrupt_skipped").value >= 1


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_damaged_payload_quarantined_falls_back(tmp_path, mon, damage):
    """A committed snapshot whose payload rotted (a flipped byte: checksum
    mismatch) or lost its tail (truncation: the size check) fails
    verification, is quarantined, and resume falls back to the previous
    committed one."""
    _, _, seen = _train_and_save(tmp_path, [1, 2])
    base = tmp_path / "step_2"
    m = ckpt.read_manifest(str(base))
    rel = max(m["files"], key=lambda r: m["files"][r]["bytes"])
    victim = base / rel
    data = victim.read_bytes()
    victim.write_bytes(b"\xff" + data[1:] if damage == "flip"
                       else data[:-1])
    problems = ckpt.verify_snapshot(str(base))
    assert problems and ("checksum mismatch" if damage == "flip"
                         else "truncated") in problems[0]

    assert ckpt.latest_checkpoint(str(tmp_path)) == 2  # committed, but bad
    net2 = _net(1)
    info = ckpt.load_checkpoint(str(tmp_path), model=net2)
    assert info["step"] == 1
    assert torch.equal(net2.weight, seen[1])
    assert (tmp_path / "step_2.corrupt").is_dir()
    assert mon.registry.counter("ckpt/corrupt_skipped").value >= 1
    assert mon.registry.counter("ckpt/resumes").value == 1


def test_explicit_step_diagnostics(tmp_path):
    _train_and_save(tmp_path, [5])
    with pytest.raises(ckpt.CheckpointError, match=r"step_8 does not exist"):
        ckpt.load_checkpoint(str(tmp_path), step=8)
    # a partial snapshot: the directory exists, nothing inside (torn save)
    (tmp_path / "step_7").mkdir()
    with pytest.raises(ckpt.CheckpointError) as ei:
        ckpt.load_checkpoint(str(tmp_path), model=_net(1), step=7)
    msg = str(ei.value)
    assert "step_7" in msg and ckpt.MANIFEST_NAME in msg and "model/" in msg
    # committed but failing verification
    m = ckpt.read_manifest(str(tmp_path / "step_5"))
    victim = tmp_path / "step_5" / sorted(m["files"])[0]
    victim.write_bytes(victim.read_bytes() + b"x")
    with pytest.raises(ckpt.CheckpointError, match="verification"):
        ckpt.load_checkpoint(str(tmp_path), step=5)


def test_rotted_manifest_fields_treated_as_torn(tmp_path):
    """A COMMIT file that still parses as JSON but has rotted field types
    reads as uncommitted: it neither crashes the resume scan nor the JAX
    package's inspection tool, which reads the port's directories too."""
    _train_and_save(tmp_path, [1, 2])
    (tmp_path / "step_2" / ckpt.MANIFEST_NAME).write_text(
        json.dumps({"schema": "x", "step": "abc", "files": {}}))
    assert ckpt.read_manifest(str(tmp_path / "step_2")) is None
    assert ckpt.latest_checkpoint(str(tmp_path)) == 1
    assert ckpt.load_checkpoint(str(tmp_path), model=_net(1))["step"] == 1
    tool = os.path.join(REPO, "tools", "ckpt_inspect.py")
    r = subprocess.run([sys.executable, tool, str(tmp_path), "--json"],
                       capture_output=True, text=True, timeout=60)
    rows = {x["name"]: x["status"]
            for x in json.loads(r.stdout)["snapshots"]}
    assert rows.get("step_2.corrupt", rows.get("step_2")) in ("TORN",
                                                              "CORRUPT")
    assert rows["step_1"] == "COMMITTED"


def test_explicit_verify_false_restores_unmanifested_snapshot(tmp_path):
    """The operator's override: a manifest-less snapshot restores through
    an explicit step with verify=False."""
    _, _, seen = _train_and_save(tmp_path, [5])
    os.remove(tmp_path / "step_5" / ckpt.MANIFEST_NAME)
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    with pytest.raises(ckpt.CheckpointError, match="verify=False"):
        ckpt.load_checkpoint(str(tmp_path), step=5)
    net2 = _net(1)
    info = ckpt.load_checkpoint(str(tmp_path), model=net2, step=5,
                                verify=False)
    assert info["step"] == 5 and torch.equal(net2.weight, seen[5])


def test_resave_existing_step_replaces_and_cleans_aside(tmp_path):
    """Re-saving an existing step (after a rollback) publishes the new
    payload and leaves no .old/.tmp residue once committed."""
    net, _, _ = _train_and_save(tmp_path, [5])
    _set_weight(net, 7.0)
    ckpt.save_checkpoint(str(tmp_path), 5, model=net)
    assert sorted(os.listdir(tmp_path)) == ["step_5"]
    assert ckpt.verify_snapshot(str(tmp_path / "step_5")) == []
    net2 = _net(1)
    ckpt.load_checkpoint(str(tmp_path), model=net2, step=5)
    assert torch.equal(net2.weight, torch.full((4, 4), 7.0))


def test_resave_retry_never_destroys_committed_original(tmp_path,
                                                        monkeypatch):
    """Re-saving a committed step with a flaky COMMIT write: the retry loop
    never eats the parked original, and a persistent failure leaves the
    original committed content in place."""
    net, _, _ = _train_and_save(tmp_path, [5])
    _set_weight(net, 7.0)
    real = ckpt._fs.replace

    def flaky_commit(src, dst, fails={"n": 1}):
        if dst.endswith(ckpt.MANIFEST_NAME) and fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient COMMIT write failure")
        return real(src, dst)

    monkeypatch.setattr(ckpt._fs, "replace", flaky_commit)
    policy = RetryPolicy(max_attempts=3, base_delay=0.001, jitter=0.0)
    ckpt.save_checkpoint(str(tmp_path), 5, model=net, retry=policy)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["step_5"]
    net2 = _net(1)
    ckpt.load_checkpoint(str(tmp_path), model=net2, step=5)
    assert torch.equal(net2.weight, torch.full((4, 4), 7.0))

    def always_fail_commit(src, dst):
        if dst.endswith(ckpt.MANIFEST_NAME):
            raise OSError("disk on fire")
        return real(src, dst)

    _set_weight(net, 9.0)
    monkeypatch.setattr(ckpt._fs, "replace", always_fail_commit)
    with pytest.raises(OSError, match="disk on fire"):
        ckpt.save_checkpoint(str(tmp_path), 5, model=net,
                             retry=RetryPolicy(max_attempts=2,
                                               base_delay=0.001))
    monkeypatch.undo()
    assert ckpt.latest_checkpoint(str(tmp_path)) == 5
    net3 = _net(1)
    ckpt.load_checkpoint(str(tmp_path), model=net3, step=5)
    assert torch.equal(net3.weight, torch.full((4, 4), 7.0))


def test_crash_in_set_aside_window_recovers(tmp_path):
    """A committed step_N parked at step_N.old (a re-save died before its
    replacement committed) is restored by the resume scan; the torn
    replacement is quarantined."""
    _, _, seen = _train_and_save(tmp_path, [5])
    os.rename(tmp_path / "step_5", tmp_path / "step_5.old")
    torn = tmp_path / "step_5"
    torn.mkdir()
    (torn / "half").write_bytes(b"x")
    assert ckpt.latest_checkpoint(str(tmp_path)) == 5  # recovered
    assert not (tmp_path / "step_5.old").exists()
    assert any(d.startswith("step_5.corrupt") for d in os.listdir(tmp_path))
    net2 = _net(1)
    assert ckpt.load_checkpoint(str(tmp_path), model=net2)["step"] == 5
    assert torch.equal(net2.weight, seen[5])


def test_emergency_manifest_is_size_only(tmp_path, mon):
    """Emergency saves skip the payload's re-hash (the grace window is for
    writing): the manifest records sizes only and still verifies and
    loads; the monitor counts an emergency save."""
    net = _net(0)
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(4, model=net, block=True, _mode="emergency")
    m = ckpt.read_manifest(str(tmp_path / "step_4"))
    assert m["files"] and all(f["sha256"] is None for f in m["files"].values())
    assert ckpt.verify_snapshot(str(tmp_path / "step_4")) == []
    assert ckpt.load_checkpoint(str(tmp_path), model=_net(1))["step"] == 4
    assert mon.registry.counter("ckpt/emergency_saves").value == 1


def test_model_missing_payload_diagnostic_and_skip(tmp_path):
    """A committed snapshot saved without a model fails an explicit model
    restore with a named diagnostic; auto-resume skips past it to an older
    snapshot with a model payload and leaves it intact; without a model
    asked for, it is the newest loadable one."""
    net = _net(0)
    opt = Adam(learning_rate=1e-2, parameters=net.parameters())
    ckpt.save_checkpoint(str(tmp_path), 1, model=net, optimizer=opt)
    ckpt.save_checkpoint(str(tmp_path), 2, optimizer=opt)  # model-less
    with pytest.raises(ckpt.CheckpointError, match=r"no 'model/' payload"):
        ckpt.load_checkpoint(str(tmp_path), model=_net(1), step=2)
    assert ckpt.load_checkpoint(str(tmp_path), model=_net(1))["step"] == 1
    assert (tmp_path / "step_2").is_dir()           # intact, not .corrupt
    assert ckpt.load_checkpoint(str(tmp_path))["step"] == 2


def test_shape_mismatch_refused(tmp_path):
    """A snapshot that does not fit the network (another shape, or an
    entry missing) raises ValueError naming the key, never restores."""
    torch.manual_seed(0)
    ckpt.save_checkpoint(str(tmp_path), 1, model=torch.nn.Linear(8, 8))
    small = torch.nn.Linear(4, 4)
    w = small.weight.detach().clone()
    with pytest.raises(ValueError, match="'weight' is"):
        ckpt.load_checkpoint(str(tmp_path), model=small, step=1)
    with pytest.raises(ValueError, match="no entry"):
        ckpt.load_checkpoint(str(tmp_path), model=torch.nn.Sequential(
            torch.nn.Linear(8, 8)), step=1)
    assert torch.equal(small.weight, w)


def test_pod_commit_not_ported(tmp_path, monkeypatch):
    """The multi-rank commit raises naming the roadmap item: an explicit
    coordinator, or the launcher's pod environment; coordinator=False
    commits this rank's directory alone."""
    net = _net(0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ckpt.save_checkpoint(str(tmp_path), 1, model=net,
                             coordinator=object())
    monkeypatch.setenv("PADDLE_CKPT_MASTER", "127.0.0.1:1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ckpt.AsyncCheckpointer(str(tmp_path))
    ckpt.save_checkpoint(str(tmp_path), 1, model=net, coordinator=False)
    assert ckpt.latest_checkpoint(str(tmp_path)) == 1


def test_prune_only_committed_snapshots(tmp_path):
    torn = tmp_path / "step_2"
    torn.mkdir()
    (torn / "half-written").write_bytes(b"x")
    (tmp_path / "step_1.tmp").mkdir()
    quarantined = tmp_path / "step_0.corrupt"
    quarantined.mkdir()

    _train_and_save(tmp_path, [10, 20, 30, 40], keep=2)
    assert ckpt.committed_steps(str(tmp_path)) == [30, 40]
    assert torn.is_dir() and (tmp_path / "step_1.tmp").is_dir() \
        and quarantined.is_dir()
    # and the snapshot just written never prunes itself, even at keep=1
    _train_and_save(tmp_path / "k1", [1], keep=1)
    assert ckpt.committed_steps(str(tmp_path / "k1")) == [1]


# --------------------------------------------------------------------- retry


def test_backoff_delay_math():
    rng = __import__("random").Random(0)
    d = [backoff_delay(a, 0.1, cap=1.0, jitter=0.0) for a in (1, 2, 3, 4, 5)]
    assert d == [0.1, 0.2, 0.4, 0.8, 1.0]  # doubles, then the cap
    dj = backoff_delay(1, 0.1, jitter=0.5, rng=rng)
    assert 0.1 <= dj <= 0.15001
    assert backoff_delay(3, 0.0) == 0.0


@pytest.mark.parametrize("fails", [2, "always"])
def test_retry_transient_and_exhausted(tmp_path, mon, monkeypatch, fails):
    """Two transient failures of the publishing rename are retried (the
    monitor counts 2 retries and 1 save); a persistent one exhausts the
    policy, raises and leaves nothing committed, and the next save
    overwrites its leftovers."""
    real = ckpt._fs.replace
    left = {"n": fails}

    def flaky(src, dst):
        if left["n"] == "always" or left["n"] > 0:
            if left["n"] != "always":
                left["n"] -= 1
            raise OSError("injected fs error")
        return real(src, dst)

    monkeypatch.setattr(ckpt._fs, "replace", flaky)
    policy = RetryPolicy(max_attempts=4 if fails == 2 else 2,
                         base_delay=0.001, jitter=0.0)
    net = _net(0)
    if fails == 2:
        ckpt.save_checkpoint(str(tmp_path), 1, model=net, retry=policy)
        assert mon.registry.counter("ckpt/retries").value == 2
        assert mon.registry.counter("ckpt/saves").value == 1
    else:
        with pytest.raises(OSError, match="injected fs error"):
            ckpt.save_checkpoint(str(tmp_path), 1, model=net, retry=policy)
        assert ckpt.latest_checkpoint(str(tmp_path)) is None
        monkeypatch.undo()
        ckpt.save_checkpoint(str(tmp_path), 1, model=net)
    assert ckpt.latest_checkpoint(str(tmp_path)) == 1
    assert ckpt.verify_snapshot(str(tmp_path / "step_1")) == []


# --------------------------------------------------------------- async writes


def test_async_checkpointer_snapshot_semantics(tmp_path):
    """save() copies the state before returning: changing the weights
    while the write may be in flight does not reach the snapshot."""
    net = _net(0)
    w_at_save = net.weight.detach().clone()
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    ac.save(1, model=net)
    _set_weight(net, 0.0)
    ac.wait()
    assert ac.last_path.endswith("step_1") and ac.last_bytes == 4 * 20
    assert not ac.in_flight()
    assert ckpt.verify_snapshot(str(tmp_path / "step_1")) == []
    net2 = _net(1)
    assert ckpt.load_checkpoint(str(tmp_path), model=net2)["step"] == 1
    assert torch.equal(net2.weight, w_at_save)


def test_async_one_in_flight_and_error_surfacing(tmp_path, monkeypatch):
    net = _net(0)
    ac = ckpt.AsyncCheckpointer(
        str(tmp_path), retry=RetryPolicy(max_attempts=1, base_delay=0.001))

    def always_fail(src, dst):
        raise OSError("injected async write failure")

    monkeypatch.setattr(ckpt._fs, "replace", always_fail)
    ac.save(1, model=net)  # returns at once; the WRITE will fail
    with pytest.raises(OSError, match="injected async write failure"):
        ac.save(2, model=net)  # the barrier surfaces step 1's error
    monkeypatch.undo()
    ac.save(3, model=net)
    ac.close()  # the shutdown barrier: no pending error
    assert ckpt.latest_checkpoint(str(tmp_path)) == 3


def test_async_grad_scaler_state_rides_extra(tmp_path):
    net = _net(0)
    scaler = GradScaler(init_loss_scaling=512.0)
    scaler._good_steps = 7
    with ckpt.AsyncCheckpointer(str(tmp_path)) as ac:
        ac.save(5, model=net, grad_scaler=scaler, extra={"note": "hi"})
    scaler2 = GradScaler()
    info = ckpt.load_checkpoint(str(tmp_path), grad_scaler=scaler2)
    assert info["step"] == 5 and info["note"] == "hi"
    assert scaler2._scale == 512.0 and scaler2._good_steps == 7


def test_optimizer_state_roundtrip_multilayer_no_crosswire(tmp_path):
    """Two Linears named alike ("linear.weight" twice) get distinct keys,
    so a restore cannot cross-wire their moments; the restored state
    trains on bit for bit; moments are copied into the live tensors in
    place."""
    def build(seed):
        torch.manual_seed(seed)
        net = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.ReLU(),
                                  torch.nn.Linear(5, 2))
        for p in net.parameters():
            p.param_name = "linear." + ("weight" if p.dim() == 2 else "bias")
        return net, Adam(learning_rate=1e-2, parameters=net.parameters())

    net, opt = build(0)
    x = torch.ones(2, 3)
    for _ in range(3):
        (net(x) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
    keys = opt._param_keys()
    assert keys == ["linear.weight__0", "linear.bias__1", "linear.weight__2",
                    "linear.bias__3"]
    ckpt.save_checkpoint(str(tmp_path), 3, model=net, optimizer=opt)

    net2, opt2 = build(1)
    (net2(x) ** 2).mean().backward()     # states exist before the restore
    opt2.step()
    opt2.clear_grad()
    live = [opt2._accumulators[id(p)]["moment1"] for p in net2.parameters()]
    ckpt.load_checkpoint(str(tmp_path), model=net2, optimizer=opt2)
    assert opt2._step_count == 3
    for p, p2, t in zip(net.parameters(), net2.parameters(), live):
        s, s2 = opt._accumulators[id(p)], opt2._accumulators[id(p2)]
        assert s2["moment1"] is t                   # restored in place
        for name in opt._state_names:
            assert torch.equal(s[name], s2[name])
    for n, o in ((net, opt), (net2, opt2)):
        (n(x) ** 2).mean().backward()
        o.step()
    for p, p2 in zip(net.parameters(), net2.parameters()):
        assert torch.equal(p, p2)


# ---------------------------------------------------------------- preemption


@pytest.mark.parametrize("where", ["main", "thread"])
def test_preemption_watcher(where):
    """On the main thread the watcher records SIGTERM (and the monitor
    counts it at ``requested()``) and restores the previous handler on
    exit; off it, install() is a watcher that never fires."""
    if where == "thread":
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "w", PreemptionWatcher().install()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert out["w"].installed is False and not out["w"].requested()
        return
    mon = monitor.enable(None)
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionWatcher() as w:
        assert w.installed and not w.requested()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not w.requested() and time.time() < deadline:
            time.sleep(0.01)
        assert w.requested() and w.signum == signal.SIGTERM
        assert mon.registry.counter("preempt/signals").value == 1
        w.clear()
        assert not w.requested()
    assert signal.getsignal(signal.SIGTERM) == prev


# --------------------------------------------------- TrainStep save / resume


def _tiny_gpt(seed):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    return GPTForCausalLM(gpt_tiny(hidden_dropout_prob=0.0,
                                   attention_dropout_prob=0.0),
                          device="cpu", seed=seed).train()


def _tiny_llama(seed):
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    return LlamaForCausalLM(llama_tiny(), device="cpu", seed=seed).train()


def _train_state(model, opt):
    """Every parameter, moment, master and the step count, cloned."""
    out = {f"p:{n}": p.detach().clone() for n, p in model.named_parameters()}
    for i, p in enumerate(opt._parameter_list):
        for k, t in opt._accumulators[id(p)].items():
            out[f"{k}:{i}"] = t.clone()
        if id(p) in opt._master_weights:
            out[f"master:{i}"] = opt._master_weights[id(p)].clone()
    out["step"] = opt._step_count
    return out


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_train_step_resume_is_bitwise(tmp_path, family):
    """4 steps straight against 2 steps, an async save, a fresh model,
    optimizer (with a scheduler) and TrainStep from another seed, a load
    and 2 more steps: the losses, every parameter, moment and master, the
    step count and the scheduler's rate equal bit for bit (bf16 parameters
    with fp32 masters)."""
    make = _tiny_gpt if family == "gpt" else _tiny_llama
    rs = np.random.RandomState(3)
    batches = [torch.from_numpy(rs.randint(0, 256, (2, 32))).long()
               for _ in range(4)]

    def run(seed, steps, save=None, load=None):
        model = make(seed).to(torch.bfloat16)
        sched = port_lr.StepDecay(1e-3, step_size=1, gamma=0.9)
        opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                    multi_precision=True)
        step = TrainStep(model, opt)
        if load is not None:
            assert step.load_checkpoint(load)["step"] == 2
        losses = []
        for ids in steps:
            losses.append(step(ids, ids))
            sched.step()
        if save is not None:
            step.save_checkpoint(save, 2)
            step.wait_checkpoint()
        return losses, _train_state(model, opt), sched.last_lr

    straight, want, lr = run(0, batches)
    first, _, _ = run(0, batches[:2], save=str(tmp_path))
    second, got, lr2 = run(7, batches[2:], load=str(tmp_path))
    assert all(torch.equal(a, b) for a, b in zip(first + second, straight))
    assert got["step"] == want["step"] == 4 and lr2 == lr
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]),
                           torch.as_tensor(want[k])), k


# ------------------------------------------------------------ kill-9 drill


def _worker(workdir, steps, save_every):
    """A deterministic raw TrainStep loop for the kill-and-resume drill
    (data is a function of the step index): resumes from the newest
    committed snapshot, appends one JSON loss record a step, snapshots
    every ``save_every`` steps (``block=True``) and saves its final weight.
    ``PADDLE_CKPT_FAULT`` kills it mid-save."""
    ckpt_dir = os.path.join(workdir, "ckpt")
    torch.manual_seed(0)
    net = torch.nn.Linear(8, 8)
    opt = Adam(learning_rate=1e-2, parameters=net.parameters())
    step_fn = TrainStep(net, opt, loss_fn=lambda out: (out ** 2).mean())
    start = 0
    info = step_fn.load_checkpoint(ckpt_dir)
    if info is not None:
        start = int(info["step"])
        print(f"resumed from {start}", flush=True)
    with open(os.path.join(workdir, "losses.jsonl"), "a") as f:
        for step in range(start + 1, steps + 1):
            x = torch.from_numpy(
                np.random.RandomState(step).randn(4, 8).astype("float32"))
            loss = step_fn(x)
            f.write(json.dumps({"step": step, "loss": loss.item()}) + "\n")
            f.flush()
            if step % save_every == 0:
                step_fn.save_checkpoint(ckpt_dir, step, block=True)
    torch.save(net.weight.detach(), os.path.join(workdir, "final.pt"))


def _losses(workdir):
    """step -> loss, the LAST record winning (a resumed run re-appends the
    steps after its snapshot)."""
    out = {}
    with open(os.path.join(workdir, "losses.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out[rec["step"]] = rec["loss"]
    return out


def _run_worker(workdir, fault=None):
    env = dict(os.environ)
    env.pop("PADDLE_CKPT_FAULT", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    if fault:
        env["PADDLE_CKPT_FAULT"] = fault
    os.makedirs(workdir, exist_ok=True)
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", workdir],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)


def test_kill9_mid_save_resumes_from_committed(tmp_path):
    ref_dir = str(tmp_path / "ref")
    os.makedirs(ref_dir)
    _worker(ref_dir, 12, 3)                     # the uninterrupted run
    ref_losses = _losses(ref_dir)
    assert sorted(ref_losses) == list(range(1, 13))

    # SIGKILL mid-save at step 9, AFTER the payload's rename and BEFORE
    # its COMMIT manifest: the nastiest torn-write window
    kill_dir = str(tmp_path / "kill")
    rk = _run_worker(kill_dir, fault="die_before_commit:9")
    assert rk.returncode == -signal.SIGKILL, rk.stdout + rk.stderr
    ck = os.path.join(kill_dir, "ckpt")
    torn = os.path.join(ck, "step_9")
    assert os.path.isdir(torn)
    assert not os.path.exists(os.path.join(torn, ckpt.MANIFEST_NAME))
    assert ckpt.latest_checkpoint(ck) == 6      # the torn one is invisible

    rr = _run_worker(kill_dir)
    assert rr.returncode == 0, rr.stdout + rr.stderr
    assert "resumed from 6" in rr.stdout
    assert any(d.startswith("step_9.corrupt") for d in os.listdir(ck))
    res_losses = _losses(kill_dir)
    for step in range(7, 13):
        assert res_losses[step] == ref_losses[step], step
    assert torch.equal(torch.load(os.path.join(kill_dir, "final.pt")),
                       torch.load(os.path.join(ref_dir, "final.pt")))


# ------------------------------------------------------ spike rollback drill


class _WithLoss(torch.nn.Module):
    """Returns its own loss; two modules, so the health plane sees two
    leaf groups (tests/test_health.py's model)."""

    def __init__(self, din=8, hid=16):
        super().__init__()
        self.a = torch.nn.Linear(din, hid)
        self.b = torch.nn.Linear(hid, din)

    def forward(self, x):
        return ((self.b((self.a(x)) ** 2)) ** 2).mean()


def _make(seed=0):
    torch.manual_seed(seed)
    m = _WithLoss()
    return m, AdamW(learning_rate=1e-2, parameters=m.parameters())


def _inputs(seed):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(4, 8).astype("float32"))


def test_spike_rollback_resumes_matching_control(tmp_path, monkeypatch):
    """A planted loss spike (scale@param:8) rolls back to the snapshot
    committed before it (step 6), leaving the exact step-6 weights live;
    training on the NEXT batches then matches an uninterrupted control
    over the same schedule (batches 1..6, then 9..11)."""
    ckdir = str(tmp_path / "ck")
    m_c, opt_c = _make()
    step_c = TrainStep(m_c, opt_c)
    for s in range(6):
        step_c(_inputs(s))
    control_tail = [step_c(_inputs(s)).item() for s in (8, 9, 10)]
    w_control = {n: p.detach().clone() for n, p in m_c.named_parameters()}

    monkeypatch.setenv("PADDLE_HEALTH_SAMPLE", "1")
    monkeypatch.setenv("PADDLE_HEALTH_SPIKE_MIN", "4")
    monkeypatch.setenv("PADDLE_HEALTH_FAULT", "scale@param:8:8")
    mon = monitor.enable(str(tmp_path / "run.jsonl"))
    m, opt = _make()
    step = TrainStep(m, opt)
    mon.health.rollback_hook = lambda sn, info: \
        step.rollback_last_commit(ckdir, before_step=sn)
    w6 = None
    with pytest.warns(RuntimeWarning, match="loss spike"):
        for s in range(8):                   # steps 1..8 on seeds 0..7
            step(_inputs(s))
            n = s + 1
            if n in (2, 4, 6):
                step.save_checkpoint(ckdir, step=n, block=True)
                if n == 6:
                    w6 = {k: p.detach().clone()
                          for k, p in m.named_parameters()}
    assert mon.health.spikes == 1
    assert mon.registry.counter("health/rollbacks").value == 1
    for k, p in m.named_parameters():
        assert torch.equal(p, w6[k]), k
    tail = [step(_inputs(s)).item() for s in (8, 9, 10)]
    np.testing.assert_allclose(tail, control_tail, rtol=1e-4)
    for k, p in m.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), w_control[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


# ------------------------------------------------------ JAX state, carried


def _jax_numpy_state(opt_j):
    """A JAX optimizer's state_dict with its tensors as numpy arrays."""
    def arr(v):
        return np.asarray(v.numpy(), np.float32) if hasattr(v, "numpy") \
            else v
    sd = opt_j.state_dict()
    return {k: ({kk: arr(vv) for kk, vv in v.items()}
                if k == "master_weights" else arr(v))
            for k, v in sd.items()}


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_jax_run_continues_in_the_port(family):
    """A tiny GPT / LLaMA trains 3 steps in the JAX package (AdamW, a
    StepDecay scheduler); its parameters (convert_paddle_state) and its
    optimizer's state (convert_paddle_optimizer_state: moments transposed
    with their Linear weights, the scheduler's state, the step count) go
    into the port, and both packages take 2 more steps: the port's losses
    within rtol 1e-5 of the JAX package's and its parameters within atol
    5e-6 wherever the continuation's first gradient is live (6e-3
    elsewhere), tests/test_torch_train.py's trajectory tolerances."""
    import paddle_tpu as paddle
    from paddle_tpu.optimizer import lr as jax_lr
    from paddle_tpu_torch.convert import (convert_paddle_optimizer_state,
                                          convert_paddle_state)
    if family == "gpt":
        from test_torch_train import _batch, _pair
    else:
        from test_torch_llama import _batch, _pair
    jm, _, tm = _pair()
    jm.train()
    tm.train()
    ids, labels = _batch()
    sched_j = jax_lr.StepDecay(1e-3, step_size=1, gamma=0.9)
    opt_j = paddle.optimizer.AdamW(learning_rate=sched_j, weight_decay=0.01,
                                   parameters=jm.parameters())
    step_j = paddle.jit.TrainStep(jm, opt_j)

    def jax_step():
        loss = float(step_j(paddle.to_tensor(ids), paddle.to_tensor(labels)))
        sched_j.step()
        return loss

    for _ in range(3):
        jax_step()
    names = [n for n, _ in jm.named_parameters()]
    tm.load_state_dict(convert_paddle_state(
        {n: np.asarray(p.numpy(), np.float32)
         for n, p in jm.named_parameters()}, tm))
    sched_t = port_lr.StepDecay(1e-3, step_size=1, gamma=0.9)
    opt_t = AdamW(learning_rate=sched_t, weight_decay=0.01,
                  parameters=tm.parameters())
    opt_t.set_state_dict(convert_paddle_optimizer_state(
        _jax_numpy_state(opt_j), dict(zip(opt_j._param_keys(), names)), tm,
        opt_t))
    assert opt_t._step_count == 3 and sched_t.last_epoch == 3
    assert sched_t() == sched_j()
    step_t = TrainStep(tm, opt_t)
    first = {}

    def keep_first(name):
        def hook(grad):
            first.setdefault(name, grad.abs())   # returns None: grad kept
        return hook

    hooks = [p.register_hook(keep_first(n))
             for n, p in tm.named_parameters()]
    ids_t, labels_t = torch.from_numpy(ids).long(), \
        torch.from_numpy(labels).long()
    losses_j, losses_t = [], []
    for _ in range(2):
        losses_j.append(jax_step())
        losses_t.append(step_t(ids_t, labels_t).item())
        sched_t.step()
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    want = convert_paddle_state({n: np.asarray(p.numpy(), np.float32)
                                 for n, p in jm.named_parameters()}, tm)
    for name, p in tm.named_parameters():
        diff = (p.detach() - want[name]).abs()
        live = first[name] > 1e-5 * first[name].max()
        assert float(diff[live].max()) < 5e-6, name
        assert float(diff.max()) <= 6e-3, name


def test_jax_masters_and_moments_convert_exactly():
    """bf16 parameters with fp32 masters after one JAX AdamW step: the
    carried masters and moments equal the JAX package's in the port's
    layout bit for bit (a Linear weight's transposed), under the port's
    keys, and a key without a parameter raises."""
    import paddle_tpu as paddle
    from paddle_tpu_torch.convert import convert_paddle_optimizer_state
    from test_torch_train import _batch, _pair
    jm, _, tm = _pair(dtype="bfloat16")
    ids, labels = _batch()
    opt_j = paddle.optimizer.AdamW(learning_rate=1e-3,
                                   parameters=jm.parameters(),
                                   multi_precision=True)
    paddle.jit.TrainStep(jm, opt_j)(paddle.to_tensor(ids),
                                    paddle.to_tensor(labels))
    state = _jax_numpy_state(opt_j)
    assert state["master_weights"]
    names = dict(zip(opt_j._param_keys(),
                     [n for n, _ in jm.named_parameters()]))
    opt_t = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                  multi_precision=True)
    opt_t.set_state_dict(convert_paddle_optimizer_state(state, names, tm,
                                                        opt_t))
    from paddle_tpu_torch.convert import _linear_weight_names
    linear = _linear_weight_names(tm)
    by_id = {id(p): n for n, p in tm.named_parameters()}
    jax_key = {v: k for k, v in names.items()}
    for p in opt_t._parameter_list:
        name = by_id[id(p)]
        flip = (lambda a: a.T) if name in linear else (lambda a: a)
        key = jax_key[name]
        assert np.array_equal(
            opt_t._master_weights[id(p)].numpy(),
            flip(state["master_weights"][key])), name
        assert np.array_equal(opt_t._accumulators[id(p)]["moment2"].numpy(),
                              flip(state[f"{key}_moment2"])), name
    assert opt_t._step_count == 1
    with pytest.raises(ValueError, match="no parameter"):
        convert_paddle_optimizer_state(state, dict(names, **{
            next(iter(names)): "no.such.weight"}), tm, opt_t)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], 12, 3)
