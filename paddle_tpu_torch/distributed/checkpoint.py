"""Fault-tolerant single-card checkpointing and auto-resume (counterpart of
``paddle_tpu/distributed/checkpoint.py``, its single-process paths).

Reference analogs: python/paddle/framework/io.py (state saved by
pickling) and fluid/incubate/checkpoint/auto_checkpoint.py:72 (periodic
job snapshots with automatic resume). A job restarted after a crash must
never take a snapshot the crash interrupted for a resume target; this
module gives that guarantee:

* **Atomic commits** -- a snapshot is written into ``step_<N>.tmp``,
  fsynced, renamed to ``step_<N>``, and only then stamped with a ``COMMIT``
  manifest (schema version, step, world size, per-file SHA-256 and sizes).
  A snapshot without a valid manifest does not exist as far as
  :func:`latest_checkpoint` / :func:`load_checkpoint` are concerned; a crash
  at any point leaves either a ``.tmp`` directory or a manifest-less one,
  never a resume candidate (the resume scan quarantines the latter as
  evidence).
* **Verification and quarantine** -- auto-resume re-hashes the manifest's
  files before restoring; a torn or bit-rotted snapshot is renamed to
  ``step_<N>.corrupt`` and resume falls back to the previous committed
  snapshot.
* **Async saves** -- :class:`AsyncCheckpointer` copies the state to host
  memory synchronously (after the card has finished the work queued on
  the current stream), then writes on a background thread with at most
  one save in flight; ``wait()`` is the barrier and a write error
  surfaces at the next ``save()``, ``wait()`` or ``close()``.
* **Retry** -- transient filesystem errors retry with exponential backoff
  and jitter (:class:`paddle_tpu_torch.utils.retry.RetryPolicy`).

The layout of a snapshot: ``model/state.pt`` (the model's ``state_dict``),
``optimizer.pt`` (the optimizer's ``state_dict``) and ``extra.pt`` (the
caller's ``extra``, with a ``GradScaler``'s state under ``"grad_scaler"``),
each written with ``torch.save`` from host copies, so a bf16 tensor
round-trips exactly, and read back with ``torch.load(weights_only=True)``:
payloads hold tensors and plain Python values (numbers, strings, lists,
dicts), nothing else. The manifest is the JAX package's, so its tools
(``tools/ckpt_inspect.py``) read the port's snapshot directories too.

Not ported: the sharded and pod paths (the per-shard payloads of
``reshard``, the pod-wide commit through the launcher's KV master, resharding
on load). A ``coordinator`` other than None or False, or the launcher's pod
environment (``PADDLE_CKPT_MASTER`` with ``PADDLE_TRAINERS_NUM`` > 1),
raises ``NotImplementedError``.

Fault injection (tests only): the state-changing filesystem calls go
through the ``_fs`` seam (monkeypatch it to inject transient errors), and
``PADDLE_CKPT_FAULT=<stage>:<step>`` (stage ``die_before_rename`` or
``die_before_commit``) makes the process SIGKILL itself mid-save.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import monitor as _monitor
from ..utils.retry import RetryPolicy

__all__ = ["save_state_dict", "load_state_dict", "save_checkpoint",
           "load_checkpoint", "latest_checkpoint", "committed_steps",
           "read_manifest", "verify_snapshot", "AsyncCheckpointer",
           "CheckpointError", "MANIFEST_NAME", "SCHEMA_VERSION"]

SCHEMA_VERSION = 1
MANIFEST_NAME = "COMMIT"
_HASH_CHUNK = 1 << 20
_MODEL_DIR = "model"
_STATE_FILE = "state.pt"
_OPT_FILE = "optimizer.pt"
_EXTRA_FILE = "extra.pt"
_ITEM = "ROADMAP Queue 1, item 10's rest"


class CheckpointError(RuntimeError):
    """A snapshot could not be loaded or validated; the message names the
    snapshot and what exactly is wrong with it."""


class _Filesystem:
    """Fault-injection seam: every state-changing filesystem call of the
    commit protocol goes through here, so tests can inject transient
    errors without touching the real filesystem API."""

    open = staticmethod(open)
    replace = staticmethod(os.replace)
    fsync = staticmethod(os.fsync)
    rename = staticmethod(os.rename)


_fs = _Filesystem()


def _maybe_die(stage: str, step: int):
    """PADDLE_CKPT_FAULT=<stage>:<step> -> SIGKILL this process right here,
    at one of the commit protocol's two interesting windows; only tests
    set the variable."""
    if os.environ.get("PADDLE_CKPT_FAULT") == f"{stage}:{step}":
        os.kill(os.getpid(), signal.SIGKILL)


def _default_retry() -> RetryPolicy:
    return RetryPolicy(max_attempts=3, base_delay=0.1, max_delay=2.0,
                       retry_on=(OSError,))


def _check_coordinator(coordinator):
    """The pod-wide commit is not ported: refuse an explicit coordinator
    and the launcher's multi-rank environment (which the JAX package turns
    into one), rather than commit a multi-rank snapshot from one rank."""
    if coordinator is not None and coordinator is not False:
        raise NotImplementedError(f"checkpoint: a pod coordinator (the "
                                  f"multi-rank commit) is not ported yet "
                                  f"({_ITEM})")
    if coordinator is None and os.environ.get("PADDLE_CKPT_MASTER") \
            and _world_size() > 1:
        raise NotImplementedError(f"checkpoint: the launcher's pod commit "
                                  f"(PADDLE_CKPT_MASTER with "
                                  f"PADDLE_TRAINERS_NUM > 1) is not ported "
                                  f"yet ({_ITEM}); pass coordinator=False "
                                  f"to commit this rank's own directory")


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_state_dict(state_dict: Dict[str, Any], path: str):
    """Write ``state_dict`` (tensors and plain values) as directory
    ``path`` holding ``state.pt``."""
    _save_state(_host_copy(dict(state_dict)), path)


def _save_state(host_state: Dict[str, Any], path: str):
    os.makedirs(path, exist_ok=True)
    torch.save(host_state, os.path.join(path, _STATE_FILE))


def load_state_dict(path: str, state_dict: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The state saved at ``path`` (on the host). When ``state_dict`` (the
    live tensors, e.g. ``model.state_dict()``) is given, each saved tensor
    is first checked against it, then copied into it in place (``copy_``:
    the live tensors keep their storage, so whatever holds them, a CUDA
    graph or an optimizer keyed by ``id``, stays valid).

    A live entry the snapshot lacks, or one of another shape, raises
    ``ValueError``: restoring through a mismatched network would leave a
    tensor at its init or corrupt it, not resume."""
    saved = _load(os.path.join(path, _STATE_FILE))
    if state_dict is None:
        return saved
    missing = [k for k in state_dict if k not in saved]
    if missing:
        raise ValueError(
            f"load_state_dict: the checkpoint ({path}) has no entry for "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''} -- the "
            f"snapshot does not fit this network")
    for k, v in state_dict.items():
        if torch.is_tensor(v) and tuple(saved[k].shape) != tuple(v.shape):
            raise ValueError(
                f"load_state_dict: {k!r} is {tuple(v.shape)} in this model "
                f"but {tuple(saved[k].shape)} in the checkpoint ({path}) -- "
                f"the snapshot does not fit this network")
    with torch.no_grad():
        for k, v in state_dict.items():
            if torch.is_tensor(v):
                v.copy_(saved[k])
    return saved


# --------------------------------------------------------------- commit proto

_STEP_RE = re.compile(r"^step_(\d+)$")


def _snapshot_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}")


def _world_size() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
    except ValueError:
        return 1


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_HASH_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def _walk_files(base: str) -> List[str]:
    """Relative (posix-separated) paths of every regular file under base,
    the manifest and its tmp excluded."""
    out = []
    for root, _dirs, files in os.walk(base):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), base)
            rel = rel.replace(os.sep, "/")
            if rel in (MANIFEST_NAME, MANIFEST_NAME + ".tmp"):
                continue
            out.append(rel)
    return sorted(out)


def _fsync_tree(base: str):
    """fsync every file, then every directory, bottom-up: the payload must
    be durable BEFORE the rename publishes it."""
    for root, dirs, files in os.walk(base, topdown=False):
        for name in files:
            fd = os.open(os.path.join(root, name), os.O_RDONLY)
            try:
                _fs.fsync(fd)
            finally:
                os.close(fd)
        fd = os.open(root, os.O_RDONLY)
        try:
            _fs.fsync(fd)
        finally:
            os.close(fd)


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        _fs.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _build_manifest(base: str, step: int, hash_files: bool = True) -> dict:
    files = {}
    for rel in _walk_files(base):
        p = os.path.join(base, rel.replace("/", os.sep))
        files[rel] = {"sha256": _file_sha256(p) if hash_files else None,
                      "bytes": os.path.getsize(p)}
    return {"schema": SCHEMA_VERSION, "step": int(step),
            "world_size": _world_size(), "wall": time.time(), "files": files}


def _write_manifest(base: str, manifest: dict):
    tmp = os.path.join(base, MANIFEST_NAME + ".tmp")
    with _fs.open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        _fs.fsync(f.fileno())
    _fs.replace(tmp, os.path.join(base, MANIFEST_NAME))
    _fsync_dir(base)


def read_manifest(base: str) -> Optional[dict]:
    """The snapshot's COMMIT manifest, or None when the snapshot is
    uncommitted (torn, in progress, or written before the protocol)."""
    path = os.path.join(base, MANIFEST_NAME)
    try:
        with open(path) as f:
            m = json.load(f)
        if not isinstance(m, dict) or not isinstance(m.get("files"), dict):
            return None
        if int(m.get("schema", -1)) > SCHEMA_VERSION:
            return None  # written by a later version we cannot validate
        name = os.path.basename(os.path.normpath(base))
        mm = _STEP_RE.match(name)
        if mm and m.get("step") is not None \
                and int(m["step"]) != int(mm.group(1)):
            return None  # the manifest does not belong here (copied)
    except (OSError, ValueError, TypeError):
        # unreadable, or rotted fields that still parse as JSON (a string
        # schema or step): uncommitted either way, and resume must not
        # crash on it
        return None
    return m


def verify_snapshot(base: str, manifest: Optional[dict] = None) -> List[str]:
    """Re-hash a snapshot against its manifest. Returns problem strings
    (empty: a verified committed snapshot)."""
    if manifest is None:
        manifest = read_manifest(base)
    if manifest is None:
        if not os.path.isdir(base):
            return [f"{base}: snapshot directory does not exist"]
        return [f"{base}: no {MANIFEST_NAME} manifest "
                f"(torn or in-progress save)"]
    problems = []
    for rel, meta in sorted(manifest["files"].items()):
        p = os.path.join(base, rel.replace("/", os.sep))
        if not os.path.isfile(p):
            problems.append(f"{base}: missing file {rel}")
            continue
        size = os.path.getsize(p)
        if size != meta.get("bytes"):
            problems.append(f"{base}: {rel} is {size} bytes, manifest says "
                            f"{meta.get('bytes')} (truncated?)")
            continue
        # emergency manifests record sizes only (sha256 null)
        if meta.get("sha256") and _file_sha256(p) != meta["sha256"]:
            problems.append(f"{base}: {rel} checksum mismatch")
    return problems


# --------------------------------------------------------------- state capture

def _host_copy(obj, stage=None, key=()):
    """A copy of a state structure on the host, immune to later training
    steps. A CUDA tensor goes into ``stage``'s pinned buffer for ``key``
    (its path in the structure) where a stage is given, else into a new
    host tensor; the copies are queued on the current stream, so the
    caller synchronises it before reading them. A CPU tensor is cloned.
    The copies are plain ``torch.Tensor``s: a payload is read back with
    ``weights_only=True``, which refuses the Paddle surface's ``Tensor``
    class (a ``BatchNorm``'s ``_mean`` buffer is one)."""
    if torch.is_tensor(obj):
        obj = obj.detach()
        if type(obj) is not torch.Tensor:
            obj = obj.as_subclass(torch.Tensor)
        if obj.device.type == "cpu":
            return obj.clone()
        if stage is not None:
            return stage.copy(key, obj)
        return obj.to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v, stage, key + (k,)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        c = [_host_copy(v, stage, key + (i,)) for i, v in enumerate(obj)]
        return c if isinstance(obj, list) else tuple(c)
    return obj


class _PinnedStage:
    """Pinned host buffers, one per tensor path, kept from one save to the
    next: the device-to-host copy of a multi-GB snapshot runs at the
    link's rate into page-locked memory that is allocated once. A buffer
    is reused only after the write that read it has finished (the
    checkpointer's one-save-in-flight barrier)."""

    def __init__(self):
        self._bufs: Dict[tuple, torch.Tensor] = {}

    def copy(self, key: tuple, src: torch.Tensor) -> torch.Tensor:
        buf = self._bufs.get(key)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self._bufs[key] = buf
        buf.copy_(src, non_blocking=True)
        return buf


def _synchronize():
    """Wait for the copies ``_host_copy`` queued (a no-op on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


def _capture(model, optimizer, grad_scaler, extra
             ) -> Tuple[Optional[dict], Optional[dict], dict]:
    model_state = dict(model.state_dict()) if model is not None else None
    opt_state = (optimizer.state_dict()
                 if optimizer is not None and hasattr(optimizer, "state_dict")
                 else None)
    ex = dict(extra or {})
    if grad_scaler is not None and hasattr(grad_scaler, "state_dict"):
        ex["grad_scaler"] = grad_scaler.state_dict()
    return model_state, opt_state, ex


def _state_bytes(state) -> int:
    """Bytes of the tensors of a state structure."""
    if torch.is_tensor(state):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(_state_bytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(_state_bytes(v) for v in state)
    return 0


# ------------------------------------------------------------------ write path

def _write_payloads(tmp: str, model_state, opt_state, extra):
    """The snapshot's payload files under its tmp directory."""
    if model_state is not None:
        _save_state(model_state, os.path.join(tmp, _MODEL_DIR))
    if opt_state is not None:
        torch.save(opt_state, os.path.join(tmp, _OPT_FILE))
    if extra:
        torch.save(extra, os.path.join(tmp, _EXTRA_FILE))


def _write_snapshot(directory: str, step: int, model_state, opt_state, extra,
                    retry: Optional[RetryPolicy], mode: str) -> str:
    """The commit protocol. Returns the committed snapshot path.

    Emergency saves (mode="emergency") skip per-file hashing: re-reading a
    multi-GB payload to checksum it would spend the preemption grace window
    on I/O that only guards against later bit rot; their manifests record
    sizes only, which still catches truncation."""
    t0 = time.perf_counter()
    final = _snapshot_dir(directory, step)
    tmp = final + ".tmp"
    old = final + ".old"
    hash_files = mode != "emergency"

    attempts = {"n": 0}

    def body():
        attempts["n"] += 1
        if attempts["n"] > 1:
            mon = _monitor._active
            if mon is not None:
                mon.ckpt_retry(step, attempts["n"] - 1)
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _write_payloads(tmp, model_state, opt_state, extra)
        _fsync_tree(tmp)
        _maybe_die("die_before_rename", step)
        if os.path.isdir(final):
            # only ever a torn payload from a previous ATTEMPT of this call
            # (the committed snapshot it replaces is parked at .old)
            shutil.rmtree(final, ignore_errors=True)
        _fs.replace(tmp, final)          # atomic publish of the payload
        _fsync_dir(directory)
        _maybe_die("die_before_commit", step)
        manifest = _build_manifest(final, step, hash_files)
        _write_manifest(final, manifest)  # the snapshot now EXISTS
        return manifest

    policy = retry or _default_retry()
    with _aside_lock:  # _recover_aside must not "heal" this live window
        # Re-saving an existing step (after a rollback): park the current
        # snapshot at .old ONCE, before any attempt -- inside the retry body
        # it would see its own torn earlier attempt at `final` and destroy
        # the parked copy. It is dropped only after the new COMMIT lands;
        # _recover_aside puts it back if the process dies in between.
        if os.path.isdir(final):
            if os.path.isdir(old):
                shutil.rmtree(old, ignore_errors=True)
            _fs.rename(final, old)
        try:
            manifest = policy(body)
        except BaseException:
            # a re-save that keeps failing must not strand the previously
            # committed snapshot at .old (invisible to resume): put it
            # back, over a published but never committed payload too
            if os.path.isdir(old):
                try:
                    if os.path.isdir(final):
                        shutil.rmtree(final, ignore_errors=True)
                    _fs.rename(old, final)
                except OSError:
                    pass
            raise
        if os.path.isdir(old):  # the replaced snapshot, kept until now
            shutil.rmtree(old, ignore_errors=True)
    mon = _monitor._active
    if mon is not None:
        mon.ckpt_saved(step=step,
                       nbytes=sum(f["bytes"]
                                  for f in manifest["files"].values()),
                       dur_s=time.perf_counter() - t0, mode=mode,
                       attempts=attempts["n"])
    return final


def _prune_committed(directory: str, keep: int, protect: str):
    """Prune to the newest ``keep`` snapshots by mtime (not step number: a
    save after a rollback has a lower step and must survive). Only
    committed snapshots are prunable: an in-flight ``.tmp``, a torn
    manifest-less directory (evidence for the operator) and quarantined
    ``.corrupt`` ones are never touched, and the snapshot just written
    never prunes itself."""
    if not keep or not os.path.isdir(directory):
        return
    protect = os.path.abspath(protect)
    entries = []
    for d in os.listdir(directory):
        if not _STEP_RE.match(d):
            continue
        p = os.path.join(directory, d)
        if os.path.abspath(p) == protect:
            continue
        if read_manifest(p) is None:
            continue
        entries.append((os.path.getmtime(p), p))
    for _, p in sorted(entries, reverse=True)[max(keep - 1, 0):]:
        shutil.rmtree(p, ignore_errors=True)


def save_checkpoint(directory: str, step: int, model=None, optimizer=None,
                    extra: Optional[Dict[str, Any]] = None, keep: int = 3,
                    grad_scaler=None, retry: Optional[RetryPolicy] = None,
                    coordinator=None, _mode: str = "sync") -> str:
    """Job snapshot ``<directory>/step_<N>/{model/state.pt, optimizer.pt,
    extra.pt}``, committed atomically under a COMMIT manifest, on this
    thread. Prunes committed snapshots beyond the newest ``keep``. A
    ``grad_scaler``'s state rides in ``extra["grad_scaler"]`` and is
    restored by :func:`load_checkpoint`. ``coordinator``: None or False
    (the pod-wide commit is not ported). Returns the committed snapshot's
    path."""
    _check_coordinator(coordinator)
    model_state, opt_state, ex = _capture(model, optimizer, grad_scaler, extra)
    model_state, opt_state, ex = (_host_copy(model_state),
                                  _host_copy(opt_state), _host_copy(ex))
    final = _write_snapshot(directory, step, model_state, opt_state, ex,
                            retry, _mode)
    _prune_committed(directory, keep, final)
    return final


# -------------------------------------------------------------------- resume

_OLD_RE = re.compile(r"^step_(\d+)\.old$")

# Serialises the re-save set-aside window against the recovery scan: while
# a writer in THIS process is mid-protocol (a parked .old, a payload in
# flight), a concurrent latest_checkpoint() must not "heal" the live
# window -- it would rename the .old back and the writer's retry would then
# destroy it. One writer per checkpoint directory is the contract.
_aside_lock = threading.Lock()


def _recover_aside(directory: str):
    """Heal crashes inside a re-save's set-aside window: a COMMITTED
    ``step_<N>.old`` whose replacement never committed is the real
    snapshot -- quarantine the torn replacement and rename the parked copy
    back. A leftover ``.old`` beside a committed replacement is cleanup."""
    if not os.path.isdir(directory):
        return
    if not _aside_lock.acquire(blocking=False):
        return  # a live writer owns the window; there is no crash to heal
    try:
        _recover_aside_locked(directory)
    finally:
        _aside_lock.release()


def _recover_aside_locked(directory: str):
    for d in os.listdir(directory):
        m = _OLD_RE.match(d)
        if not m:
            continue
        oldp = os.path.join(directory, d)
        finalp = _snapshot_dir(directory, int(m.group(1)))
        if read_manifest(finalp) is not None:
            shutil.rmtree(oldp, ignore_errors=True)
        elif read_manifest(oldp) is not None:
            if os.path.isdir(finalp):
                _quarantine(finalp, [f"{finalp}: torn re-save superseded by "
                                     f"the parked committed copy"])
            try:
                _fs.rename(oldp, finalp)
            except OSError:
                pass
        # both uncommitted: leave the evidence alone


def committed_steps(directory: str) -> List[int]:
    """Steps with a valid COMMIT manifest, ascending. Torn directories and
    ``.tmp`` / ``.corrupt`` entries are invisible here by construction."""
    if not os.path.isdir(directory):
        return []
    _recover_aside(directory)
    steps = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m and read_manifest(os.path.join(directory, d)) is not None:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(directory: str) -> Optional[int]:
    """The newest COMMITTED step: a crash mid-save never surfaces here."""
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def _quarantine(base: str, problems: List[str]):
    dst = base + ".corrupt"
    i = 0
    while os.path.exists(dst):
        i += 1
        dst = base + f".corrupt.{i}"
    try:
        _fs.rename(base, dst)
    except OSError:
        dst = None  # cannot move it; resume still skips it this run
    mon = _monitor._active
    if mon is not None:
        mon.ckpt_corrupt(base, "; ".join(problems), quarantined=dst)
    return dst


def _restore(base: str, step: int, model, optimizer, grad_scaler
             ) -> Dict[str, Any]:
    if model is not None:
        mpath = os.path.join(base, _MODEL_DIR)
        if not os.path.isfile(os.path.join(mpath, _STATE_FILE)):
            raise CheckpointError(
                f"snapshot {base} has no '{_MODEL_DIR}/' payload (partial "
                f"save or a model-less snapshot) -- cannot restore model "
                f"weights from it")
        load_state_dict(mpath, model.state_dict())
    info: Dict[str, Any] = {"step": step}
    opt_path = os.path.join(base, _OPT_FILE)
    if optimizer is not None and os.path.exists(opt_path):
        optimizer.set_state_dict(_load(opt_path))
    extra_path = os.path.join(base, _EXTRA_FILE)
    if os.path.exists(extra_path):
        info.update(_load(extra_path))
    if grad_scaler is not None and isinstance(info.get("grad_scaler"), dict):
        grad_scaler.load_state_dict(info["grad_scaler"])
    mon = _monitor._active
    if mon is not None:
        mon.ckpt_resumed(step, base)
    return info


def load_checkpoint(directory: str, model=None, optimizer=None,
                    step: Optional[int] = None, grad_scaler=None,
                    verify: bool = True, quarantine: bool = True,
                    max_step: Optional[int] = None
                    ) -> Optional[Dict[str, Any]]:
    """Resume from the newest committed snapshot (or the given ``step``),
    copying into the live parameters, optimizer states and scaler in place.

    Auto-resume (``step=None``) verifies checksums, quarantines anything
    torn or corrupt (renamed ``step_<N>.corrupt``) and falls back to the
    previous committed snapshot; returns ``{'step': N, **extra}``, or None
    when nothing committed is loadable. An EXPLICIT ``step`` that is
    missing, uncommitted or fails verification raises
    :class:`CheckpointError` with a diagnostic naming the snapshot;
    ``step=N, verify=False`` is the operator's override that restores a
    manifest-less snapshot anyway.

    ``max_step`` bounds auto-resume: snapshots with a larger step are
    skipped untouched (not verified, never quarantined) and the newest
    committed snapshot at or below the bound restores -- the health
    plane's rollback primitive (``monitor/health.py``): snapshots taken
    after a loss spike are suspect, not corrupt. Ignored when ``step`` is
    explicit."""
    if step is not None:
        base = _snapshot_dir(directory, step)
        if not os.path.isdir(base):
            raise CheckpointError(
                f"snapshot {base} does not exist "
                f"(committed steps here: {committed_steps(directory)})")
        manifest = read_manifest(base)
        if manifest is None:
            if not verify:
                # the operator's override: restore a manifest-less snapshot
                # (one written before the protocol, or a salvaged copy)
                return _restore(base, step, model, optimizer, grad_scaler)
            missing = [] if os.path.isdir(os.path.join(base, _MODEL_DIR)) \
                else [f"{_MODEL_DIR}/"]
            raise CheckpointError(
                f"snapshot {base} is not committed: no {MANIFEST_NAME} "
                f"manifest" + (f" and {missing[0]} is missing" if missing
                               else "") +
                " -- a save was interrupted here; pick a committed step "
                f"({committed_steps(directory)}), let auto-resume "
                "(step=None) fall back past it, or force this one with "
                "verify=False if you trust it")
        if verify:
            problems = verify_snapshot(base, manifest)
            if problems:
                raise CheckpointError(
                    "snapshot failed verification: " + "; ".join(problems))
        return _restore(base, step, model, optimizer, grad_scaler)

    all_steps = []
    if os.path.isdir(directory):
        _recover_aside(directory)
        for d in os.listdir(directory):
            m = _STEP_RE.match(d)
            if m:
                all_steps.append(int(m.group(1)))
    for s in sorted(all_steps, reverse=True):
        if max_step is not None and s > max_step:
            continue                       # suspect, not corrupt: untouched
        base = _snapshot_dir(directory, s)
        manifest = read_manifest(base)
        if manifest is None:
            problems = [f"{base}: no {MANIFEST_NAME} manifest "
                        f"(torn or in-progress save)"]
        else:
            problems = verify_snapshot(base, manifest) if verify else []
            if not problems and model is not None and \
                    not any(f.startswith(f"{_MODEL_DIR}/")
                            for f in manifest["files"]):
                # a healthy snapshot that has no model payload (saved with
                # model=None): not this restore's, not corrupt -- skip it
                # and leave it alone
                continue
        if not problems:
            return _restore(base, s, model, optimizer, grad_scaler)
        if quarantine:
            _quarantine(base, problems)
        else:
            mon = _monitor._active
            if mon is not None:
                mon.ckpt_corrupt(base, "; ".join(problems), quarantined=None)
    return None


# ------------------------------------------------------------------ async save

class AsyncCheckpointer:
    """Background checkpoint writer with at most ONE save in flight.

    ``save()`` copies the model, optimizer and scaler state to host memory
    synchronously (CUDA tensors into pinned buffers kept from one save to
    the next, queued on the current stream behind the work already there,
    then one wait), so the training loop may change the live tensors as
    soon as it returns, and hands the filesystem work (``torch.save``,
    fsync, manifest, prune) to a writer thread. A second ``save()`` while
    one is in flight first waits for it. A write error is raised at the
    NEXT ``save()`` / ``wait()`` / ``close()``, on the caller's thread:
    training never dies inside the writer. ``last_bytes`` is the tensor
    bytes the last ``save()`` copied.

    Usable as a context manager; ``close()`` (or ``__exit__``) is the
    shutdown barrier that surfaces the last error.
    """

    def __init__(self, directory: str, keep: int = 3,
                 retry: Optional[RetryPolicy] = None, coordinator=None):
        _check_coordinator(coordinator)
        self.directory = directory
        self.keep = keep
        self._retry = retry
        self._stage = _PinnedStage()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_path: Optional[str] = None
        self.last_bytes = 0

    # ------------------------------------------------------------------- api

    def save(self, step: int, model=None, optimizer=None, grad_scaler=None,
             extra: Optional[Dict[str, Any]] = None, block: bool = False,
             _mode: Optional[str] = None) -> None:
        """Queue one snapshot. ``block=True`` writes on this thread (an
        emergency save wants the barrier of a synchronous one)."""
        self.wait()  # barrier: one in flight; raises a previous write error
        state = _capture(model, optimizer, grad_scaler, extra)
        model_state, opt_state, ex = _host_copy(state, self._stage)
        _synchronize()
        self.last_bytes = _state_bytes((model_state, opt_state, ex))
        mode = _mode or ("sync" if block else "async")

        def work():
            try:
                self._last_path = _write_snapshot(
                    self.directory, step, model_state, opt_state, ex,
                    self._retry, mode)
                _prune_committed(self.directory, self.keep, self._last_path)
            except BaseException as e:  # surfaced at the next call-in
                self._error = e

        if block:
            work()
            self._raise_pending()
            return
        t = threading.Thread(target=work, daemon=True,
                             name=f"ckpt-writer-step{step}")
        self._thread = t
        t.start()

    def wait(self):
        """Block until no save is in flight; re-raise any write error."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        self._raise_pending()

    def in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def last_path(self) -> Optional[str]:
        return self._last_path

    def close(self):
        self.wait()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc):
        # an exception is already unwinding: don't mask it with a stale
        # writer error, but do drain the thread
        if exc and exc[0] is not None:
            t = self._thread
            if t is not None:
                t.join()
                self._thread = None
            return False
        self.close()
        return False

    def _raise_pending(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e
