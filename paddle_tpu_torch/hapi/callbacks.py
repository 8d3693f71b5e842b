"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``;
reference: python/paddle/hapi/callbacks.py). ``AutoCheckpoint`` drives the
port's single-card checkpointing (``distributed.checkpoint``: atomic
commits, async saves), ``distributed.preemption.PreemptionWatcher`` and
the health plane's ``SpikeDetector``; a pod ``coordinator`` (the
multi-rank commit, ROADMAP item 10) raises there."""
from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "AutoCheckpoint",
           "EarlyStopping", "LRScheduler", "VisualDL", "WandbCallback"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # train
    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    # fit is unwinding on an exception: on_train_end will NOT run; release
    # process-global resources (signal handlers, writer threads) here and
    # never raise — the real exception must win
    def on_train_abort(self, exc=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    # eval
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    # predict
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)
        return call


class ProgBarLogger(Callback):
    """Per-epoch console logging (reference ProgBarLogger, simplified to
    line-based output — training jobs log to files, not TTY progress
    bars)."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        if self.verbose:
            total = self.params.get("epochs")
            print(f"Epoch {epoch + 1}/{total}", file=sys.stderr)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                              else f"{k}: {v}" for k, v in (logs or {}).items())
            print(f"  step {step}: {items}", file=sys.stderr)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                              else f"{k}: {v}" for k, v in (logs or {}).items())
            dt = time.time() - self._t0
            print(f"  epoch {epoch + 1} done in {dt:.1f}s: {items}",
                  file=sys.stderr)


class VisualDL(Callback):
    """Metrics streamer (reference: hapi/callbacks.py VisualDL).

    The reference writes VisualDL scalar records; this form streams
    JSON-lines to ``log_dir/vdlrecords.jsonl`` — one record per logged scalar
    ({"tag", "step", "value", "wall"}) — which any dashboard (or pandas) can
    tail. Flushed per write so a watcher process sees records live."""

    def __init__(self, log_dir: str = "./log"):
        super().__init__()
        self.log_dir = log_dir
        self._fh = None
        self._global_step = 0

    def _ensure(self):
        if self._fh is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir, "vdlrecords.jsonl"),
                            "a", encoding="utf-8")
        return self._fh

    def _write(self, prefix, step, logs):
        import json
        fh = self._ensure()
        wall = time.time()
        for k, v in (logs or {}).items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            fh.write(json.dumps({"tag": f"{prefix}/{k}", "step": int(step),
                                 "value": v, "wall": wall}) + "\n")
        fh.flush()

    def on_train_batch_end(self, step, logs=None):
        self._global_step += 1
        self._write("train", self._global_step, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._write("epoch", epoch, logs)

    def on_eval_end(self, logs=None):
        self._write("eval", self._global_step, logs)

    def on_train_end(self, logs=None):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class WandbCallback(VisualDL):
    """reference hapi WandbCallback analog. If the ``wandb`` package is
    importable, streams there; otherwise degrades to the VisualDL JSON-lines
    file (records stay local either way)."""

    def __init__(self, project=None, dir="./wandb_logs", **init_kwargs):
        super().__init__(log_dir=dir)
        self._wandb = None
        try:
            import wandb  # noqa: F401
            self._wandb = wandb
            self._run = wandb.init(project=project, dir=dir, **init_kwargs)
        except Exception:
            self._run = None

    def _write(self, prefix, step, logs):
        if self._run is not None:
            self._run.log({f"{prefix}/{k}": v for k, v in (logs or {}).items()},
                          step=int(step))
            return
        super()._write(prefix, step, logs)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model is not None \
                and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir and self.model is not None:
            self.model.save(os.path.join(self.save_dir, "final"))


class AutoCheckpoint(Callback):
    """Fault-tolerant auto-checkpointing for ``Model.fit``.

    Reference analog: fluid/incubate/checkpoint/auto_checkpoint.py (periodic
    job snapshots with automatic resume by job id), upgraded to the atomic
    commit protocol of ``paddle_tpu_torch.distributed.checkpoint``:

    * saves model + optimizer (+ GradScaler) every ``save_steps`` optimizer
      steps and/or ``save_secs`` seconds — asynchronously by default, so
      training keeps stepping while a background thread writes;
    * auto-RESUMES at fit start from the newest committed snapshot in
      ``directory`` (torn/corrupt snapshots are quarantined and skipped),
      restoring the global step so the fit loop replays the data stream
      position without re-training those batches;
    * watches SIGTERM/SIGINT (preemption): at the next step boundary it
      writes a synchronous emergency snapshot and stops fit cleanly — the
      relaunched job resumes exactly where the eviction hit;
    * opt-in ``rollback_on_spike``: the per-batch fit loss feeds the health
      plane's rolling median/MAD spike detector, and on a spike (or a
      non-finite loss) the model/optimizer/scaler roll back to the newest
      snapshot committed BEFORE the spike step — quarantine semantics: the
      spiked step's weights and any snapshot at-or-after it are never
      adopted. The data stream does NOT rewind; training continues forward
      on restored weights (the point is to eject the bad update, not to
      bitwise-replay the input pipeline).
    """

    def __init__(self, directory: str, save_steps: Optional[int] = None,
                 save_secs: Optional[float] = None, keep: int = 3,
                 resume: bool = True, asynchronous: bool = True,
                 grad_scaler=None, watch_signals: bool = True,
                 verbose: int = 1, coordinator=None,
                 rollback_on_spike: bool = False):
        super().__init__()
        if not save_steps and save_secs is None:
            save_steps = 100  # save SOMETHING periodically by default
        self.directory = directory
        self.save_steps = save_steps
        self.save_secs = save_secs
        self.keep = keep
        self.resume = resume
        self.asynchronous = asynchronous
        self.grad_scaler = grad_scaler
        self.watch_signals = watch_signals
        self.verbose = verbose
        # multi-rank jobs sharing one snapshot directory commit pod-wide
        # through a coordinator, which is not ported: anything but None or
        # False raises when fit starts (checkpoint._check_coordinator)
        self.coordinator = coordinator
        self.rollback_on_spike = rollback_on_spike
        self._ckptr = None
        self._watcher = None
        self._global_step = 0
        self._last_saved = -1
        self._t_last = 0.0
        self._emergency_done = False
        self._spike_plane = None     # monitor health plane (hook installed)
        self._spike_det = None       # standalone detector (no monitor)
        self._hook_installed = False
        self.rollbacks = 0

    # ------------------------------------------------------------- plumbing

    def _scaler(self):
        return self.grad_scaler or getattr(self.model, "_grad_scaler", None)

    def _save(self, block: bool, mode: Optional[str] = None):
        if self._global_step == self._last_saved:
            return  # this exact state is already snapshotted (e.g. a
            # save_secs tick right after resume or a periodic save)
        t0 = time.perf_counter()
        self._ckptr.save(self._global_step, model=self.model.network,
                         optimizer=self.model._optimizer,
                         grad_scaler=self._scaler(), block=block, _mode=mode)
        from .. import monitor as _monitor
        from ..monitor import trace as _trace
        mon = _monitor._active
        if mon is not None:
            # goodput: this bracket is what the FIT LOOP lost to the save
            # (async: the host snapshot; blocking: the whole write) — the
            # background write itself reports separately as hidden ckpt
            # time through ckpt_saved(mode="async")
            mon.ckpt_blocked(t0, time.perf_counter())
        tracer = _trace._active
        if tracer is not None:
            # host time the fit loop spent inside save() (the async host
            # snapshot, or the whole write when block=True) — lands as a
            # floating span on the next step's trace, where a periodic
            # save explains a step-time spike
            tracer.floating("ckpt/save", t0, time.perf_counter(),
                            step=self._global_step, block=bool(block),
                            mode=mode or ("sync" if block else "async"))
        self._last_saved = self._global_step
        self._t_last = time.monotonic()

    # ------------------------------------------------------- spike rollback

    def _spike_rollback(self, spike_step, info):
        """health-plane rollback hook: restore the newest snapshot committed
        strictly before the CURRENT fit step (the plane may number its steps
        from process start — the fit-global step is what names snapshots
        here, so quarantine is anchored on it, not on ``spike_step``)."""
        from ..distributed import checkpoint as _ckpt
        try:
            self._ckptr.wait()
        except Exception as stale:
            import warnings
            warnings.warn(f"AutoCheckpoint: discarding stale async write "
                          f"error before spike rollback: {stale!r}",
                          stacklevel=2)
        info = _ckpt.load_checkpoint(self.directory,
                                     model=self.model.network,
                                     optimizer=self.model._optimizer,
                                     grad_scaler=self._scaler(),
                                     max_step=int(self._global_step) - 1)
        if info is None:
            import warnings
            warnings.warn("AutoCheckpoint: rollback_on_spike found no "
                          "committed snapshot predating the spike; training "
                          "continues on the spiked weights", stacklevel=2)
            return None
        self.rollbacks += 1
        self._global_step = int(info["step"])
        self._last_saved = self._global_step  # this exact state IS on disk
        if self.verbose:
            print(f"AutoCheckpoint: loss spike — rolled back to step "
                  f"{self._global_step} ({self.directory})", file=sys.stderr)
        return info

    def _feed_spike(self, logs):
        try:
            lv = float((logs or {}).get("loss"))
        except (TypeError, ValueError):
            return
        if self._spike_plane is not None:
            sp = self._spike_plane.spike.observe(lv)
            if sp is not None:
                self._spike_plane.spike_tripped(self._global_step, sp,
                                                source="fit")
        elif self._spike_det is not None:
            sp = self._spike_det.observe(lv)
            if sp is not None:
                import warnings
                warnings.warn(
                    f"AutoCheckpoint: loss spike at step "
                    f"{self._global_step}: {sp['loss']:.6g}"
                    + (f" vs rolling median {sp['median']:.6g}"
                       if sp.get("median") is not None else " (non-finite)"),
                    RuntimeWarning, stacklevel=2)
                if self._spike_rollback(self._global_step, sp) is not None:
                    self._spike_det.reset()

    def _spike_teardown(self):
        if self._hook_installed and self._spike_plane is not None:
            self._spike_plane.rollback_hook = None
        self._hook_installed = False
        self._spike_plane = None
        self._spike_det = None

    # ------------------------------------------------------------ callbacks

    def on_train_begin(self, logs=None):
        from ..distributed import checkpoint as _ckpt
        from ..distributed.preemption import PreemptionWatcher
        self._ckptr = _ckpt.AsyncCheckpointer(self.directory, keep=self.keep,
                                              coordinator=self.coordinator)
        self._global_step = 0
        self._last_saved = -1
        self._emergency_done = False
        if getattr(self.model, "_metric_lag", 0):
            import warnings
            warnings.warn(
                "AutoCheckpoint under fit(metric_lag>0): step boundaries are "
                "observed with up to metric_lag steps of lag, so a snapshot "
                "can label weights that already contain a few more updates "
                "than its recorded step — resume would re-train those "
                "batches. Use metric_lag=0 for exact resume.", stacklevel=2)
        if self.resume and self.model is not None:
            info = _ckpt.load_checkpoint(self.directory,
                                         model=self.model.network,
                                         optimizer=self.model._optimizer,
                                         grad_scaler=self._scaler())
            if info is not None:
                self._global_step = int(info["step"])
                self._last_saved = self._global_step
                self.model._resume_step = self._global_step
                if self.verbose:
                    print(f"AutoCheckpoint: resuming from step "
                          f"{self._global_step} ({self.directory})",
                          file=sys.stderr)
        if self.rollback_on_spike:
            from .. import monitor as _monitor
            from ..monitor import health as _health
            mon = _monitor._active
            if mon is not None and mon.health.enabled:
                # share the session's detector: a spike caught by EITHER
                # channel (sampled TrainStep tick or this per-batch feed)
                # runs the rollback through the plane's hook
                self._spike_plane = mon.health
                if mon.health.rollback_hook is None:
                    mon.health.rollback_hook = self._spike_rollback
                    self._hook_installed = True
            else:
                self._spike_det = _health.SpikeDetector(
                    window=_health._env_int("PADDLE_HEALTH_SPIKE_WINDOW", 32),
                    k=_health._env_float("PADDLE_HEALTH_SPIKE_K", 10.0),
                    min_fill=_health._env_int("PADDLE_HEALTH_SPIKE_MIN", 8))
        # install the process-global handlers only once the fallible resume
        # is done: if it raises, fit unwinds before on_train_abort/-end
        # would run, and a leaked watcher swallows every later SIGTERM
        if self.watch_signals:
            self._watcher = PreemptionWatcher().install()
        self._t_last = time.monotonic()

    def on_train_batch_end(self, step, logs=None):
        self._global_step += 1
        if self._watcher is not None and self._watcher.requested():
            if self._emergency_done:
                # fit(metric_lag>0) drains lagged batch-end events after the
                # stop: the snapshot is already on disk, don't burn the
                # preemption grace window re-writing it per drained step
                return
            # preemption: emergency snapshot AT the step boundary, then stop
            # fit — the relaunch resumes from exactly this step
            try:
                try:
                    self._ckptr.wait()
                except Exception as stale:
                    # an earlier periodic save failed (transient fs error):
                    # that stale error must not abort the one save that
                    # matters most — report it and write the snapshot anyway
                    import warnings
                    warnings.warn(
                        f"AutoCheckpoint: discarding stale async write "
                        f"error before the emergency save: {stale!r}",
                        stacklevel=2)
                self._save(block=True, mode="emergency")
                self._emergency_done = True
            finally:
                self.model.stop_training = True
            if self.verbose:
                print(f"AutoCheckpoint: emergency snapshot at step "
                      f"{self._global_step} (signal "
                      f"{self._watcher.signum}); stopping", file=sys.stderr)
            return
        if self.rollback_on_spike:
            # feed BEFORE the periodic-save check: a spiked step must roll
            # back, not snapshot its poisoned weights (after a rollback
            # _last_saved == _global_step, so the due-save below no-ops)
            self._feed_spike(logs)
        due = bool(self.save_steps) and \
            self._global_step % self.save_steps == 0
        if not due and self.save_secs is not None:
            due = time.monotonic() - self._t_last >= self.save_secs
        if due:
            self._save(block=not self.asynchronous)

    def on_train_end(self, logs=None):
        try:
            if self._ckptr is not None:
                self._ckptr.wait()  # surface any async write error here
        finally:
            self._spike_teardown()
            if self._watcher is not None:
                self._watcher.uninstall()
                self._watcher = None

    def on_train_abort(self, exc=None):
        # fit is dying on its own exception: drain the writer WITHOUT
        # raising (a stale write error must not mask the real failure) and
        # give the signal handlers back
        try:
            if self._ckptr is not None:
                t = self._ckptr._thread
                if t is not None:
                    t.join()
        except Exception:
            pass
        finally:
            self._spike_teardown()
            if self._watcher is not None:
                self._watcher.uninstall()
                self._watcher = None


class EarlyStopping(Callback):
    """Stop when `monitor` stops improving (reference EarlyStopping)."""

    def __init__(self, monitor: str = "loss", mode: str = "auto",
                 patience: int = 0, verbose: int = 1, min_delta: float = 0.0,
                 baseline=None, save_best_model: bool = True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "max" or (mode == "auto" and ("acc" in monitor
                                                 or monitor.startswith("f"))):
            self._better = lambda cur, best: cur > best + self.min_delta
            self.best = -float("inf")
        else:
            self._better = lambda cur, best: cur < best - self.min_delta
            self.best = float("inf")
        self.wait = 0
        self.stopped_epoch = -1

    def on_train_begin(self, logs=None):
        if self.baseline is not None:
            self.best = self.baseline
        self.wait = 0

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0]) if isinstance(cur, (list, tuple)) else float(cur)
        if self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.model is not None and \
                    getattr(self.model, "_save_dir", None):
                self.model.save(os.path.join(self.model._save_dir,
                                             "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                self.stopped_epoch = self.params.get("epoch", -1)
                if self.verbose:
                    print(f"EarlyStopping: no {self.monitor} improvement for "
                          f"{self.wait} evals; stopping", file=sys.stderr)


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (reference LRScheduler callback)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        assert by_step != by_epoch, "exactly one of by_step/by_epoch"
        self.by_step = by_step

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if not self.by_step:
            s = self._sched()
            if s is not None:
                s.step()


def config_callbacks(callbacks, model, epochs, steps, verbose=2,
                     save_dir=None, log_freq: int = 1) -> CallbackList:
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq=log_freq, verbose=verbose)] + cbks
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_dir=save_dir))
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({"epochs": epochs, "steps": steps, "verbose": verbose})
    return lst
