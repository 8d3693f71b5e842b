"""Preemption watcher: turn SIGTERM/SIGINT into a checkpoint request (the
port's copy of ``paddle_tpu/distributed/preemption.py``, reporting to the
port's monitor).

Reference analog: fluid/incubate/checkpoint/auto_checkpoint.py's periodic
job snapshots assume something outside the train loop decides "save NOW and
exit"; on preemptible machines that something is the eviction SIGTERM the
node agent delivers with a short grace window.

The watcher never acts inside the (async-signal) handler — it only records
the request. The training loop observes ``requested()`` at its next step
boundary and performs the emergency checkpoint there, where the model,
optimizer and scaler are in a consistent between-steps state. Raw
``jit.TrainStep`` loops poll the watcher directly::

    with PreemptionWatcher() as w:
        for step, batch in enumerate(loader):
            train_step(*batch)
            if w.requested():
                train_step.save_checkpoint(ckpt_dir, step, block=True)
                break

Signal handlers install on the MAIN thread only (CPython restriction);
elsewhere ``install()`` degrades to a no-op watcher that never fires, so
library code can install unconditionally.
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Optional, Sequence

from .. import monitor as _monitor

__all__ = ["PreemptionWatcher", "install", "requested", "clear", "get"]

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionWatcher:
    """Records the first delivery of any watched signal.

    A second SIGINT escalates to the previous handler (normally
    ``KeyboardInterrupt``) so a user hammering Ctrl-C still gets an abort
    even if the emergency checkpoint hangs; a second SIGTERM stays recorded
    only (the launcher's grace-then-kill already bounds shutdown time).
    """

    def __init__(self, signals: Sequence[int] = _DEFAULT_SIGNALS,
                 on_signal: Optional[Callable[[int], None]] = None):
        self._signals = tuple(signals)
        self._on_signal = on_signal
        self._event = threading.Event()
        self._prev = {}
        self._reported = False
        self.installed = False
        self.signum: Optional[int] = None
        self.when: Optional[float] = None

    # ------------------------------------------------------------- lifecycle

    def install(self) -> "PreemptionWatcher":
        if self.installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self  # signal.signal would raise; stay a never-firing stub
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handle)
        except ValueError:
            # embedded interpreter corner cases: degrade, don't break training
            for s, h in self._prev.items():
                signal.signal(s, h)
            self._prev.clear()
            return self
        self.installed = True
        return self

    def uninstall(self):
        if not self.installed:
            return
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionWatcher":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # --------------------------------------------------------------- handler

    def _handle(self, signum, frame):
        first = not self._event.is_set()
        if first:
            # record ONLY — no locks here. The handler interrupts the main
            # thread at an arbitrary bytecode; touching the monitor's
            # non-reentrant registry/sink locks from here can self-deadlock
            # against a metric op the interrupted frame holds mid-update.
            # The telemetry event is emitted from requested() instead.
            self.signum = signum
            self.when = time.time()
            self._event.set()
            if self._on_signal is not None:
                # user hook: runs in async-signal context — keep it trivial
                try:
                    self._on_signal(signum)
                except Exception:
                    pass
            return
        if signum == signal.SIGINT:
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            else:
                raise KeyboardInterrupt

    # ----------------------------------------------------------------- query

    def requested(self) -> bool:
        """True once a watched signal arrived; the step boundary that sees
        this should emergency-checkpoint and wind down."""
        if not self._event.is_set():
            return False
        if not self._reported:
            # deferred from the handler: we are on a normal call stack now,
            # so the monitor's locks are safe to take
            self._reported = True
            mon = _monitor._active
            if mon is not None:
                try:
                    mon.preempted(self.signum or 0)
                except Exception:
                    pass
        return True

    def clear(self):
        self._event.clear()
        self._reported = False
        self.signum = None
        self.when = None


# --------------------------------------------------------- module-level sugar

_global: Optional[PreemptionWatcher] = None


def install(signals: Sequence[int] = _DEFAULT_SIGNALS) -> PreemptionWatcher:
    """Install (or return) the process-wide watcher."""
    global _global
    if _global is None:
        _global = PreemptionWatcher(signals)
    _global.install()
    return _global


def requested() -> bool:
    return _global is not None and _global.requested()


def clear():
    if _global is not None:
        _global.clear()


def get() -> Optional[PreemptionWatcher]:
    """The process-wide watcher, or None if install() was never called —
    lets tooling observe preemption state without installing handlers as
    a side effect. (install() itself is idempotent and returns the same
    watcher, which is how DecodeEngine.drain_on_preemption shares it with
    a training loop's AutoCheckpoint.)"""
    return _global
