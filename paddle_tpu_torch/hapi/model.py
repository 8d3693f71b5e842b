"""hapi paddle.Model — fit/evaluate/predict (counterpart of
``paddle_tpu/hapi/model.py``; reference python/paddle/hapi/model.py:1018).

The reference Model wraps dygraph/static dual-mode execution, DataParallel
auto-wrap and AMP plumbing around a user network. Here training runs the
eager tape, or with ``prepare(jit_compile=True)`` / ``accumulate_steps=K``
the port's ``jit.TrainStep`` (captured as a CUDA graph on the card).

Where a batch lives. The ``DataLoader`` collates on the host; an eager
step moves each input to the network's device, the ``TrainStep`` stages
host inputs in its one copy a call, and an ``io.DeviceLoader`` hands over
inputs already on the card (ordered after its copies). Losses come back as
floats (``float(loss)``, one sync a step) or, under ``fit(metric_lag=k)``,
as ``AsyncScalar`` handles read at most k steps late.
"""
from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import monitor as _monitor
from ..io.dataloader import host_tensor
from ..metric import _np
from ..nn.layer import Layer
from .async_metrics import AsyncScalar, MetricDrain
from .callbacks import config_callbacks

__all__ = ["Model"]


class _LossNet(Layer):
    """network + loss fused into one Layer so TrainStep can compile
    forward → loss → backward → update as a single executable."""

    def __init__(self, network: Layer, loss_fn, n_labels: int):
        super().__init__()
        self.net = network
        self._loss_fn = loss_fn
        self._n_labels = n_labels

    def forward(self, *args):
        split = len(args) - self._n_labels
        outs = self.net(*args[:split])
        return self._loss_fn(outs, *args[split:])

    # forward the recompute surface so TrainStep's remat/* observability
    # (and the PADDLE_REMAT_BASELINE twin) sees through the wrapper —
    # Layer.__getattr__ only resolves params/sublayers/buffers, so without
    # these the hapi path would silently report remat/requested=0
    def enable_recompute(self, granularity="selective", interval: int = 1):
        fn = getattr(self.net, "enable_recompute", None)
        if fn is None:
            raise AttributeError(
                f"{type(self.net).__name__} exposes no enable_recompute")
        fn(granularity, interval=interval)
        return self

    @property
    def _recompute_wanted(self) -> bool:
        return bool(getattr(self.net, "_recompute_wanted", False))

    @property
    def config(self):
        return getattr(self.net, "config", None)


def _as_batch_tensors(data):
    """DataLoader batch -> a tensor list (numpy as CPU tensors; tensors
    stay where they lie)."""
    if isinstance(data, (list, tuple)):
        items = list(data)
    else:
        items = [data]
    return [t if isinstance(t, torch.Tensor) else host_tensor(np.asarray(t))
            for t in items]


class _StackedBatches:
    """Wrap a batch iterable so every K consecutive batches come out stacked
    leaf-wise (leading axis K) — the input format of a
    ``TrainStep(accumulate_steps=K)`` call. A trailing partial group is
    dropped (the accumulation window needs exactly K microbatches)."""

    def __init__(self, loader, k: int):
        self.loader = loader
        self.k = max(int(k), 1)

    def __len__(self):
        return len(self.loader) // self.k

    def __iter__(self):
        from ..io.device_loader import _stacked_iter
        return _stacked_iter(iter(self.loader), self.k)


class Model:
    """High-level train/eval/predict facade over a Layer."""

    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._save_dir = None
        self._jit_compile = False
        self._train_step = None
        self._accumulate_steps = 1
        self._pending_microbatches = []
        self._grad_scaler = None
        self._grad_bucket_bytes = None
        # set by callbacks.AutoCheckpoint on resume: fit skips (replays the
        # data position of) the first N global batches without training
        self._resume_step = 0

    # -------------------------------------------------------------- prepare

    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None,
                jit_compile: bool = False, accumulate_steps: int = 1,
                grad_scaler=None, grad_bucket_bytes=None, recompute=None):
        """``accumulate_steps=K`` (K>1) trains through the compiled
        accumulation path: one ``jit.TrainStep`` executable consumes K
        stacked microbatches, runs forward/backward K times and applies ONE
        optimizer update — effective batch ×K with flat parameter/optimizer
        memory. Implies ``jit_compile=True`` (accumulation is compiled into the
        step; see ``train_batch`` for the eager-API adapter).

        ``grad_scaler``: an ``amp.GradScaler`` compiled into the TrainStep
        (dynamic loss scaling on device; requires the jit path). Its state
        is checkpointed/restored by ``callbacks.AutoCheckpoint``.

        ``grad_bucket_bytes``: taken; it only matters with a ZeRO-sharded
        optimizer, which is not ported (ROADMAP item 10).

        ``recompute``: activation-recompute policy applied to the network
        (``fleet/recompute.py`` layer): ``"selective"`` | ``"full"`` |
        ``"dots"`` | ``True`` (= "full") | ``"none"``/``False`` (off), or a
        dict ``{"granularity": ..., "interval": N}`` to checkpoint every Nth
        block. Requires the network to expose ``enable_recompute``; raises
        otherwise — silently ignoring it would train
        without the memory saving the caller sized their batch for."""
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]
        self._accumulate_steps = max(int(accumulate_steps), 1)
        if self._accumulate_steps > 1:
            jit_compile = True
        if jit_compile and self._metrics:
            raise ValueError(
                ("accumulate_steps>1 trains through jit.TrainStep, which "
                 "returns only the loss; hapi metrics need eager outputs — "
                 "drop the metrics or accumulate_steps"
                 if self._accumulate_steps > 1 else
                 "jit_compile=True trains through jit.TrainStep, which "
                 "returns only the loss; hapi metrics need eager outputs — "
                 "drop the metrics or jit_compile"))
        if grad_scaler is not None and not jit_compile:
            raise ValueError(
                "prepare(grad_scaler=...) compiles dynamic loss scaling into "
                "the jit.TrainStep executable — it requires jit_compile=True "
                "(the eager fit path never routes through the scaler, which "
                "would silently train without loss scaling)")
        self._grad_scaler = grad_scaler
        self._grad_bucket_bytes = grad_bucket_bytes
        self._jit_compile = jit_compile
        self._train_step = None
        self._pending_microbatches = []
        if recompute is not None:
            if isinstance(recompute, dict):
                gran = recompute.get("granularity", "full")
                interval = int(recompute.get("interval", 1))
            else:
                gran, interval = recompute, 1
            fn = getattr(self.network, "enable_recompute", None)
            off = gran in (False, "none")
            if fn is None:
                # turning recompute OFF on a network without the hook is a
                # no-op, not an error — only a requested SAVING that cannot
                # be delivered fails loudly
                if not off:
                    raise ValueError(
                        "prepare(recompute=...) needs a network exposing "
                        "enable_recompute(granularity, interval); wrap block "
                        "forwards in fleet.recompute(...) manually for "
                        "custom architectures")
            else:
                fn(gran, interval=interval)
        return self

    # -------------------------------------------------------------- batches

    def train_batch(self, inputs, labels=None, update=True, sync=True):
        """One optimizer step. ``sync=False`` returns the loss as an
        :class:`AsyncScalar` handle instead of forcing a device round-trip —
        the fit loop's ``metric_lag`` path resolves it with bounded lag."""
        self.network.train()
        inputs = _as_batch_tensors(inputs)
        labels = _as_batch_tensors(labels) if labels is not None else []
        if self._jit_compile and self._optimizer is not None:
            # host inputs go to the card in the step's staged copy
            K = self._accumulate_steps
            if K > 1:
                return self._accum_train_batch(inputs, labels, update, sync)
            if not update:
                # the eager path would accumulate p._grad across calls, but
                # the TrainStep executable computes grads from its own batch
                # only and never reads the tape — mixing them silently drops
                # the accumulated batches, so refuse loudly
                raise ValueError(
                    "prepare(jit_compile=True) compiles forward+backward+"
                    "update into one TrainStep executable; for gradient "
                    "accumulation under the compiled step, use "
                    "prepare(..., accumulate_steps=K) — it compiles the "
                    "whole K-microbatch accumulation window into ONE "
                    "executable (train_batch(update=False) then buffers "
                    "microbatches instead of refusing)")
            step = self._ensure_train_step(len(labels))
            loss = step(*inputs, *labels)
            # same return shape as the eager no-metrics path: a bare scalar
            return float(loss) if sync else AsyncScalar(loss)
        inputs, labels = self._on_device(inputs), self._on_device(labels)
        outs = self.network(*inputs)
        loss = self._loss(outs, *labels) if self._loss else outs
        loss.backward()
        if update and self._optimizer is not None:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = [float(loss) if sync else AsyncScalar(loss)]
        for m in self._metrics:
            m.update(*[_np(x) for x in self._metric_inputs(m, outs, labels)])
            metrics.append(m.accumulate())
        return metrics if len(metrics) > 1 else metrics[0]

    def _on_device(self, tensors):
        """``tensors`` on the network's device (an eager step's inputs).
        The device is read off the first parameter through torch's
        generator (``Layer.parameters`` builds the whole list)."""
        p = next(torch.nn.Module.parameters(self.network), None)
        if p is None:
            return tensors
        return [t if t.device == p.device else t.to(p.device)
                for t in tensors]

    def _accum_train_batch(self, inputs, labels, update, sync):
        """Compiled-accumulation adapter for the eager train_batch API.

        Two entry conventions:
        * ``update=False`` buffers ONE microbatch and returns None (the loss
          is not observable until the window's single compiled call);
          the closing ``update=True`` call contributes the last microbatch,
          stacks the window and runs it.
        * ``update=True`` with nothing buffered expects inputs ALREADY
          stacked (leading axis K — the fit loop's path via _StackedBatches /
          DeviceLoader(stack_batches=K)).
        Returns the mean loss over the window's microbatches."""
        if not update:
            self._pending_microbatches.append((inputs, labels))
            return None
        if self._pending_microbatches:
            from ..io.device_loader import stack_microbatches
            self._pending_microbatches.append((inputs, labels))
            window, self._pending_microbatches = \
                self._pending_microbatches, []
            if len(window) != self._accumulate_steps:
                raise ValueError(
                    f"accumulation window closed with {len(window)} "
                    f"microbatch(es) but prepare(accumulate_steps="
                    f"{self._accumulate_steps}): call train_batch("
                    f"update=False) exactly K-1 times before the "
                    f"update=True call (a mismatched window would silently "
                    f"train on a different effective batch and mint a new "
                    f"executable per distinct length)")
            inputs = stack_microbatches([ins for ins, _ in window])
            labels = stack_microbatches([lbs for _, lbs in window])
        else:
            K = self._accumulate_steps
            for t in list(inputs) + list(labels):
                if t.ndim == 0 or t.shape[0] != K:
                    raise ValueError(
                        f"prepare(accumulate_steps={K}) expects either "
                        f"update=False microbatch buffering or inputs "
                        f"stacked with leading axis {K} (got shape "
                        f"{tuple(t.shape)}); stack with "
                        f"io.stack_microbatches or feed fit() a "
                        f"DeviceLoader(stack_batches={K})")
        step = self._ensure_train_step(len(labels))
        loss = step(*inputs, *labels)
        return float(loss) if sync else AsyncScalar(loss)

    def _ensure_train_step(self, n_labels: int):
        """Build the one-executable TrainStep behind prepare(jit_compile=True)
        lazily (label arity is only known at the first batch)."""
        if self._train_step is None:
            from ..jit import TrainStep
            net = self.network
            if self._loss is not None:
                net = _LossNet(self.network, self._loss, n_labels)
            self._train_step = TrainStep(
                net, self._optimizer,
                accumulate_steps=self._accumulate_steps,
                grad_scaler=self._grad_scaler)
        return self._train_step

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = self._on_device(_as_batch_tensors(inputs))
        labels = self._on_device(_as_batch_tensors(labels)) \
            if labels is not None else []
        outs = self.network(*inputs)
        loss = self._loss(outs, *labels) if self._loss else outs
        metrics = [float(loss)]
        for m in self._metrics:
            m.update(*[_np(x) for x in self._metric_inputs(m, outs, labels)])
            metrics.append(m.accumulate())
        return metrics if len(metrics) > 1 else metrics[0]

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs = self._on_device(_as_batch_tensors(inputs))
        outs = self.network(*inputs)
        return outs

    def _metric_inputs(self, metric, outs, labels):
        out = outs[0] if isinstance(outs, (list, tuple)) else outs
        compute = getattr(metric, "compute", None)
        if compute is not None and labels:
            r = compute(out, *labels)
            return list(r) if isinstance(r, (list, tuple)) else [r]
        return [out] + labels

    # ------------------------------------------------------------------ fit

    def fit(self, train_data=None, eval_data=None, batch_size: int = 1,
            epochs: int = 1, eval_freq: int = 1, log_freq: int = 10,
            save_dir: Optional[str] = None, save_freq: int = 1,
            verbose: int = 2, drop_last: bool = False, shuffle: bool = True,
            num_workers: int = 0, callbacks=None, metric_lag: int = 0):
        train_loader = self._to_loader(train_data, batch_size, shuffle,
                                       drop_last, num_workers)
        if self._accumulate_steps > 1 and getattr(
                train_loader, "stack_batches", 1) != self._accumulate_steps:
            if hasattr(train_loader, "stack_batches"):
                # a DeviceLoader configured for the wrong window: re-stacking
                # its device-resident batches here would undo the prefetch
                # overlap and the sharded placement — misconfiguration, not
                # something to paper over
                raise ValueError(
                    f"fit() with prepare(accumulate_steps="
                    f"{self._accumulate_steps}) needs the DeviceLoader "
                    f"constructed with stack_batches="
                    f"{self._accumulate_steps} (got "
                    f"{train_loader.stack_batches}) so whole accumulation "
                    f"windows are stacked before the device transfer")
            # one fit step = one K-microbatch accumulation window; plain
            # host-side loaders stack here
            train_loader = _StackedBatches(train_loader,
                                           self._accumulate_steps)
        eval_loader = (self._to_loader(eval_data, batch_size, False, False,
                                       num_workers)
                       if eval_data is not None else None)
        self._save_dir = save_dir
        self.stop_training = False
        self._resume_step = 0  # an AutoCheckpoint callback may set it next
        self._metric_lag = metric_lag
        try:
            steps = len(train_loader) if hasattr(train_loader, "__len__") \
                else None
        except TypeError:  # sized wrapper over an unsized iterable
            steps = None
        cbks = config_callbacks(callbacks, self, epochs, steps,
                                verbose=verbose, save_dir=save_dir,
                                log_freq=log_freq)

        history = []
        try:
            # inside the try: a sibling callback raising in on_train_begin
            # must still reach on_train_abort, or an already-installed
            # AutoCheckpoint watcher leaks its process-global handlers
            cbks.on_train_begin()
            history = self._fit_loop(train_loader, eval_loader, epochs,
                                     eval_freq, steps, verbose, cbks,
                                     metric_lag)
        except BaseException as e:
            # flight-recorder post-mortem of the crashed run (no-op when the
            # monitor is disabled), then let callbacks release process-global
            # resources (on_train_end will never run)
            _monitor.on_crash(e)
            try:
                cbks.on_train_abort(e)
            except Exception:
                pass
            raise
        cbks.on_train_end()
        return history

    def _fit_loop(self, train_loader, eval_loader, epochs, eval_freq, steps,
                  verbose, cbks, metric_lag):
        history = []
        # global (cross-epoch) batch counter; after an auto-resume the first
        # `_resume_step` batches are consumed WITHOUT training so the data
        # stream position matches the run being resumed
        self._global_step = 0
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.set_params({"epochs": epochs, "steps": steps, "epoch": epoch,
                             "verbose": verbose})
            cbks.on_epoch_begin(epoch)
            t_epoch = time.perf_counter()
            step = -1
            for m in self._metrics:
                m.reset()
            logs = {}
            if metric_lag > 0:
                if self._metrics and epoch == 0:
                    import warnings
                    warnings.warn(
                        "fit(metric_lag=...) defers only the LOSS readback; "
                        "hapi metrics update from eager outputs via .numpy() "
                        "and force a device sync every step regardless — "
                        "drop the metrics (or compute them at eval time) to "
                        "actually overlap readback", stacklevel=2)
                # non-blocking readback: hold loss handles, resolve them when
                # the device has already delivered (free) or after at most
                # metric_lag steps (bounded staleness); callbacks still see
                # every step in order
                drain = MetricDrain(max_lag=metric_lag)
                for step, batch in enumerate(train_loader):
                    if self.stop_training:
                        break  # emergency checkpoint / early stop mid-epoch
                    self._global_step += 1
                    if self._global_step <= self._resume_step:
                        continue  # replaying data position after auto-resume
                    cbks.on_train_batch_begin(step)
                    ins, lbs = self._split_batch(batch)
                    res = self.train_batch(ins, lbs, sync=False)
                    drain.push(step, res if isinstance(res, list) else [res])
                    for s, vals in drain.ready():
                        logs = self._logs_from(vals)
                        cbks.on_train_batch_end(s, logs)
                for s, vals in drain.flush():  # epoch-end sync point
                    logs = self._logs_from(vals)
                    cbks.on_train_batch_end(s, logs)
            else:
                for step, batch in enumerate(train_loader):
                    if self.stop_training:
                        break  # emergency checkpoint / early stop mid-epoch
                    self._global_step += 1
                    if self._global_step <= self._resume_step:
                        continue  # replaying data position after auto-resume
                    cbks.on_train_batch_begin(step)
                    ins, lbs = self._split_batch(batch)
                    res = self.train_batch(ins, lbs)
                    logs = self._logs_from(res)
                    cbks.on_train_batch_end(step, logs)
            if self.stop_training:
                # stopped MID-epoch (emergency checkpoint / callback): no
                # epoch-end callbacks, no eval over a truncated epoch — and
                # a preempted rank must exit inside the launcher's grace
                # window, not run a full evaluation pass first
                break
            if self._global_step <= self._resume_step:
                # the WHOLE epoch was replayed data positioning after an
                # auto-resume: no training happened, so no epoch-end
                # callbacks (an EarlyStopping eval on identical restored
                # weights would count it as "no improvement"), no eval, no
                # history entry
                continue
            cbks.on_epoch_end(epoch, logs)
            mon = _monitor._active
            if mon is not None:
                mon.epoch_event(epoch, steps=step + 1,
                                wall_s=time.perf_counter() - t_epoch,
                                logs=logs)
            history.append(logs)

            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self._run_eval(eval_loader, cbks)
                history[-1] = {**logs, **{f"eval_{k}": v
                                          for k, v in eval_logs.items()}}
        return history

    def evaluate(self, eval_data, batch_size: int = 1, log_freq: int = 10,
                 verbose: int = 2, num_workers: int = 0, callbacks=None):
        loader = self._to_loader(eval_data, batch_size, False, False,
                                 num_workers)
        cbks = config_callbacks(callbacks, self, 1,
                                len(loader) if hasattr(loader, "__len__")
                                else None, verbose=0)
        return self._run_eval(loader, cbks)

    def _run_eval(self, loader, cbks) -> dict:
        cbks.on_eval_begin()
        for m in self._metrics:
            m.reset()
        logs = {}
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, lbs = self._split_batch(batch)
            res = self.eval_batch(ins, lbs)
            logs = self._logs_from(res)
            cbks.on_eval_batch_end(step, logs)
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size: int = 1, num_workers: int = 0,
                stack_outputs: bool = False, callbacks=None):
        loader = self._to_loader(test_data, batch_size, False, False,
                                 num_workers)
        cbks = config_callbacks(callbacks, self, 1, None, verbose=0)
        cbks.on_predict_begin()
        outputs = []
        for step, batch in enumerate(loader):
            cbks.on_predict_batch_begin(step)
            ins, _ = self._split_batch(batch)
            out = self.predict_batch(ins)
            outputs.append(out)
            cbks.on_predict_batch_end(step)
        cbks.on_predict_end()
        if stack_outputs:
            if outputs and isinstance(outputs[0], (list, tuple)):
                # multi-output network: stack each output field separately
                n_fields = len(outputs[0])
                return [np.concatenate([_np(b[i]) for b in outputs], axis=0)
                        for i in range(n_fields)]
            return np.concatenate([_np(o) for o in outputs], axis=0)
        return outputs

    # ------------------------------------------------------------- plumbing

    def _split_batch(self, batch):
        """(x, y) convention: last element is the label when a loss is set."""
        if isinstance(batch, (list, tuple)) and len(batch) >= 2 and self._loss:
            return list(batch[:-1]), [batch[-1]]
        return ([batch] if not isinstance(batch, (list, tuple))
                else list(batch)), None

    def _logs_from(self, res) -> dict:
        vals = res if isinstance(res, list) else [res]
        logs = {"loss": float(vals[0])}
        for m, v in zip(self._metrics, vals[1:]):
            v = v[0] if isinstance(v, (list, tuple)) else v
            logs[m.name() if not isinstance(m.name(), (list, tuple))
                 else m.name()[0]] = float(v)
        return logs

    def _to_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        from ..io import DataLoader, Dataset
        if data is None:
            raise ValueError("data is required")
        if isinstance(data, DataLoader) or (hasattr(data, "__iter__")
                                            and not isinstance(data, Dataset)):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    # ----------------------------------------------------------- save/load

    def save(self, path: str, training: bool = True):
        """training=True: params (+ optimizer) checkpoint; False, the
        inference export through ``jit.save``, is not ported (ROADMAP
        item 11) and raises."""
        from .. import framework
        if not training:
            raise NotImplementedError(
                "Model.save(training=False) exports through jit.save, which "
                "is not ported yet: ROADMAP Queue 1, item 11 (jit.to_static "
                "and the JAX tape)")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        framework.io.save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None and \
                hasattr(self._optimizer, "state_dict"):
            framework.io.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False, reset_optimizer=False):
        from .. import framework
        state = framework.io.load(path + ".pdparams")
        if skip_mismatch:
            current = self.network.state_dict()
            state = {k: v for k, v in state.items()
                     if k in current and tuple(v.shape)
                     == tuple(current[k].shape)}
        self.network.set_state_dict(state)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(opt_path):
            self._optimizer.set_state_dict(framework.io.load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None) -> dict:
        total = 0
        trainable = 0
        for _, p in self.network.named_parameters():
            n = p.numel()
            total += n
            if p.requires_grad:
                trainable += n
        return {"total_params": total, "trainable_params": trainable}
