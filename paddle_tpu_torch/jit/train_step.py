"""``TrainStep``: one call is forward, backward and update (counterpart of
``paddle_tpu/jit/train_step.py``).

The JAX package compiles the whole step into one XLA executable. Here the
step is eager PyTorch with the attention's forward and backward in the
hand-written flash kernels, and computes what that executable computes:

* ``accumulate_steps=K``: every input carries a leading axis of K
  microbatches; K forward/backward passes sum their gradients into fp32
  buffers (a bf16 ``.grad`` would sum in bf16), the loss is the mean of
  the K losses, ``average_grads`` (default True) multiplies the sum by
  1/K, and ONE update follows. Activations live for one microbatch at a
  time.
* ``grad_scaler=``: the loss is multiplied by the scale before each
  backward, the gradients by ``factor / scale`` in one product, one
  found-inf flag covers the window (one host sync), the optimizer's clip
  comes after the unscale, and on overflow the update is skipped:
  parameters, masters and moments stay as they were and the step counter
  does not advance (the JAX package rolls it back). The scaler then
  replays its state machine on the flag.
* a model with activation recompute just trains.

Every step, K = 1 included, takes the gradients with ``autograd.grad``
(``.grad`` is not touched) and hands them to the optimizer's
``apply_gradients``. A parameter the loss does not reach gets a zero
gradient and is updated like the others (its decay applied, its moments
advanced), as in the JAX package's compiled step. Under ``auto_cast`` the
forward casts by the caller's state; the backward, the unscale and the
update run uncast (a recompute reopens its forward's state), as the
compiled step differentiates the cast forward and updates in fp32.

With the monitor on (``paddle_tpu_torch.monitor``) a call reports as the
JAX package's slow-path step does: one ``train_step`` trace with a
``dispatch`` span; at a new input signature (shapes, dtypes, devices) the
call is the mint — ``recompile`` (``path="eager"``, no separate compile
wall, the call's FLOPs counted), then ``accumulation`` when K > 1 and
``remat`` when the model recomputes — and every other call a ``step``
with its host wall (no synchronisation is added); ``skip_update`` on a
scaler overflow; the health plane's reductions and host check on its
sample cadence only; a flight dump when the step raises. With the
monitor and the tracer off the call is the step itself.

Capturing the step into a CUDA graph (the counterpart of the AOT
executable) needs the kernels to read their dropout seed from device
memory first (ROADMAP Queue 1).
"""
from __future__ import annotations

import itertools
import time
from contextlib import ExitStack
from typing import Callable, Optional

import numpy as np
import torch

from .. import monitor as _monitor
from ..amp.grad_scaler import found_inf
from ..core import remat as _remat
from ..core.amp_state import applied
from ..monitor import goodput as _goodput
from ..monitor import health as _health
from ..monitor import trace as _trace

__all__ = ["TrainStep"]


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"TrainStep: {what} is not ported yet "
                               f"(ROADMAP Queue 1, item {item})")


class TrainStep:
    """``TrainStep(model, optimizer, loss_fn=None, accumulate_steps=None,
    average_grads=None, grad_scaler=None)``; ``step(*inputs)`` runs one
    training step and returns the loss, detached.

    The loss is ``loss_fn(out)`` when ``loss_fn`` is given, else ``out``
    when the model returns a tensor, else ``out[-1]`` (the ``(logits,
    loss)`` convention: ``GPTForCausalLM(ids, labels)`` returns ``(None,
    loss)``). Inputs pass positionally. The checkpoint methods raise
    ``NotImplementedError``."""

    _ids = itertools.count()

    def __init__(self, model: torch.nn.Module, optimizer,
                 loss_fn: Optional[Callable] = None,
                 accumulate_steps: Optional[int] = None,
                 average_grads: Optional[bool] = None, grad_scaler=None):
        self._model = model
        self._opt = optimizer
        self._loss_fn = loss_fn
        self._acc_steps = max(int(accumulate_steps or 1), 1)
        self._avg = True if average_grads is None else bool(average_grads)
        self._scaler = grad_scaler
        self._scaler_on = grad_scaler is not None and grad_scaler.is_enable()
        # monitor state, read only while the monitor or the tracer is on:
        # the signatures met (-> their mint count), the previous call's, the
        # open step trace, and the step counter the health cadence keys on
        self._gp_id = next(TrainStep._ids)
        self._mon_sigs = {}
        self._mon_prev_sig = None
        self._cur_trace = None
        self._trace_n = 0
        self._health_n = 0
        self._leaf_meta = None
        self._mint_cost = None

    def _loss(self, inputs):
        out = self._model(*inputs)
        if self._loss_fn is not None:
            return self._loss_fn(out)
        return out if torch.is_tensor(out) else out[-1]

    def __call__(self, *inputs):
        if _monitor._active is None and _trace._active is None:
            return self._step(inputs)
        return self._observed(inputs)

    def _step(self, inputs, health=None):
        """One step; ``health`` (a ``monitor.health.DeviceStats``) takes its
        reductions around the update on a sampled step."""
        k = self._acc_steps
        if k > 1:
            for i, a in enumerate(inputs):
                if not torch.is_tensor(a) or a.dim() == 0 \
                        or a.shape[0] != k:
                    raise ValueError(
                        f"TrainStep(accumulate_steps={k}) expects every "
                        f"input stacked with leading axis {k} (K "
                        f"microbatches per call); input[{i}] has shape "
                        f"{tuple(getattr(a, 'shape', ()))}")
        params = [p for p in self._opt._parameter_list if p.requires_grad]
        scale = self._scaler._scale if self._scaler_on else None
        if k == 1:
            loss, grads = self._grads(params, inputs, scale)
            factor = 1.0
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32,
                                      memory_format=torch.contiguous_format)
                     for p in params]
            losses = []
            for i in range(k):
                loss_i, g_i = self._grads(params, [a[i] for a in inputs],
                                          scale)
                # the recompute statistics describe one microbatch's
                # forward, as the JAX package's traced scan body does
                _remat.stop_trace_stats()
                losses.append(loss_i)
                for acc, g in zip(grads, g_i):
                    acc.add_(g)
                del g_i
            loss = torch.stack(losses).mean()
            factor = 1.0 / k if self._avg else 1.0
        found = False
        with torch.no_grad(), applied(None):
            if self._scaler_on:
                # 1/scale and 1/K in one product, in fp32, cast to each
                # gradient's type
                f = float(np.float32(factor) / np.float32(scale))
                grads = [g * torch.tensor(f, dtype=g.dtype) for g in grads]
                found = found_inf(grads)
            elif factor != 1.0:
                grads = [g * torch.tensor(factor, dtype=g.dtype)
                         for g in grads]
            if health is not None:
                health.grads(grads)
                for p in params:
                    self._opt._ensure_state(p)
                health.before_update([self._opt._master_weights.get(id(p), p)
                                      for p in params])
            if not found:
                self._opt.apply_gradients(params, grads)
            if health is not None:
                health.after_update()
        self._found = found
        if self._scaler_on:
            self._scaler._compiled_outcome(found)
        return loss.detach()

    # ------------------------------------------------------------- monitor

    def _observed(self, inputs):
        """``__call__`` with the monitor or the tracer on (the JAX
        package's ``__call__`` + ``_call_impl`` on its slow path)."""
        mon = _monitor._active
        if mon is not None and mon.health.fault is not None:
            # chaos seam: a scheduled PADDLE_HEALTH_FAULT poisons a live
            # parameter in place before this call runs
            mon.health.fault.maybe_fire(self._named_params(), emit=mon.emit)
        tracer = _trace._active
        t = None
        if tracer is not None:
            self._trace_n += 1
            t = tracer.start_trace("train_step", kind="step",
                                   step=self._trace_n)
            self._cur_trace = t
        try:
            return self._monitored_step(inputs, mon)
        except BaseException as e:
            # flight-recorder post-mortem before the exception unwinds
            if t is not None:
                t.event("crash", exc=type(e).__name__)
                t.escalate("crash")
            _monitor.on_crash(e)
            raise
        finally:
            if t is not None:
                self._cur_trace = None
                t.end()

    def _monitored_step(self, inputs, mon):
        sig = tuple((tuple(a.shape), str(a.dtype).replace("torch.", ""),
                     str(a.device)) if torch.is_tensor(a)
                    else ((), type(a).__name__, "host") for a in inputs)
        mint = mon is not None and sig not in self._mon_sigs
        health = None
        if mon is not None and mon.health.should_sample(self._health_n + 1):
            names, transposed = self._leaf_names()
            health = mon.health.device_stats(names, transposed)
        step_trace = self._cur_trace
        with ExitStack() as stack:
            cost = stack.enter_context(_goodput.FlopCount()) if mint \
                else None
            if mint:
                _remat.reset_trace_stats()
            taps = stack.enter_context(_health.collect_taps()) \
                if health is not None else None
            t0 = time.perf_counter()
            try:
                loss = self._step(inputs, health)
            finally:
                if mint:
                    _remat.stop_trace_stats()
            t1 = time.perf_counter()
        k = self._acc_steps
        if step_trace is not None:
            step_trace.record("dispatch", t0, t1, path="eager",
                              microbatches=k)
        if mon is not None:
            if mint:
                n = len(self._mon_sigs) + 1
                self._mon_sigs[sig] = n
                self._mint_cost = cost     # its kernel share, for reports
                if step_trace is not None:
                    # the call above WAS the mint; link the sentinel
                    step_trace.event("recompile", count=n, path="eager")
                mon.train_step_compiled(
                    sig, self._mon_prev_sig, compile_s=None, count=n,
                    path="eager", cost=cost, span=(t0, t1),
                    **self._flop_kwargs(inputs))
                if k > 1:
                    mon.accum_config(k, 4 * sum(
                        p.numel() for p in self._opt._parameter_list
                        if p.requires_grad))
                self._emit_remat_gauges(mon)
            else:
                mon.step_event(t1 - t0, microbatches=k,
                               bucket=self._mon_sigs[sig], span=(t0, t1),
                               step_id=self._gp_id)
            self._mon_prev_sig = sig
        if self._scaler_on and self._found:
            if step_trace is not None:
                # a skipped update is exactly the kind of step a
                # post-mortem wants whole: force it past head sampling
                step_trace.event("skip_update", microbatches=k)
                step_trace.escalate("skip_update")
            if mon is not None:
                mon.update_skipped(k)
        if mon is not None:
            self._health_n += 1
            if health is not None:
                act = taps.harvest()
                payload = health.read(loss, act)
                mon.health.on_sample(health, self._health_n,
                                     payload["loss"], payload,
                                     named_params=self._named_params())
        return loss

    def _named_params(self):
        names, _ = self._leaf_names()
        params = [p for p in self._opt._parameter_list if p.requires_grad]
        return list(zip(names, params))

    def _leaf_names(self):
        """The trainable leaves' names in update order (the model's
        parameter names) and which of them are ``nn.Linear`` weights, held
        transposed from the JAX layout (``convert.py``)."""
        if self._leaf_meta is None:
            from ..convert import _linear_weight_names
            by_id = {id(p): n for n, p in self._model.named_parameters()}
            linear = _linear_weight_names(self._model)
            params = [p for p in self._opt._parameter_list
                      if p.requires_grad]
            names = [by_id.get(id(p), f"param{i}")
                     for i, p in enumerate(params)]
            self._leaf_meta = (names, [n in linear for n in names])
        return self._leaf_meta

    def _flop_kwargs(self, inputs) -> dict:
        """Per-mint FLOP-ledger context: tokens one call consumes (every
        element of the first input), the analytic 6ND model over the
        trainable parameters plus the attention term 12·L·d·S when the
        model's config has them, and whether the model recomputes
        (measured FLOPs then include the replays, so MFU takes the
        analytic model while HFU stays measured)."""
        first = inputs[0] if inputs else None
        tokens, seq = 1, 0
        if torch.is_tensor(first) and first.dim():
            tokens = int(first.numel())
            if first.dim() >= 2:
                seq = int(first.shape[-1])
        cfg = getattr(self._model, "config", None)
        n_train = sum(p.numel() for p in self._opt._parameter_list
                      if p.requires_grad)
        fpt = _goodput.analytic_train_flops_per_token(
            n_train, getattr(cfg, "num_layers", None),
            getattr(cfg, "hidden_size", None), seq or None)
        return dict(tokens=tokens, analytic_flops=fpt * tokens,
                    step_id=self._gp_id, recompute=self._recompute_wanted())

    def _recompute_wanted(self) -> bool:
        cfg = getattr(self._model, "config", None)
        return getattr(cfg, "recompute_granularity", "none") != "none"

    def _emit_remat_gauges(self, mon):
        """remat/* gauges: what the mint call recomputed against what the
        model declared (``remat/requested`` with ``remat/regions == 0`` is
        the lost-checkpoint signature ``tools/metrics_summary.py`` WARNs
        on)."""
        wanted = self._recompute_wanted()
        stats = _remat.trace_stats()
        if not wanted and stats["regions"] == 0:
            return
        mon.remat_compiled(wanted, stats["regions"], stats["policy"],
                           stats["total_named_bytes"], stats["named_bytes"])

    def _grads(self, params, inputs, scale):
        """One microbatch's loss and the gradients of every parameter of
        ``params`` (zeros where the loss does not reach one), of the loss
        times ``scale`` when a scale is given; ``.grad`` is not touched."""
        loss = self._loss(inputs)
        with applied(None):
            target = loss if scale is None \
                else loss * torch.tensor(scale, dtype=loss.dtype)
            grads = torch.autograd.grad(target, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    def save_checkpoint(self, *args, **kwargs):
        raise _unported("checkpointing", 10)

    def load_checkpoint(self, *args, **kwargs):
        raise _unported("checkpointing", 10)

    def wait_checkpoint(self, *args, **kwargs):
        raise _unported("checkpointing", 10)

    def rollback_last_commit(self, *args, **kwargs):
        raise _unported("checkpointing", 10)
