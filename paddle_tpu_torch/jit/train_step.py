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
* ``fleet.GradientMergeOptimizer(opt, k_steps, avg)`` as the optimizer is
  unwrapped to ``opt`` with ``accumulate_steps=k_steps`` and
  ``average_grads=avg`` (explicit arguments win), as the JAX package's
  step adopts it.

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

``fast_path=True`` (the default, as in the JAX package) runs the step as
a program (``core/programs.py``), the counterpart of the JAX package's AOT
executable: one program per input signature (shapes, dtypes, devices, and
the values of non-tensor inputs), a CUDA graph captured at its first call
on the card, its body run eagerly on the CPU. ``num_compiles`` counts the
programs held, as the JAX package counts its executables. Everything that
changes from call to call is device data written by ONE staged copy a
call (``StagedBuffer``): the inputs held on the host (inputs already on
the card are copied into the program's input buffers on the card), the
optimizer's step scalars (``Optimizer.step_scalars``: lr and Adam's bias
corrections, computed on the host as the eager step computes them), the
loss scale and ``factor / scale``, and the dropout seeds (``core.random.
SeedStage``: the host draws them from the same generators in the same
order as the eager step). The step count lives on the host: it advances
before the call and goes back when the scaler's flag says the update was
skipped. The scaler's flag stays on the device and masks the update
(parameters, masters and moments keep their bits on an overflow); the
host reads it once after the call. The loss comes back as a copy. So the
fast path computes the eager step's bits (``fast_path=False`` is the
eager step above).

The captured storage of every parameter, buffer, master and moment is
recorded; a leaf replaced between calls by one of the same shape, type
and device (``p.data = ...``) is copied into the captured storage and
handed back to its owner, building nothing. One that cannot be (another
type or shape) drops every program (a ``fast_state_dropped`` record) and
the next call builds again. Nothing falls back: on the card a capture or
replay that fails raises.

With the monitor on, a program's first call is the mint (``recompile``,
``path="graph"``, its FLOPs counted on its eager run) and every later call
a ``step`` around the replay. Health is data: a program built with the
health plane on takes its reductions in every call and the host reads
them on the sampled ones; the activation taps likewise.
"""
from __future__ import annotations

import itertools
import time
import weakref
from contextlib import ExitStack, nullcontext
from typing import Callable, Optional

import numpy as np
import torch

from .. import monitor as _monitor
from ..amp.grad_scaler import found_inf, found_inf_flag
from ..core import remat as _remat
from ..core.amp_state import applied
from ..core.programs import ProgramRegistry, StagedBuffer
from ..core.random import SeedStage
from ..monitor import goodput as _goodput
from ..monitor import health as _health
from ..monitor import trace as _trace

__all__ = ["TrainStep"]


class TrainStep:
    """``TrainStep(model, optimizer, loss_fn=None, accumulate_steps=None,
    average_grads=None, grad_scaler=None, donate_params=True,
    fast_path=True)``; ``step(*inputs)`` runs one training step and
    returns the loss, detached. ``donate_params`` is taken for the JAX
    package's signature: the update is in place either way.

    The loss is ``loss_fn(out)`` when ``loss_fn`` is given, else ``out``
    when the model returns a tensor, else ``out[-1]`` (the ``(logits,
    loss)`` convention: ``GPTForCausalLM(ids, labels)`` returns ``(None,
    loss)``). Inputs pass positionally.

    ``save_checkpoint`` / ``load_checkpoint`` / ``wait_checkpoint`` /
    ``rollback_last_commit`` snapshot and restore the model, the optimizer
    and the step's ``GradScaler`` through ``distributed.checkpoint`` (one
    card; atomic commits, async writes, fall-back past torn snapshots)."""

    _ids = itertools.count()

    def __init__(self, model: torch.nn.Module, optimizer,
                 loss_fn: Optional[Callable] = None,
                 accumulate_steps: Optional[int] = None,
                 average_grads: Optional[bool] = None, grad_scaler=None,
                 donate_params: bool = True, fast_path: bool = True):
        self._model = model
        # fleet.GradientMergeOptimizer is a thin adapter onto accumulation:
        # adopt its k_steps / avg while unwrapping the optimizer chain
        while hasattr(optimizer, "_inner_opt"):
            if getattr(optimizer, "_gradient_merge", False):
                if accumulate_steps is None:
                    accumulate_steps = optimizer.k_steps
                if average_grads is None:
                    average_grads = optimizer.avg
            optimizer = optimizer._inner_opt
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
        self._ckptr = None       # the AsyncCheckpointer of save_checkpoint
        self._fast_path = bool(fast_path)
        self._programs: Optional[ProgramRegistry] = None
        self._captured = None    # the leaves' captured storage
        self._built = None       # on_built's report of the call in progress
        self._eager_sigs = set()

    @property
    def num_compiles(self) -> int:
        """Programs held (the fast path: one per input signature, as the
        JAX package's executables) or signatures met (the eager step)."""
        if self._fast_path:
            return 0 if self._programs is None else len(self._programs)
        return len(self._eager_sigs)

    def _loss(self, inputs):
        out = self._model(*inputs)
        if self._loss_fn is not None:
            return self._loss_fn(out)
        return out if torch.is_tensor(out) else out[-1]

    def __call__(self, *inputs):
        if _monitor._active is None and _trace._active is None:
            self._check_stacked(inputs)
            if self._fast_path:
                return self._fast_call(self._fast_program(inputs, None),
                                       inputs)
            self._eager_sigs.add(self._signature(inputs))
            return self._step(inputs)
        return self._observed(inputs)

    def _check_stacked(self, inputs):
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

    @staticmethod
    def _signature(inputs):
        """Shapes, dtypes and devices of the inputs (the monitor's)."""
        return tuple((tuple(a.shape), str(a.dtype).replace("torch.", ""),
                      str(a.device)) if torch.is_tensor(a)
                     else ((), type(a).__name__, "host") for a in inputs)

    def _step(self, inputs, health=None):
        """One step; ``health`` (a ``monitor.health.DeviceStats``) takes its
        reductions around the update on a sampled step."""
        k = self._acc_steps
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

    # ------------------------------------------------------------ fast path

    def _device(self) -> torch.device:
        p = next(iter(self._model.parameters()), None)
        return torch.device("cpu") if p is None else p.device

    def _fast_program(self, inputs, mon):
        """The program of ``inputs``' signature, built (not yet run) when
        there is none; the leaves re-adopted first."""
        reg = self._programs
        if reg is None:
            reg = self._programs = ProgramRegistry(
                self._device(), lambda: nullcontext())
            me = weakref.ref(self)
            reg.on_built = lambda prog, s, cost: me()._on_built(prog, s,
                                                                cost)
        self._readopt()
        health = mon is not None and mon.health.enabled
        key = (tuple((tuple(a.shape), a.dtype, a.device)
                     if torch.is_tensor(a) else (type(a), a)
                     for a in inputs), health)
        return reg.get(key, lambda: self._build_fast(inputs, mon
                                                     if health else None))

    def _on_built(self, prog, build_s, cost):
        self._built = (build_s, cost)

    def _build_fast(self, inputs, mon):
        """A new program: its buffers (``_FastState``) and its body."""
        dev = self._device()
        opt = self._opt
        params = [p for p in opt._parameter_list if p.requires_grad]
        for p in params:
            opt._ensure_state(p)
        if self._captured is None:
            self._captured = self._capture_record()
        st = _FastState(self, inputs, params, dev, mon)
        return _Body(self, st), st

    def _capture_record(self):
        """The storage every captured read or write lands in: each
        parameter and buffer of the model (and any optimizer parameter
        outside it), each master and moment."""
        opt = self._opt
        leaves = list(self._model.parameters())
        seen = {id(t) for t in leaves}
        leaves += [p for p in opt._parameter_list if id(p) not in seen]
        tensors = [(t, t.data) for t in leaves]
        tensors += [(t, t.data) for t in self._model.buffers()]
        masters = [(pid, m) for pid, m in opt._master_weights.items()]
        moments = [(pid, name, t) for pid, acc in opt._accumulators.items()
                   for name, t in acc.items()]
        return tensors, masters, moments

    def _readopt(self):
        """Hand every replaced leaf's values to its captured storage, or
        drop the programs when one cannot take them."""
        cap = self._captured
        if cap is None:
            return
        tensors, masters, moments = cap
        opt = self._opt
        for t, old in tensors:
            if t.data_ptr() != old.data_ptr():
                if not self._adopt(t.data, old, "a parameter or buffer"):
                    return
                t.data = old
        for pid, old in masters:
            new = opt._master_weights.get(pid)
            if new is not old:
                if new is None or not self._adopt(new, old, "a master"):
                    return
                opt._master_weights[pid] = old
        for pid, name, old in moments:
            new = opt._accumulators.get(pid, {}).get(name)
            if new is not old:
                if new is None or not self._adopt(new, old, "a moment"):
                    return
                opt._accumulators[pid][name] = old

    def _adopt(self, new, old, what) -> bool:
        if new.shape != old.shape or new.dtype != old.dtype \
                or new.device != old.device:
            self._drop_programs(
                f"{what} was replaced by one of {tuple(new.shape)} "
                f"{new.dtype} on {new.device}; the programs hold "
                f"{tuple(old.shape)} {old.dtype} on {old.device}")
            return False
        with torch.no_grad():
            old.copy_(new)
        return True

    def _drop_programs(self, why: str):
        """Forget every program and the captured storage; the next call
        builds again (``fast_state_dropped``)."""
        reg = self._programs
        n = len(reg)
        reg._programs.clear()
        reg.pool = None
        self._captured = None
        mon = _monitor._active
        if mon is not None:
            mon.fast_state_dropped(why, n, step_id=self._gp_id)

    def _fast_call(self, prog, inputs):
        """Stage this call's values (one copy), run the program, and read
        the scaler's flag after it."""
        st = prog.state
        opt = self._opt
        step_n = opt._step_count + 1
        k = self._acc_steps
        st.stage(inputs, opt.step_scalars(step_n),
                 self._scaler._scale if self._scaler_on else None,
                 1.0 / k if k > 1 and self._avg else 1.0)
        opt._step_count = step_n
        prog()
        found = False
        if self._scaler_on:
            found = bool(st.found)                 # the one host read
            if found:
                opt._step_count = step_n - 1
            self._scaler._compiled_outcome(found)
        self._found = found
        return st.loss.clone()

    def _fast_run(self, st):
        """The program's body: forward, backward and update reading only
        ``st``'s buffers, the model's and the optimizer's."""
        k = self._acc_steps
        params = st.params
        scal = st.dev["scalars"]
        n = st.n_opt
        scale = scal[n] if self._scaler_on else None
        with ExitStack() as stack:
            stack.enter_context(st.seeds.running())
            taps = stack.enter_context(_health.collect_taps()) \
                if st.stats is not None else None
            inputs = st.inputs()
            if k == 1:
                loss, grads = self._grads(params, inputs, scale)
            else:
                grads = [torch.zeros_like(
                    p, dtype=torch.float32,
                    memory_format=torch.contiguous_format) for p in params]
                losses = []
                for i in range(k):
                    loss_i, g_i = self._grads(params, [a[i] for a in inputs],
                                              scale)
                    _remat.stop_trace_stats()
                    losses.append(loss_i)
                    for acc, g in zip(grads, g_i):
                        acc.add_(g)
                    del g_i
                loss = torch.stack(losses).mean()
            _remat.stop_trace_stats()
        factor = 1.0 / k if k > 1 and self._avg else 1.0
        found = None
        with torch.no_grad(), applied(None):
            if self._scaler_on:
                f = scal[n + 1]
                grads = [g * f.to(g.dtype) for g in grads]
                found = found_inf_flag(grads)
            elif factor != 1.0:
                grads = [g * torch.tensor(factor, dtype=g.dtype)
                         for g in grads]
            stats = st.stats
            if stats is not None:
                stats.grads(grads)
                stats.before_update([self._opt._master_weights.get(id(p), p)
                                     for p in params])
            self._opt.apply_gradients(params, grads, staged=scal[:n],
                                      skip=found)
            if stats is not None:
                # the digests are the host's, on the sampled calls
                stats.after_update(digests=False)
                if st.hbuf is None:           # the first run: its gradients
                    st.first_grads = grads    # (a capture's are not yet)
            if st.loss is None:               # the first run, not captured
                st.loss = torch.empty_like(loss)
            st.loss.copy_(loss)
            if found is not None:
                st.found.copy_(found)
            if stats is not None:
                act = taps.harvest()
                flat = stats.gather(loss, act)
                if st.hbuf is None:           # the first run, not captured
                    st.hbuf = torch.empty_like(flat)
                    st.act_names = list(act)
                st.hbuf.copy_(flat)

    def _monitored_fast(self, inputs, mon):
        """``_monitored_step`` on the fast path: the program's first call
        is the mint; the health plane's reductions run in every call and
        are read on the sampled ones."""
        sig = self._signature(inputs)
        prog = self._fast_program(inputs, mon)
        mint = mon is not None and prog.building
        if mint:
            _remat.reset_trace_stats()
        step_trace = self._cur_trace
        self._built = None
        t0 = time.perf_counter()
        try:
            loss = self._fast_call(prog, inputs)
        finally:
            if mint:
                _remat.stop_trace_stats()
        t1 = time.perf_counter()
        cost = self._built[1] if self._built is not None else None
        self._built = None
        self._report(mon, step_trace, sig, inputs, (t0, t1), "graph",
                     mint and len(self._programs), cost, prog)
        if mon is not None:
            st = prog.state
            stats = st.stats
            if stats is not None and mon.health.should_sample(self._health_n):
                # the program's first call ran its body eagerly: its
                # gradients are that run's, not the capture's buffers
                first = st.first_grads
                kept = stats._grads
                if first is not None:
                    stats._grads = first
                try:
                    extra = stats.digest_parts()
                    payload = stats.payload(st.hbuf.cpu().numpy(),
                                            st.act_names, keep=True,
                                            extra=extra)
                finally:
                    stats._grads = kept
                mon.health.on_sample(stats, self._health_n,
                                     payload["loss"], payload,
                                     named_params=self._named_params())
            st.first_grads = None
        return loss

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
        self._check_stacked(inputs)
        if self._fast_path:
            return self._monitored_fast(inputs, mon)
        sig = self._signature(inputs)
        self._eager_sigs.add(sig)
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
        self._report(mon, step_trace, sig, inputs, (t0, t1), "eager",
                     mint and len(self._mon_sigs) + 1, cost)
        if mon is not None and health is not None:
            act = taps.harvest()
            payload = health.read(loss, act)
            mon.health.on_sample(health, self._health_n, payload["loss"],
                                 payload, named_params=self._named_params())
        return loss

    def _report(self, mon, step_trace, sig, inputs, span, path, mint,
                cost=None, program=None):
        """A call's records: the dispatch span; at a mint (``mint``: the
        signature's program count, else falsy) ``recompile`` and its
        gauges, else ``step``; ``skip_update`` after an overflow; the
        health step count."""
        t0, t1 = span
        k = self._acc_steps
        if step_trace is not None:
            step_trace.record("dispatch", t0, t1, path=path, microbatches=k)
        if mon is not None:
            if mint:
                self._mon_sigs[sig] = mint
                self._mint_cost = cost     # its kernel share, for reports
                if step_trace is not None:
                    # the call above WAS the mint; link the sentinel
                    step_trace.event("recompile", count=mint, path=path)
                mon.train_step_compiled(
                    sig, self._mon_prev_sig, compile_s=None, count=mint,
                    path=path, cost=cost, span=span, program=program,
                    **self._flop_kwargs(inputs))
                if k > 1:
                    mon.accum_config(k, 4 * sum(
                        p.numel() for p in self._opt._parameter_list
                        if p.requires_grad))
                self._emit_remat_gauges(mon)
            else:
                mon.step_event(t1 - t0, microbatches=k,
                               bucket=self._mon_sigs.get(
                                   sig, self.num_compiles),
                               span=span, step_id=self._gp_id)
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
            if scale is None:
                target = loss
            elif torch.is_tensor(scale):        # the staged scale
                target = loss * scale.to(loss.dtype)
            else:
                target = loss * torch.tensor(scale, dtype=loss.dtype)
            grads = torch.autograd.grad(target, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    # --------------------------------------------------------- checkpointing

    def save_checkpoint(self, directory: str, step: int, extra=None,
                        keep: int = 3, block: bool = False,
                        coordinator=None):
        """Snapshot the model, the optimizer and the step's ``GradScaler``
        (in ``extra["grad_scaler"]``) into ``<directory>/step_<step>``
        (``distributed.checkpoint``). Asynchronous by default: the state is
        copied to host memory now, after the card has finished the steps
        already queued, then written in the background, at most one save
        in flight; a previous write's error surfaces here. ``block=True``
        writes before returning, the form for an emergency save (e.g.
        after ``PreemptionWatcher.requested()``). Keeps the newest ``keep``
        committed snapshots. ``coordinator``: None or False (the pod-wide
        commit is not ported)."""
        from ..distributed.checkpoint import AsyncCheckpointer
        ckptr = self._ckptr
        if ckptr is None or ckptr.directory != directory:
            if ckptr is not None:
                ckptr.close()
            ckptr = AsyncCheckpointer(directory, keep=keep,
                                      coordinator=coordinator)
            self._ckptr = ckptr
        ckptr.keep = keep
        ckptr.save(step, model=self._model, optimizer=self._opt,
                   grad_scaler=self._scaler, extra=extra, block=block)

    def wait_checkpoint(self):
        """Barrier for an in-flight save (surfaces its write error)."""
        if self._ckptr is not None:
            self._ckptr.wait()

    def load_checkpoint(self, directory: str, step=None):
        """Resume the model, the optimizer and the scaler from the newest
        committed snapshot (falling back past torn or corrupt ones), or
        from ``step``; returns the checkpoint's info (``{'step': N,
        **extra}``) or None when nothing is loadable. The values are copied
        into the live parameters and states in place, so whatever holds
        their storage stays valid."""
        from ..distributed.checkpoint import load_checkpoint
        self.wait_checkpoint()
        return load_checkpoint(directory, model=self._model,
                               optimizer=self._opt, step=step,
                               grad_scaler=self._scaler)

    def rollback_last_commit(self, directory: str, before_step=None):
        """Restore the newest snapshot committed strictly BEFORE
        ``before_step`` (any committed snapshot when None), leaving newer,
        possibly poisoned, snapshots on disk untouched: the health plane's
        ``rollback_hook`` target in a raw training loop::

            mon.health.rollback_hook = lambda step, info: \\
                train_step.rollback_last_commit(ckpt_dir, before_step=step)

        Returns the checkpoint's info, or None when nothing older exists.
        Restores in place, as ``load_checkpoint``."""
        from ..distributed.checkpoint import load_checkpoint
        self.wait_checkpoint()
        max_step = None if before_step is None else int(before_step) - 1
        return load_checkpoint(directory, model=self._model,
                               optimizer=self._opt, grad_scaler=self._scaler,
                               max_step=max_step)


class _FastState:
    """The buffers of one training program: the staged copy (the step
    scalars, the seeds once laid out, the inputs held on the host), the
    inputs already on the device, the loss and the scaler's flag, and the
    health plane's device half and output vector when it rides along."""

    def __init__(self, step, inputs, params, dev, mon):
        opt = step._opt
        self.params = params
        self.device = dev
        self.n_opt = len(opt.step_scalars(1))
        self.n_scal = self.n_opt + (2 if step._scaler_on else 0)
        self.seeds = SeedStage()
        self.loss = None
        self.found = torch.zeros((), dtype=torch.bool, device=dev)
        # per input: ("dev", tensor) a device buffer, ("host", i) a slot of
        # the staged copy, ("const", value) a value baked into the program
        self._where, self._host_specs = [], {}
        for i, a in enumerate(inputs):
            if not torch.is_tensor(a):
                self._where.append(("const", a))
            elif a.device == dev and dev.type != "cpu":
                self._where.append(("dev", torch.empty_like(
                    a, memory_format=torch.contiguous_format)))
            else:
                self._host_specs[f"in{i}"] = (tuple(a.shape), a.dtype)
                self._where.append(("host", f"in{i}"))
        self._layout(0)
        self.stats = None
        self.hbuf = None
        self.act_names = []
        self.first_grads = None
        if mon is not None:
            names, transposed = step._leaf_names()
            self.stats = mon.health.device_stats(names, transposed)

    def _layout(self, n_seeds: int):
        specs = {"scalars": ((self.n_scal,), torch.float32)}
        if n_seeds:
            specs["seeds"] = ((n_seeds,), torch.int64)
        specs.update(self._host_specs)
        self.staged = StagedBuffer(self.device, specs)
        self.dev = self.staged.dev
        self._dev = self.staged._dev        # memory stats: the inputs

    def lay_out_seeds(self):
        """After the first run: the seed slots it met become part of the
        staged copy (``SeedStage.layout``)."""
        n = len(self.seeds)
        if n:
            self._layout(n)
        self.seeds.layout(self.dev["seeds"] if n else
                          torch.zeros(0, dtype=torch.int64,
                                      device=self.device))

    def stage(self, inputs, opt_scalars, scale, factor):
        """Write this call's values and copy them to the device at once:
        the optimizer's step scalars, the loss scale and ``factor /
        scale`` (the unscale and the 1/K of an average in one product, as
        the eager step multiplies them), the seeds and the host inputs."""
        st = self.staged
        st.writable()
        host = st.host["scalars"]
        host[:self.n_opt] = torch.from_numpy(np.asarray(opt_scalars,
                                                        np.float32))
        if scale is not None:
            f32 = np.float32
            host[self.n_opt] = float(f32(scale))
            host[self.n_opt + 1] = float(f32(factor) / f32(scale))
        if self.seeds.laid_out and len(self.seeds):
            self.seeds.draw(st.host["seeds"].numpy())
        for a, (kind, where) in zip(inputs, self._where):
            if kind == "host":
                st.host[where].copy_(a)
            elif kind == "dev":
                where.copy_(a, non_blocking=True)
        st.upload()

    def inputs(self):
        """The inputs the body reads."""
        return [self.dev[w] if k == "host" else w for k, w in self._where]


class _Body:
    """A training program's body, holding its step weakly (a program must
    not keep its owner alive)."""

    def __init__(self, step, st):
        self._step = weakref.ref(step)
        self._st = st

    def __call__(self):
        self._step()._fast_run(self._st)

    def after_first(self):
        self._st.lay_out_seeds()
