"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

``Optimizer`` and the rules ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
``Adamax``, ``Adagrad``, ``Adadelta``, ``RMSProp`` and ``Lamb`` with
Paddle's argument names and the JAX rules' arithmetic and state names. The JAX
package runs one fused update over the whole parameter pytree in a cached
XLA executable; here the update is eager PyTorch, one parameter at a time,
and in place: moments, fp32 masters and the parameters the model holds
are updated where they live (``copy_``/``sub_`` under ``no_grad``, never a
rebound ``.data``), which is the port's counterpart of the JAX package
donating those buffers to its update.

``multi_precision=True`` keeps an fp32 master for every parameter that is
not fp32, made from the parameter's own values, and fp32 moments; each
``step()`` casts the gradient to the master's type, updates the master and
copies it, cast, into the parameter. A bf16 or fp16 parameter gets its
master and fp32 moments whether ``multi_precision`` is asked or not, under
every rule: the JAX rules never round an update into such a parameter.
Without a master they compute in fp32 (the rate is an fp32 scalar) and
store the fp32 result, so the parameter turns fp32 in its first step and
its moments in the second (ROADMAP Queue 3). The port keeps those fp32
values in the master and the parameter in its own type, which the model's
kernels were built for.

``grad_clip`` (``nn.clip``) runs in ``step()`` before the update, on the
gradients as they stand; the cast to the master's type comes after it.

``state_dict()`` / ``set_state_dict()`` carry the moments, the fp32
masters, the scheduler's state and the step count under the JAX
package's keys (a checkpoint's ``optimizer.pt``).
``weight_decay`` is a float or an ``L2Decay`` (its coefficient); an
``L1Decay`` raises ``NotImplementedError``, as in the JAX package.

Every rule multiplies its rate by the parameter's
``optimize_attr["learning_rate"]`` (``ParamAttr(learning_rate=...)``),
rounded as the JAX rule rounds ``lr * s``: in fp32, then the product.
The scale is a constant of the parameter, so a captured step bakes it in.
Every rule is staged (``_update_staged``): its step scalars are host
floats or a captured step's device data alike, so ``TrainStep`` captures
each of them on the card.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from ..core.amp_state import applied
from ..regularizer import L1Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "adam_update",
           "adam_scalars"]

_ITEM = "ROADMAP Queue 1, item 4"
# the types that always update through an fp32 master
_LOW = (torch.bfloat16, torch.float16)


def _smul(x: torch.Tensor, s):
    """``x * s`` for a host float or a 0-d fp32 tensor ``s``, rounded as the
    host-float product rounds: in fp32, then to x's type (a 0-d fp32
    tensor beside a bf16 ``x`` would otherwise be cast to bf16 first)."""
    if torch.is_tensor(s) and x.dtype != s.dtype:
        return (x.float() * s).to(x.dtype)
    return x * s


def _sprod(a, b):
    """``a * b`` of two step scalars, each a host float or a 0-d fp32
    tensor, rounded in fp32 either way (the same bits)."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        return a * b
    return float(np.float32(a) * np.float32(b))


def _lr_scale(p) -> float:
    """The parameter's learning-rate multiplier
    (``ParamAttr(learning_rate=...)``; 1 where it has none)."""
    attr = getattr(p, "optimize_attr", None)
    return float(attr.get("learning_rate", 1.0)) if attr else 1.0


def _commit(param, new_param, state, new_state, skip):
    """Write a rule's new parameter and states in place; where ``skip``
    (a 0-d bool tensor) is true every one keeps its bits."""
    pairs = [(param, new_param)] + [(state[k], v) for k, v in
                                    new_state.items()]
    for old, new in pairs:
        if skip is None:
            old.copy_(new)
        else:
            old.copy_(torch.where(skip, old, new.to(old.dtype)))


def adam_scalars(lr, step, beta1=0.9, beta2=0.999) -> np.ndarray:
    """The step scalars of Adam's rule, fp32 ``[lr, 1 / bc1, 1 / bc2]``:
    the bias corrections with ``step`` counted from 1 (in fp32, as the JAX
    package keeps the step) and their reciprocals. Dividing a tensor by a
    host float on the card multiplies it by the fp32 reciprocal, so the
    rule multiplies by these on both devices and the host-float form and
    the staged form (the same values as device data) are one arithmetic."""
    f32 = np.float32
    bc1 = f32(1.0) - f32(beta1) ** f32(step)
    bc2 = f32(1.0) - f32(beta2) ** f32(step)
    return np.array([lr, f32(1.0) / bc1, f32(1.0) / bc2], dtype=np.float32)


def adam_update(param, grad, moment1, moment2, *, lr=None, step=None,
                beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.0,
                decouple_wd=False, scalars=None, skip=None):
    """One Adam/AdamW step on ``param``, ``moment1`` and ``moment2`` in
    place: the JAX package's ``Adam._update_rule`` (``optimizer.py:497``)
    written over tensors. Bias correction with ``step`` counted from 1,
    ``epsilon`` added to ``sqrt(m2 / bc2)``; without ``decouple_wd`` the
    decay is L2 on the gradient, with it ``lr * weight_decay * param`` is
    added to the step (AdamW).

    ``scalars`` replaces ``lr`` and ``step``: ``(lr, 1 / bc1, 1 / bc2,
    lr * weight_decay)`` as host floats or as 0-d fp32 tensors on the
    param's device (a captured step's staged scalars); both forms give
    the bits of ``lr=``, ``step=``. ``skip`` (a 0-d bool tensor) masks the
    update: where it is true ``param`` and the moments keep their values
    bit for bit (a scaler's overflow, decided on the device)."""
    if scalars is None:
        lr_, inv1, inv2 = (float(v) for v in adam_scalars(lr, step, beta1,
                                                           beta2))
        f32 = np.float32
        scalars = (lr_, inv1, inv2, float(f32(lr) * f32(weight_decay)))
    lr, inv1, inv2, lr_wd = scalars
    if weight_decay and not decouple_wd:
        grad = grad + weight_decay * param
    if skip is None:
        m1 = moment1.mul_(beta1).add_(grad * (1 - beta1))
        m2 = moment2.mul_(beta2).add_(grad.square() * (1 - beta2))
    else:
        m1 = (moment1 * beta1).add_(grad * (1 - beta1))
        m2 = (moment2 * beta2).add_(grad.square() * (1 - beta2))
    update = _smul(_smul(m1, inv1), lr) / (_smul(m2, inv2).sqrt() + epsilon)
    if decouple_wd and weight_decay:
        update += _smul(param, lr_wd)
    if skip is None:
        param.sub_(update)
        return
    param.copy_(torch.where(skip, param, param - update))
    moment1.copy_(torch.where(skip, moment1, m1))
    moment2.copy_(torch.where(skip, moment2, m2))


class Optimizer:
    """Base class: parameters, learning rate (a float or an
    ``LRScheduler``), per-parameter state and masters. Subclasses name
    their states in ``_state_names`` and implement ``_update_staged``
    (and ``_host_scalars`` where the rate is not their only step
    scalar)."""

    _state_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided (eager mode, like "
                             "reference dygraph optimizers)")
        if isinstance(weight_decay, L1Decay):
            raise NotImplementedError(
                "optimizers apply L2 weight decay; add an L1 penalty to the "
                "loss (or regularizer(param) to the gradients) by hand")
        if weight_decay is None or isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay or 0.0)
        else:                            # an L2Decay-style object
            self._weight_decay = float(getattr(
                weight_decay, "_coeff", getattr(weight_decay, "coeff", 0.0)))
        self._parameter_list = list(parameters)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._step_count = 0

    # ------------------------------------------------------------ lr

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        """A float sets the rate (refused while a scheduler drives it); an
        ``LRScheduler`` takes over the rate."""
        if isinstance(value, LRScheduler):
            self._learning_rate = value
            return
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler):
        """Let ``scheduler`` drive the rate from now on."""
        self._learning_rate = scheduler

    # ------------------------------------------------------------ state

    def _ensure_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        pid = id(p)
        if pid not in self._accumulators:
            master = self._multi_precision or p.dtype in _LOW
            dtype = torch.float32 if master else p.dtype
            self._accumulators[pid] = {
                name: torch.zeros_like(p, dtype=dtype,
                                       memory_format=torch.contiguous_format)
                for name in self._state_names}
            if master and p.dtype != torch.float32:
                self._master_weights[pid] = p.detach().float().clone()
        return self._accumulators[pid]

    # ------------------------------------------------------------ step

    def _wd_scale(self, p) -> float:
        """The per-parameter weight-decay multiplier (AdamW's
        ``apply_decay_param_fun``)."""
        return 1.0

    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient (``apply_gradients``
        on ``p.grad``)."""
        params = [p for p in self._parameter_list
                  if p.requires_grad and p.grad is not None]
        if not params:
            return
        if any(p.grad.is_sparse for p in params):
            raise NotImplementedError(f"sparse gradients (the row-wise rule) "
                                      f"are not ported yet ({_ITEM})")
        self.apply_gradients(params, [p.grad for p in params])

    @torch.no_grad()
    def apply_gradients(self, params, grads, staged=None, skip=None):
        """One update of ``params`` from ``grads`` (a list each, in order):
        the clip on the gradients as given, then the rule on the fp32
        master where one exists (the gradient cast to its type), else on
        the parameter itself; a master is then copied, cast, into the
        parameter in place. ``step()`` runs it on ``p.grad``;
        ``jit.TrainStep`` on its accumulated fp32 gradients. It runs
        uncast under ``auto_cast``: O2 would otherwise round the fp32
        masters' arithmetic to the low type.

        ``staged`` (a captured step's): the step scalars as a 1-d fp32
        tensor on the parameters' device, ``step_scalars``'s values for the
        step the caller has counted; the step count is then the caller's
        to advance. ``skip`` (a 0-d bool tensor) masks the update: where
        it is true parameters, masters and moments keep their bits."""
        with applied(None):
            self._apply(params, grads, staged, skip)

    def step_scalars(self, step: int) -> np.ndarray:
        """The update's step scalars for step ``step`` (fp32, host): what
        a captured step stages before each call (``[lr]``, or Adam's
        ``adam_scalars``)."""
        return self._host_scalars(self.get_lr(), step)

    def _apply(self, params, grads, staged=None, skip=None):
        if self._grad_clip is not None:
            grads = [g for _, g in self._grad_clip(list(zip(params, grads)))]
        if staged is None:
            self._step_count += 1
            base = [float(v) for v in self.step_scalars(self._step_count)]
        else:
            base = [staged[i] for i in range(len(staged))]
        by_key = {}     # (lr * s, lr * s * decay), once per (s, decay)
        for p, g in zip(params, grads):
            state = self._ensure_state(p)
            target = self._master_weights.get(id(p), p)
            wd = self._weight_decay * self._wd_scale(p)
            s = _lr_scale(p)
            if (s, wd) not in by_key:
                lr = base[0] if s == 1.0 else _sprod(base[0], s)
                by_key[s, wd] = (lr, _sprod(lr, wd))
            lr, lr_wd = by_key[s, wd]
            self._update_staged(target, g.to(target.dtype), state,
                                (lr, *base[1:], lr_wd), wd, skip)
            self._to_param(p, target, skip)

    @staticmethod
    def _to_param(p, target, skip):
        if target is p:
            return
        if skip is None:
            p.copy_(target)
        else:
            p.copy_(torch.where(skip, p, target.to(p.dtype)))

    def _host_scalars(self, lr, step) -> np.ndarray:
        return np.array([lr], dtype=np.float32)

    def _update_staged(self, param, grad, state, scalars, weight_decay,
                       skip=None):
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False):
        """Drop every gradient (``p.grad = None``), or zero it in place
        with ``set_to_zero``."""
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                with torch.no_grad():
                    p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()``; returns ``(None, None)`` as
        the JAX package's does."""
        loss.backward()
        self.step()
        return None, None

    # ------------------------------------------------------------ checkpoint

    def _param_keys(self) -> List[str]:
        """Checkpoint keys of ``_parameter_list``, the JAX package's rule: a
        parameter's name, else ``param_{i}`` (its index in the list), with
        an ``__<index>`` disambiguator on every name that repeats (a
        colliding key would cross-wire moments between parameters on
        restore). A ``torch.nn.Parameter``'s ``name`` slot is read-only, so
        the name is ``p.param_name`` where the caller set one (as AdamW's
        ``apply_decay_param_fun`` reads it); the port's models set none, so
        their keys are ``param_{i}``, as the JAX package's unnamed
        parameters' are."""
        names = [getattr(p, "param_name", "") or f"param_{i}"
                 for i, p in enumerate(self._parameter_list)]
        counts = Counter(names)
        return [f"{n}__{i}" if counts[n] > 1 else n
                for i, n in enumerate(names)]

    def state_dict(self) -> dict:
        """The optimizer's state BY REFERENCE, under the JAX package's keys:
        ``{key}_{state}`` for each moment (``moment1``, ``moment2``),
        ``master_weights`` ``{key: fp32 master}``, ``LR_Scheduler`` (the
        scheduler's ``state_dict``, empty for a fixed rate) and
        ``_step_count``. The tensors are the live ones, which the next
        ``step()`` updates in place: copy them (``AsyncCheckpointer`` does,
        at ``save()``) to keep this step's values."""
        out = {"master_weights": {}, "LR_Scheduler": {}}
        for p, key in zip(self._parameter_list, self._param_keys()):
            pid = id(p)
            for name, t in self._accumulators.get(pid, {}).items():
                out[f"{key}_{name}"] = t
            if pid in self._master_weights:
                out["master_weights"][key] = self._master_weights[pid]
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        out["_step_count"] = self._step_count
        return out

    @torch.no_grad()
    def set_state_dict(self, state: dict):
        """Restore a ``state_dict()`` (tensors anywhere; numpy arrays too):
        each saved moment and master is copied into the live state of its
        parameter in place (created first where the optimizer has not
        stepped yet), so the live tensors keep their storage; then the
        scheduler's state and the step count. A saved tensor of another
        shape than its parameter's state raises ``ValueError``."""
        masters = state.get("master_weights", {})
        for p, key in zip(self._parameter_list, self._param_keys()):
            saved = {name: state[f"{key}_{name}"] for name in self._state_names
                     if f"{key}_{name}" in state}
            if not saved and key not in masters:
                continue
            live = dict(self._ensure_state(p))
            if key in masters and id(p) in self._master_weights:
                live["master_weights"] = self._master_weights[id(p)]
                saved["master_weights"] = masters[key]
            for name, v in saved.items():
                v = torch.as_tensor(v)
                want = tuple(live[name].shape) if name in live else None
                if tuple(v.shape) != want:
                    raise ValueError(
                        f"set_state_dict: {key}'s {name} is "
                        f"{tuple(v.shape)} in the state but the parameter's "
                        f"is {want}")
                live[name].copy_(v)
        if isinstance(self._learning_rate, LRScheduler) \
                and state.get("LR_Scheduler"):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        self._step_count = int(state.get("_step_count", 0))


class SGD(Optimizer):
    """``p -= lr * (g + weight_decay * p)`` (L2 decay on the gradient).
    ``TrainStep(fast_path=True)`` captures it on the card
    (``_update_staged``: lr is its only step scalar)."""

    _state_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update_staged(self, param, grad, state, scalars, weight_decay,
                       skip=None):
        g = grad + weight_decay * param if weight_decay else grad
        if skip is None:
            param.sub_(_smul(g, scalars[0]))
            return
        param.copy_(torch.where(skip, param, param - _smul(g, scalars[0])))


class Momentum(Optimizer):
    """Heavy-ball momentum: ``v = momentum * v + g`` (``g`` with L2 decay),
    ``p -= lr * v``, or ``p -= lr * (g + momentum * v)`` with
    ``use_nesterov``. ``TrainStep(fast_path=True)`` captures it on the
    card (``_update_staged``)."""

    _state_names = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)

    def _update_staged(self, param, grad, state, scalars, weight_decay,
                       skip=None):
        lr = scalars[0]
        g = grad + weight_decay * param if weight_decay else grad
        v = state["velocity"]
        # in place unless a skip must keep the old bits
        v_new = v.mul_(self._momentum).add_(g) if skip is None \
            else (v * self._momentum).add_(g)
        upd = g + self._momentum * v_new if self._use_nesterov else v_new
        if skip is None:
            param.sub_(_smul(upd, lr))
            return
        param.copy_(torch.where(skip, param, param - _smul(upd, lr)))
        v.copy_(torch.where(skip, v, v_new))


class Adam(Optimizer):
    """Adam; ``weight_decay`` is L2 on the gradient (Paddle's Adam)."""

    _state_names = ["moment1", "moment2"]
    _decouple_wd = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, lazy_mode=False,
                 multi_precision=False, use_multi_tensor=False):
        if lazy_mode:
            raise NotImplementedError(f"lazy_mode (the sparse row-wise rule) "
                                      f"is not ported yet ({_ITEM})")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)


    def _host_scalars(self, lr, step) -> np.ndarray:
        return adam_scalars(lr, step, self._beta1, self._beta2)

    def _update_staged(self, param, grad, state, scalars, weight_decay,
                       skip=None):
        adam_update(param, grad, state["moment1"], state["moment2"],
                    beta1=self._beta1, beta2=self._beta2,
                    epsilon=self._epsilon, weight_decay=weight_decay,
                    decouple_wd=self._decouple_wd, scalars=scalars,
                    skip=skip)


class AdamW(Adam):
    """Adam with decoupled weight decay (default coefficient 0.01).

    ``apply_decay_param_fun(name)`` returning False exempts a parameter
    from the decay. It is called with the parameter's name, ``""`` where
    none was set, as in the JAX package, whose Parameter's name is ``""``
    unless a ``ParamAttr`` names it. A ``torch.nn.Parameter``'s ``name``
    slot is read-only, so the port reads the name from ``p.param_name``,
    which the caller sets (``p.param_name = "..."``). ``lr_ratio`` is
    taken and never read, as in the JAX package (a fault of the reference:
    ROADMAP Queue 3)."""

    _decouple_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 name=None, lazy_mode=False, multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name, lazy_mode,
                         multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _wd_scale(self, p) -> float:
        name = getattr(p, "param_name", "")
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(name)):
            return 0.0
        return 1.0


class Adamax(Optimizer):
    """Adam with the infinity norm: ``m = beta1 m + (1 - beta1) g``,
    ``u = max(beta2 u, |g|)``, ``p -= lr / bc1 * m / (u + epsilon)``
    (``g`` with L2 decay; ``bc1`` the first moment's bias correction,
    staged as its fp32 reciprocal as Adam's is)."""

    _state_names = ["moment", "inf_norm"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _host_scalars(self, lr, step) -> np.ndarray:
        return adam_scalars(lr, step, self._beta1, self._beta2)[:2]

    def _update_staged(self, param, grad, state, scalars, weight_decay,
                       skip=None):
        lr, inv1 = scalars[0], scalars[1]
        g = grad + weight_decay * param if weight_decay else grad
        m = state["moment"] * self._beta1 + g * (1 - self._beta1)
        u = torch.maximum(state["inf_norm"] * self._beta2, g.abs())
        new = param - _smul(m, _sprod(lr, inv1)) / (u + self._epsilon)
        _commit(param, new, state, {"moment": m, "inf_norm": u}, skip)


class Adagrad(Optimizer):
    """``m += g^2``, ``p -= lr * g / (sqrt(m) + epsilon)`` (``g`` with L2
    decay); ``m`` starts at ``initial_accumulator_value``."""

    _state_names = ["moment"]

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = float(epsilon)
        self._init_acc = float(initial_accumulator_value)

    def _ensure_state(self, p):
        fresh = id(p) not in self._accumulators
        state = super()._ensure_state(p)
        if fresh and self._init_acc:
            state["moment"].fill_(self._init_acc)
        return state

    def _update_staged(self, param, grad, state, scalars, weight_decay,
                       skip=None):
        g = grad + weight_decay * param if weight_decay else grad
        m = state["moment"] + g.square()
        new = param - _smul(g, scalars[0]) / (m.sqrt() + self._epsilon)
        _commit(param, new, state, {"moment": m}, skip)


class Adadelta(Optimizer):
    """``E[g^2] = rho E[g^2] + (1 - rho) g^2``, ``d = g * sqrt(E[d^2] +
    epsilon) / sqrt(E[g^2] + epsilon)``, ``E[d^2] = rho E[d^2] + (1 - rho)
    d^2``, ``p -= lr * d`` (``g`` with L2 decay)."""

    _state_names = ["avg_squared_grad", "avg_squared_update"]

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = float(epsilon), float(rho)

    def _update_staged(self, param, grad, state, scalars, weight_decay,
                       skip=None):
        rho, eps = self._rho, self._epsilon
        g = grad + weight_decay * param if weight_decay else grad
        asg = state["avg_squared_grad"] * rho + g.square() * (1 - rho)
        upd = g * (state["avg_squared_update"] + eps).sqrt() \
            / (asg + eps).sqrt()
        asu = state["avg_squared_update"] * rho + upd.square() * (1 - rho)
        _commit(param, param - _smul(upd, scalars[0]), state,
                {"avg_squared_grad": asg, "avg_squared_update": asu}, skip)


class RMSProp(Optimizer):
    """``E[g^2] = rho E[g^2] + (1 - rho) g^2``; ``centered`` also keeps
    ``E[g]`` and divides by ``sqrt(E[g^2] - E[g]^2 + epsilon)``, else by
    ``sqrt(E[g^2] + epsilon)`` (``mean_grad`` then stays as it is);
    ``acc = momentum * acc + lr * g / denom``, ``p -= acc`` (``g`` with
    L2 decay)."""

    _state_names = ["mean_square", "mean_grad", "momentum_acc"]

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = float(rho), float(epsilon)
        self._momentum, self._centered = float(momentum), bool(centered)

    def _update_staged(self, param, grad, state, scalars, weight_decay,
                       skip=None):
        rho, eps = self._rho, self._epsilon
        g = grad + weight_decay * param if weight_decay else grad
        ms = state["mean_square"] * rho + g.square() * (1 - rho)
        new_state = {"mean_square": ms}
        if self._centered:
            mg = state["mean_grad"] * rho + g * (1 - rho)
            denom = (ms - mg.square() + eps).sqrt()
            new_state["mean_grad"] = mg
        else:
            denom = (ms + eps).sqrt()
        acc = state["momentum_acc"] * self._momentum \
            + _smul(g, scalars[0]) / denom
        new_state["momentum_acc"] = acc
        _commit(param, param - acc, state, new_state, skip)


class Lamb(Optimizer):
    """LAMB (You et al., 2019): Adam's bias-corrected direction ``r =
    m1_hat / (sqrt(m2_hat) + epsilon) + lamb_weight_decay * p`` scaled by
    the trust ratio ``||p|| / ||r||`` (1 where either norm is 0):
    ``p -= lr * trust * r``. The ratio is computed on the device (two
    norms and a ``torch.where``, no host read), so the step captures.
    ``exclude_from_weight_decay_fn(p)`` returning True exempts a
    parameter from the decay; it is called with the parameter, as in the
    JAX package. It takes no ``multi_precision``, as the JAX rule takes
    none; a bf16 or fp16 parameter updates through its fp32 master all the
    same (see the module's docstring)."""

    _state_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _wd_scale(self, p) -> float:
        if self._exclude_fn is not None and self._exclude_fn(p):
            return 0.0
        return 1.0

    def _host_scalars(self, lr, step) -> np.ndarray:
        return adam_scalars(lr, step, self._beta1, self._beta2)

    def _update_staged(self, param, grad, state, scalars, weight_decay,
                       skip=None):
        lr, inv1, inv2 = scalars[0], scalars[1], scalars[2]
        b1, b2 = self._beta1, self._beta2
        m1 = state["moment1"] * b1 + grad * (1 - b1)
        m2 = state["moment2"] * b2 + grad.square() * (1 - b2)
        r = _smul(m1, inv1) / (_smul(m2, inv2).sqrt() + self._epsilon)
        if weight_decay:
            r = r + weight_decay * param
        w_norm = param.square().sum().sqrt()
        r_norm = r.square().sum().sqrt()
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        new = param - _sprod(lr, trust) * r
        _commit(param, new, state, {"moment1": m1, "moment2": m2}, skip)
