"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

``Optimizer``, ``Adam`` and ``AdamW`` with Paddle's argument names. The JAX
package runs one fused update over the whole parameter pytree in a cached
XLA executable; here the update is eager PyTorch, one parameter at a time,
and in place: moments, fp32 masters and the parameters the model holds
are updated where they live (``copy_``/``sub_`` under ``no_grad``, never a
rebound ``.data``), which is the port's counterpart of the JAX package
donating those buffers to its update.

``multi_precision=True`` keeps an fp32 master for every parameter that is
not fp32, made from the parameter's own values, and fp32 moments; each
``step()`` casts the gradient to the master's type, updates the master and
copies it, cast, into the parameter.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW", "adam_update"]

_ITEM = "ROADMAP Queue 1, item 4"


def adam_update(param, grad, moment1, moment2, *, lr, step, beta1=0.9,
                beta2=0.999, epsilon=1e-8, weight_decay=0.0,
                decouple_wd=False):
    """One Adam/AdamW step on ``param``, ``moment1`` and ``moment2`` in
    place: the JAX package's ``Adam._update_rule`` (``optimizer.py:497``)
    written over tensors. Bias correction with ``step`` counted from 1 (in
    fp32, as the JAX package keeps the step), ``epsilon`` added to
    ``sqrt(m2 / bc2)``; without ``decouple_wd`` the decay is L2 on the
    gradient, with it ``lr * weight_decay * param`` is added to the step
    (AdamW)."""
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(beta1) ** f32(step))
    bc2 = float(f32(1.0) - f32(beta2) ** f32(step))
    if weight_decay and not decouple_wd:
        grad = grad + weight_decay * param
    moment1.mul_(beta1).add_(grad * (1 - beta1))
    moment2.mul_(beta2).add_(grad.square() * (1 - beta2))
    update = lr * (moment1 / bc1) / ((moment2 / bc2).sqrt() + epsilon)
    if decouple_wd and weight_decay:
        update += float(f32(lr) * f32(weight_decay)) * param
    param.sub_(update)


class Optimizer:
    """Base class: parameters, learning rate (a float or an
    ``LRScheduler``), per-parameter state and masters. Subclasses name
    their states in ``_state_names`` and implement ``_update``."""

    _state_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided (eager mode, like "
                             "reference dygraph optimizers)")
        if grad_clip is not None:
            raise NotImplementedError(f"grad_clip is not ported yet ({_ITEM})")
        if not (weight_decay is None or isinstance(weight_decay,
                                                   (int, float))):
            raise NotImplementedError(
                f"regularizer objects as weight_decay are not ported yet "
                f"({_ITEM}); pass a float")
        self._parameter_list = list(parameters)
        self._learning_rate = learning_rate
        self._multi_precision = bool(multi_precision)
        self._weight_decay = float(weight_decay or 0.0)
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

    # ------------------------------------------------------------ state

    def _ensure_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        pid = id(p)
        if pid not in self._accumulators:
            dtype = torch.float32 if self._multi_precision else p.dtype
            self._accumulators[pid] = {
                name: torch.zeros_like(p, dtype=dtype,
                                       memory_format=torch.contiguous_format)
                for name in self._state_names}
            if self._multi_precision and p.dtype != torch.float32:
                self._master_weights[pid] = p.detach().float().clone()
        return self._accumulators[pid]

    # ------------------------------------------------------------ step

    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient: the rule runs on the
        fp32 master where one exists (the gradient cast to fp32), else on
        the parameter itself; a master is then copied, cast, into the
        parameter in place."""
        params = [p for p in self._parameter_list
                  if p.requires_grad and p.grad is not None]
        if not params:
            return
        if any(p.grad.is_sparse for p in params):
            raise NotImplementedError(f"sparse gradients (the row-wise rule) "
                                      f"are not ported yet ({_ITEM})")
        self._step_count += 1
        lr = self.get_lr()
        for p in params:
            state = self._ensure_state(p)
            target = self._master_weights.get(id(p), p)
            grad = p.grad.to(target.dtype)
            self._update(target, grad, state, lr, self._step_count)
            if target is not p:
                p.copy_(target)

    def _update(self, param, grad, state, lr, step):
        raise NotImplementedError

    def clear_grad(self):
        """Drop every gradient (``p.grad = None``)."""
        for p in self._parameter_list:
            p.grad = None


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

    def _update(self, param, grad, state, lr, step):
        adam_update(param, grad, state["moment1"], state["moment2"], lr=lr,
                    step=step, beta1=self._beta1, beta2=self._beta2,
                    epsilon=self._epsilon, weight_decay=self._weight_decay,
                    decouple_wd=self._decouple_wd)


class AdamW(Adam):
    """Adam with decoupled weight decay (default coefficient 0.01), applied
    to every parameter."""

    _decouple_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 name=None, lazy_mode=False, multi_precision=False):
        if apply_decay_param_fun is not None or lr_ratio is not None:
            raise NotImplementedError(f"apply_decay_param_fun and lr_ratio "
                                      f"are not ported yet ({_ITEM})")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name, lazy_mode,
                         multi_precision)
