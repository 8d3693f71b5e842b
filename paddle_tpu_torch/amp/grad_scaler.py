"""``GradScaler`` with dynamic loss scaling (counterpart of
``paddle_tpu/amp/grad_scaler.py``).

Eager use: ``scaler.scale(loss).backward()``, then ``scaler.step(opt)``
(unscale the gradients in place, and update only if they are all finite)
and ``scaler.update()`` (the dynamic-scale state machine), or
``scaler.minimize(opt, scaled_loss)`` for both. ``jit.TrainStep(...,
grad_scaler=scaler)`` scales and unscales inside the step and replays the
state machine on its found-inf flag (``_compiled_outcome``). The flag
costs one host sync a step, as in the JAX package. A captured step
(``TrainStep``'s fast path) keeps the flag on the device
(``found_inf_flag``), masks the update with it and reads it once after
the replay.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler", "AmpScaler", "found_inf", "found_inf_flag"]


def found_inf_flag(grads) -> torch.Tensor:
    """A 0-d bool tensor on the gradients' device: whether any of ``grads``
    (a non-empty list) holds a value that is not finite. No host read."""
    return ~torch.stack([torch.isfinite(g).all() for g in grads]).all()


def found_inf(grads) -> bool:
    """Whether any of ``grads`` holds a value that is not finite: one
    device flag over all of them, read once."""
    return bool(grads) and bool(found_inf_flag(grads))


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=65536.0, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def scale(self, var):
        """``var`` times the current scale (``var`` when disabled)."""
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def _unscale(self, optimizer):
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        grads = []
        for p in optimizer._parameter_list:
            if p.grad is not None:
                p.grad = p.grad * inv
                grads.append(p.grad)
        self._found_inf = found_inf(grads)
        self._unscaled = True

    def unscale_(self, optimizer):
        """Divide the optimizer's gradients by the scale (once a step) and
        note whether any is not finite."""
        self._unscale(optimizer)

    def step(self, optimizer):
        """Unscale, then ``optimizer.step()`` unless a gradient is not
        finite."""
        if not self._enable:
            optimizer.step()
            return
        self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        """The dynamic-scale state machine: after ``decr_every_n_nan_or_inf``
        steps with a non-finite gradient the scale is multiplied by
        ``decr_ratio`` (at least 1), after ``incr_every_n_steps`` clean
        steps by ``incr_ratio``."""
        if not self._enable:
            return
        if self._dynamic:
            if self._found_inf:
                self._bad_steps += 1
                self._good_steps = 0
                if self._bad_steps >= self._decr_every_n:
                    self._scale = max(self._scale * self._decr_ratio, 1.0)
                    self._bad_steps = 0
            else:
                self._good_steps += 1
                self._bad_steps = 0
                if self._good_steps >= self._incr_every_n_steps:
                    self._scale *= self._incr_ratio
                    self._good_steps = 0
        # feed the health plane: the loss-scale trajectory next to the trip
        # timeline (update() is the tail of both step()+update() and the
        # TrainStep replay, so each outcome is fed once)
        from .. import monitor as _monitor
        mon = _monitor._active
        if mon is not None:
            mon.health.scaler_outcome(self._found_inf, self._scale)
        self._found_inf = False
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def _compiled_outcome(self, found: bool):
        """The host half of a ``jit.TrainStep`` with this scaler: the step
        already scaled, unscaled and, on overflow, skipped the update;
        replay the state machine on its flag, as ``step()`` + ``update()``
        would."""
        self._found_inf = bool(found)
        self._unscaled = True
        self.update()

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
