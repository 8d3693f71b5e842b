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

Capturing the step into a CUDA graph (the counterpart of the AOT
executable) needs the kernels to read their dropout seed from device
memory first (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..amp.grad_scaler import found_inf
from ..core.amp_state import applied

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

    def _loss(self, inputs):
        out = self._model(*inputs)
        if self._loss_fn is not None:
            return self._loss_fn(out)
        return out if torch.is_tensor(out) else out[-1]

    def __call__(self, *inputs):
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
            if not found:
                self._opt.apply_gradients(params, grads)
        if self._scaler_on:
            self._scaler._compiled_outcome(found)
        return loss.detach()

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
