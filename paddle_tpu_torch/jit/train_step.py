"""``TrainStep``: one call is forward, backward and update (counterpart of
``paddle_tpu/jit/train_step.py``).

The JAX package compiles the whole step into one XLA executable. Here the
step is eager PyTorch: ``model(*inputs)``, ``loss.backward()``,
``optimizer.step()``, ``optimizer.clear_grad()``, with the attention's
forward and backward in the hand-written flash kernels. Capturing the step
into a CUDA graph (the counterpart of the AOT executable) is a later PR.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["TrainStep"]


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"TrainStep: {what} is not ported yet "
                               f"(ROADMAP Queue 1, item {item})")


class TrainStep:
    """``TrainStep(model, optimizer, loss_fn=None)``; ``step(*inputs)``
    runs one training step and returns the loss, detached.

    The loss is ``loss_fn(out)`` when ``loss_fn`` is given, else ``out``
    when the model returns a tensor, else ``out[-1]`` (the ``(logits,
    loss)`` convention: ``GPTForCausalLM(ids, labels)`` returns ``(None,
    loss)``). The steps are eager; CUDA-graph capture of the step comes in
    a later PR. ``accumulate_steps > 1``, ``average_grads``,
    ``grad_scaler``, a model with recompute, and the checkpoint methods
    raise ``NotImplementedError``."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 loss_fn: Optional[Callable] = None,
                 accumulate_steps: Optional[int] = None,
                 average_grads: Optional[bool] = None, grad_scaler=None):
        if accumulate_steps is not None and int(accumulate_steps) > 1:
            raise _unported("gradient accumulation (accumulate_steps > 1)", 5)
        if average_grads is not None:
            raise _unported("average_grads", 5)
        if grad_scaler is not None:
            raise _unported("the compiled-in GradScaler", 4)
        cfg = getattr(model, "config", None)
        if getattr(cfg, "recompute_granularity", "none") != "none":
            raise _unported("activation recompute", 5)
        self._model = model
        self._opt = optimizer
        self._loss_fn = loss_fn

    def __call__(self, *inputs):
        out = self._model(*inputs)
        if self._loss_fn is not None:
            loss = self._loss_fn(out)
        elif torch.is_tensor(out):
            loss = out
        else:
            loss = out[-1]
        loss.backward()
        self._opt.step()
        self._opt.clear_grad()
        return loss.detach()

    def save_checkpoint(self, *args, **kwargs):
        raise _unported("checkpointing", 10)

    def load_checkpoint(self, *args, **kwargs):
        raise _unported("checkpointing", 10)

    def wait_checkpoint(self, *args, **kwargs):
        raise _unported("checkpointing", 10)

    def rollback_last_commit(self, *args, **kwargs):
        raise _unported("checkpointing", 10)
