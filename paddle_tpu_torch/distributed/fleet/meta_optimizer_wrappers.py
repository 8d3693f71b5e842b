"""Strategy-selected optimizer wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizer_wrappers.py``): gradient
merge.

Reference analog: fleet/meta_optimizers/gradient_merge_optimizer.py /
GradientMergeConfig: accumulate K micro-steps, apply once (k_steps, avg).

Not ported: ``DGCOptimizer`` and ``LarsMomentumOptimizer`` (update rules,
ROADMAP item 4's rest) and ``LocalSGDOptimizer`` (parameter averaging
across ranks, ROADMAP item 10's rest).
"""
from __future__ import annotations

import torch

__all__ = ["GradientMergeOptimizer"]


class _Wrapper:
    def __init__(self, optimizer):
        self._inner_opt = optimizer

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)


class GradientMergeOptimizer(_Wrapper):
    """Accumulate gradients for k_steps, then apply one update (avg option).

    Eager path: the merge buffer below (sums in the gradients' own type,
    as the JAX package's does). Compiled path: ``jit.TrainStep``
    recognizes this wrapper (``_gradient_merge`` marker), unwraps it and
    takes ``k_steps`` / ``avg`` as ``accumulate_steps`` / ``average_grads``:
    every input then carries K stacked microbatches, the K gradients sum in
    fp32 and ONE update follows, as ``TrainStep(accumulate_steps=k_steps,
    average_grads=avg)`` does."""

    # adopted by jit.TrainStep while unwrapping the optimizer chain
    _gradient_merge = True

    def __init__(self, optimizer, k_steps: int = 1, avg: bool = True):
        super().__init__(optimizer)
        self.k_steps = max(int(k_steps), 1)
        self.avg = avg
        self._acc = {}
        self._count = 0

    @torch.no_grad()
    def step(self):
        opt = self._inner_opt
        self._count += 1
        for p in opt._parameter_list:
            if p.grad is None:
                continue
            pid = id(p)
            self._acc[pid] = p.grad if pid not in self._acc \
                else self._acc[pid] + p.grad
        if self._count < self.k_steps:
            for p in opt._parameter_list:
                p.grad = None      # grads consumed into the merge buffer
            return
        scale = 1.0 / self.k_steps if self.avg else 1.0
        for p in opt._parameter_list:
            pid = id(p)
            if pid in self._acc:
                p.grad = self._acc[pid] * scale
        self._acc.clear()
        self._count = 0
        opt.step()

    def clear_grad(self, set_to_zero=False):
        return self._inner_opt.clear_grad(set_to_zero=set_to_zero)
