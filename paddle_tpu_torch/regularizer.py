"""Weight-decay declarations (counterpart of ``paddle_tpu/regularizer.py``).

An ``L2Decay`` handed to an optimizer as ``weight_decay`` gives its
coefficient to the decay the update rule applies. ``L1Decay`` is a
callable penalty gradient for manual use: an optimizer handed one raises
``NotImplementedError``, as the JAX package's does."""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self) -> float:
        return self._coeff

    def __call__(self, param):
        """The penalty's gradient with respect to ``param``."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """penalty = coeff * sum(|param|): gradient ``coeff * sign(param)``."""

    def __call__(self, param):
        return torch.sign(param) * self._coeff


class L2Decay(WeightDecayRegularizer):
    """penalty = coeff * 0.5 * sum(param^2): gradient ``coeff * param``."""

    def __call__(self, param):
        return param * self._coeff
