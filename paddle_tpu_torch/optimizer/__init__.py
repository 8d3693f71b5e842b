"""Optimizers and LR schedulers of the port (``paddle_tpu.optimizer``'s
counterpart): ``Adam`` and ``AdamW`` with fp32 masters, and the 15
schedulers of ``lr``."""
from . import lr
from .lr import LRScheduler
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["lr", "LRScheduler", "Optimizer", "Adam", "AdamW"]
