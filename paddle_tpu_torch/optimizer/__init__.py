"""Optimizers and LR schedulers of the port (``paddle_tpu.optimizer``'s
counterpart): ``SGD``, ``Momentum``, ``Adam`` and ``AdamW`` with fp32
masters, and the 15 schedulers of ``lr``. ``Adamax``, ``Adagrad``,
``Adadelta``, ``RMSProp`` and ``Lamb`` are ROADMAP Queue 1, item 4's
rest."""
from . import lr
from .lr import LRScheduler
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["lr", "LRScheduler", "Optimizer", "SGD", "Momentum", "Adam",
           "AdamW"]
