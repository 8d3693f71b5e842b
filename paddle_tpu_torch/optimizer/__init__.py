"""Optimizers and LR schedulers of the port (``paddle_tpu.optimizer``'s
counterpart): ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adamax``,
``Adagrad``, ``Adadelta``, ``RMSProp`` and ``Lamb`` (every one a staged
rule that ``TrainStep`` captures on the card), and the 15 schedulers of
``lr``."""
from . import lr
from .lr import LRScheduler
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Momentum, Optimizer, RMSProp)

__all__ = ["lr", "LRScheduler", "Optimizer", "SGD", "Momentum", "Adam",
           "AdamW", "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb"]
