"""Distributed training of the port (``paddle_tpu.distributed``'s
counterpart). Ported so far: ``fleet.recompute`` and
``fleet.recompute_sequential`` (activation recompute on one card)."""
from . import fleet

__all__ = ["fleet"]
