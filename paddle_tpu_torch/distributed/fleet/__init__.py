"""``paddle.distributed.fleet`` of the port: activation recompute."""
from .recompute import recompute, recompute_sequential

__all__ = ["recompute", "recompute_sequential"]
