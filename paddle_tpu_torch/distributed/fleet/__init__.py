"""``paddle.distributed.fleet`` of the port: activation recompute and the
gradient-merge optimizer wrapper."""
from .meta_optimizer_wrappers import GradientMergeOptimizer
from .recompute import recompute, recompute_sequential

__all__ = ["GradientMergeOptimizer", "recompute", "recompute_sequential"]
