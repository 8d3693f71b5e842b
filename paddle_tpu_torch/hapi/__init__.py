"""hapi — high-level Model API (counterpart of ``paddle_tpu/hapi``;
reference python/paddle/hapi)."""
from .model import Model  # noqa: F401
from . import callbacks  # noqa: F401
from .async_metrics import AsyncScalar, MetricDrain  # noqa: F401
