"""Host-side utilities of the port: ``retry`` (bounded retry with
exponential backoff and jitter, which the checkpoint writer uses)."""
from .retry import RetryPolicy, backoff_delay

__all__ = ["RetryPolicy", "backoff_delay"]
