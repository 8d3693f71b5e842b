"""Neural-network pieces of the port (layers come from ``torch.nn``)."""
from . import functional

__all__ = ["functional"]
