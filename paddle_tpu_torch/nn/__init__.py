"""Neural-network pieces of the port (layers come from ``torch.nn``; the
port adds the ones torch does not have in the reference's form)."""
from . import functional
from .norm import RMSNorm

__all__ = ["functional", "RMSNorm"]
