"""Neural-network pieces of the port (layers come from ``torch.nn``; the
port adds the ones torch does not have in the reference's form, and the
gradient clips of ``nn.clip``)."""
from . import clip, functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .common import Dropout
from .norm import RMSNorm

__all__ = ["clip", "functional", "Dropout", "RMSNorm", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm"]
