"""The port's first home of ``Dropout`` (the models import it from
``nn``); the layer lives in ``layers_common``."""
from .layers_common import Dropout

__all__ = ["Dropout"]
