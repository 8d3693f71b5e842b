"""paddle.callbacks parity alias (reference exposes paddle.callbacks)."""
from .hapi.callbacks import *  # noqa: F401,F403
from .hapi.callbacks import Callback, ProgBarLogger, ModelCheckpoint, EarlyStopping, LRScheduler  # noqa: F401
