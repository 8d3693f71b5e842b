"""Training step of the port (``paddle_tpu.jit.TrainStep``'s counterpart)."""
from .train_step import TrainStep

__all__ = ["TrainStep"]
