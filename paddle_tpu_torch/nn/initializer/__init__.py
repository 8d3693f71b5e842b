"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer``)."""
from .api import (Assign, Constant, Initializer, KaimingNormal,  # noqa: F401
                  KaimingUniform, Normal, Orthogonal, TruncatedNormal,
                  Uniform, XavierNormal, XavierUniform, calculate_fan,
                  calculate_gain, set_global_initializer)

__all__ = ["Assign", "Constant", "Initializer", "KaimingNormal",
           "KaimingUniform", "Normal", "Orthogonal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "calculate_fan",
           "calculate_gain", "set_global_initializer"]
