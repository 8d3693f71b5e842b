"""Mixed precision of the port (``paddle_tpu.amp``'s counterpart):
``auto_cast`` / ``amp_guard`` (O1 and O2 casts by the reference's op
lists), ``decorate`` (O2: parameters in the low type, fp32 masters) and
``GradScaler`` / ``AmpScaler`` (dynamic loss scaling)."""
from .auto_cast import amp_guard, auto_cast, decorate
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "AmpScaler"]
