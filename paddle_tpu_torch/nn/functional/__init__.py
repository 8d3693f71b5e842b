"""Functional ops of the port (``paddle.nn.functional``): activations,
losses, the common and norm functionals, and attention. Convolution,
pooling, interpolation and the batch-statistics norms wait for the
convolution slice (ROADMAP Queue 1, item 2's rest)."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _act_all
from .attention import (flash_at_any_length, flash_attention,
                        flash_attention_qkv_packed, flash_path_available,
                        pair_layout_supported, scaled_dot_product_attention)
from .common import *  # noqa: F401,F403
from .common import __all__ as _common_all
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss_all
from .norm import add_dropout_ln, layer_norm, normalize

__all__ = (list(_act_all) + list(_loss_all) + list(_common_all)
           + ["flash_attention", "flash_attention_qkv_packed",
              "flash_path_available", "flash_at_any_length",
              "pair_layout_supported", "scaled_dot_product_attention",
              "layer_norm", "normalize", "add_dropout_ln"])
