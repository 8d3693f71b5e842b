"""Functional ops of the port (``paddle.nn.functional``): activations,
losses, the common and norm functionals (the batch, instance and group
norms and LRN among them, interpolation, ``unfold`` and ``fold``),
convolution, pooling, attention and the extended functionals
(``extended``: CTC and RNN-T, grid sampling, unpooling, margin losses,
beam-search utilities)."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _act_all
from .attention import (flash_at_any_length, flash_attention,
                        flash_attention_qkv_packed, flash_path_available,
                        pair_layout_supported, scaled_dot_product_attention)
from .common import *  # noqa: F401,F403
from .common import __all__ as _common_all
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv_all
from .extended import *  # noqa: F401,F403
from .extended import __all__ as _ext_all
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss_all
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm_all
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pool_all

__all__ = (list(_act_all) + list(_loss_all) + list(_common_all)
           + list(_conv_all) + list(_pool_all) + list(_norm_all)
           + list(_ext_all)
           + ["flash_attention", "flash_attention_qkv_packed",
              "flash_path_available", "flash_at_any_length",
              "pair_layout_supported", "scaled_dot_product_attention"])
