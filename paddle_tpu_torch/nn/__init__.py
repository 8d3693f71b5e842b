"""``paddle.nn`` of the port: ``Layer`` (a ``torch.nn.Module`` whose
parameters are ``Parameter``s) and its containers, the common,
convolution, pooling, normalisation (the batch norms among them),
activation, loss and transformer layers, the initializers,
``functional``, and the gradient clips of ``nn.clip``. The upsampling,
fold and recurrent layers wait for later slices (ROADMAP Queue 1, item
2's rest)."""
from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (Layer, LayerDict, LayerList, ParameterList,  # noqa: F401
                    Sequential)
from .layers_common import *  # noqa: F401,F403
from .layers_common import __all__ as _common_all
from .layers_conv_pool import *  # noqa: F401,F403
from .layers_conv_pool import __all__ as _conv_all
from .layers_norm_act_loss import *  # noqa: F401,F403
from .layers_norm_act_loss import __all__ as _nal_all
from .layers_transformer import *  # noqa: F401,F403
from .layers_transformer import __all__ as _tr_all

__all__ = (["clip", "functional", "initializer", "Layer", "LayerList",
            "Sequential", "ParameterList", "LayerDict", "ClipGradByValue",
            "ClipGradByNorm", "ClipGradByGlobalNorm"]
           + list(_common_all) + list(_conv_all) + list(_nal_all)
           + list(_tr_all))
