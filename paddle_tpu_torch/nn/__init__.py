"""``paddle.nn`` of the port: ``Layer`` (a ``torch.nn.Module`` whose
parameters are ``Parameter``s) and its containers, the common,
convolution, pooling, normalisation (the batch norms among them),
activation, loss and transformer layers, the initializers,
``functional``, the gradient clips of ``nn.clip``, the upsampling and
fold layers, the recurrent layers (``layers_rnn``) and the extended
layers (``layers_extended``: CTC and RNN-T losses, unpooling,
``SpectralNorm``, beam-search decoding)."""
from ..core.tensor import Parameter  # noqa: F401
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
from .layers_extended import *  # noqa: F401,F403
from .layers_extended import __all__ as _ext_all
from .layers_rnn import *  # noqa: F401,F403
from .layers_rnn import __all__ as _rnn_all
from .layers_transformer import *  # noqa: F401,F403
from .layers_transformer import __all__ as _tr_all

__all__ = (["clip", "functional", "initializer", "Parameter", "Layer",
            "LayerList",
            "Sequential", "ParameterList", "LayerDict", "ClipGradByValue",
            "ClipGradByNorm", "ClipGradByGlobalNorm"]
           + list(_common_all) + list(_conv_all) + list(_nal_all)
           + list(_tr_all) + list(_rnn_all) + list(_ext_all))
