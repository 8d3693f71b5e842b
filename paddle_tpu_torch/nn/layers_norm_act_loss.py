"""Normalisation, activation and loss layers (counterpart of
``paddle_tpu/nn/layers_norm_act_loss.py``). The batch-statistics norms
(``BatchNorm*``, ``SyncBatchNorm``, ``GroupNorm``, ``InstanceNorm*``,
``LocalResponseNorm``) wait for the convolution slice (ROADMAP Queue 1,
item 2's rest)."""
from __future__ import annotations

import torch

from ..core.tensor import Parameter
from ..ops._helpers import _op
from . import functional as F
from .initializer import Constant
from .layer import Layer
from . import norm as _norm  # noqa: F401  (registers rms_norm)

__all__ = [
    "LayerNorm", "RMSNorm", "ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh",
    "Softmax", "LogSoftmax", "LeakyReLU", "PReLU", "ELU", "SELU", "CELU",
    "Silu", "Swish", "Mish", "Hardswish", "Hardsigmoid", "Hardtanh",
    "Hardshrink", "Softshrink", "Tanhshrink", "Softsign", "Softplus",
    "LogSigmoid", "Maxout", "ThresholdedReLU", "GLU", "RReLU",
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "MarginRankingLoss",
    "CosineEmbeddingLoss", "HingeEmbeddingLoss", "TripletMarginLoss",
    "SoftMarginLoss", "MultiLabelSoftMarginLoss", "PoissonNLLLoss",
]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=self._normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0)) \
            if weight_attr is not False else None
        self.bias = self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    """RMSNorm over the last axis with a learned scale initialised to ones
    (the LLaMA family's norm; ``norm.rms_norm``'s rounding).

    The weight is made on the default place, as every ``Layer``'s
    parameters are (``create_parameter``). Inside an explicit ``with
    torch.device(...)`` block on another device than the CPU it is made
    there instead, as ones: the LLaMA model builds its blocks on ``meta``
    (shapes only, nothing written) and sets its weights after
    ``to_empty``."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        ctx = torch.get_default_device()
        if ctx.type == "cpu":
            self.weight = self.create_parameter(
                shape=self._normalized_shape, attr=weight_attr,
                default_initializer=Constant(1.0))
            return
        with torch.device(ctx):
            data = torch.empty(self._normalized_shape)
        if ctx.type != "meta":
            data.fill_(1.0)
        self.weight = Parameter(data)

    def forward(self, x):
        return _op("rms_norm", x, self.weight, epsilon=float(self.epsilon))

    def extra_repr(self):
        return f"{self._normalized_shape}, epsilon={self.epsilon}"


# ----------------------------------------------------------------- activations


def _layer(name, fn, params):
    """A layer whose ``__init__`` takes ``params`` ((name, default) pairs,
    in order, and ``name=``) and whose forward is ``fn(*inputs,
    *values)``: the activation layers with arguments and the loss
    layers."""
    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        kwargs.pop("name", None)
        vals = list(args) + [kwargs.pop(k, d) for k, d in params[len(args):]]
        if kwargs:
            raise TypeError(f"{name}: unexpected {sorted(kwargs)}")
        self._args = tuple(vals)

    def forward(self, *inputs):
        return fn(*inputs, *self._args)
    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


ReLU = _layer("ReLU", F.relu, [])
ReLU6 = _layer("ReLU6", F.relu6, [])
Sigmoid = _layer("Sigmoid", F.sigmoid, [])
Tanh = _layer("Tanh", F.tanh, [])
Silu = _layer("Silu", F.silu, [])
Swish = _layer("Swish", F.swish, [])
Mish = _layer("Mish", F.mish, [])
Hardswish = _layer("Hardswish", F.hardswish, [])
Hardsigmoid = _layer("Hardsigmoid", F.hardsigmoid, [])
Softsign = _layer("Softsign", F.softsign, [])
Tanhshrink = _layer("Tanhshrink", F.tanhshrink, [])
LogSigmoid = _layer("LogSigmoid", F.log_sigmoid, [])
GELU = _layer("GELU", F.gelu, [("approximate", False)])
Softmax = _layer("Softmax", F.softmax, [("axis", -1)])
LogSoftmax = _layer("LogSoftmax", F.log_softmax, [("axis", -1)])
LeakyReLU = _layer("LeakyReLU", F.leaky_relu, [("negative_slope", 0.01)])
ELU = _layer("ELU", F.elu, [("alpha", 1.0)])
SELU = _layer("SELU", F.selu, [("scale", 1.0507009873554805),
                               ("alpha", 1.6732632423543772)])
CELU = _layer("CELU", F.celu, [("alpha", 1.0)])
Hardtanh = _layer("Hardtanh", F.hardtanh, [("min", -1.0), ("max", 1.0)])
Hardshrink = _layer("Hardshrink", F.hardshrink, [("threshold", 0.5)])
Softshrink = _layer("Softshrink", F.softshrink, [("threshold", 0.5)])
Softplus = _layer("Softplus", F.softplus, [("beta", 1.0),
                                           ("threshold", 20.0)])
Maxout = _layer("Maxout", F.maxout, [("groups", 1), ("axis", 1)])
ThresholdedReLU = _layer("ThresholdedReLU", F.thresholded_relu,
                         [("threshold", 1.0)])
GLU = _layer("GLU", F.glu, [("axis", -1)])


class RReLU(Layer):
    def __init__(self, lower=1 / 8, upper=1 / 3, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


# ----------------------------------------------------------------- losses


CrossEntropyLoss = _layer("CrossEntropyLoss", F.cross_entropy, [
    ("weight", None), ("ignore_index", -100), ("reduction", "mean"),
    ("soft_label", False), ("axis", -1), ("use_softmax", True),
    ("label_smoothing", 0.0)])
MSELoss = _layer("MSELoss", F.mse_loss, [("reduction", "mean")])
L1Loss = _layer("L1Loss", F.l1_loss, [("reduction", "mean")])
NLLLoss = _layer("NLLLoss", F.nll_loss, [
    ("weight", None), ("ignore_index", -100), ("reduction", "mean")])
BCELoss = _layer("BCELoss", F.binary_cross_entropy, [
    ("weight", None), ("reduction", "mean")])
BCEWithLogitsLoss = _layer(
    "BCEWithLogitsLoss", F.binary_cross_entropy_with_logits, [
        ("weight", None), ("reduction", "mean"), ("pos_weight", None)])
KLDivLoss = _layer("KLDivLoss", F.kl_div, [("reduction", "mean")])
SmoothL1Loss = _layer("SmoothL1Loss", F.smooth_l1_loss, [
    ("reduction", "mean"), ("delta", 1.0)])
MarginRankingLoss = _layer("MarginRankingLoss", F.margin_ranking_loss, [
    ("margin", 0.0), ("reduction", "mean")])
CosineEmbeddingLoss = _layer(
    "CosineEmbeddingLoss", F.cosine_embedding_loss, [
        ("margin", 0.0), ("reduction", "mean")])
HingeEmbeddingLoss = _layer(
    "HingeEmbeddingLoss", F.hinge_embedding_loss, [
        ("margin", 1.0), ("reduction", "mean")])
TripletMarginLoss = _layer("TripletMarginLoss", F.triplet_margin_loss, [
    ("margin", 1.0), ("p", 2.0), ("epsilon", 1e-6), ("swap", False),
    ("reduction", "mean")])
SoftMarginLoss = _layer("SoftMarginLoss", F.soft_margin_loss, [
    ("reduction", "mean")])
MultiLabelSoftMarginLoss = _layer(
    "MultiLabelSoftMarginLoss", F.multi_label_soft_margin_loss, [
        ("weight", None), ("reduction", "mean")])
PoissonNLLLoss = _layer("PoissonNLLLoss", F.poisson_nll_loss, [
    ("log_input", True), ("full", False), ("epsilon", 1e-8),
    ("reduction", "mean")])
