"""Normalisation, activation and loss layers (counterpart of
``paddle_tpu/nn/layers_norm_act_loss.py``).

The batch norms hold Paddle's buffers ``_mean`` (zeros) and
``_variance`` (ones), made on the default place as the parameters are,
and update them in place in training (``F.batch_norm``: Paddle's
momentum, the unbiased running variance). ``SyncBatchNorm`` is a batch
norm in one process; across processes it would all-reduce the batch
statistics, and the port has no collective layer yet, so it raises
there (ROADMAP Queue 1, item 10) rather than normalise each process's
batch alone."""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.tensor import Parameter, Tensor
from ..ops._helpers import _op
from . import functional as F
from .initializer import Constant
from .layer import Layer
from . import norm as _norm  # noqa: F401  (registers rms_norm)

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm",
    "LayerNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "LocalResponseNorm", "RMSNorm",
    "ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh",
    "Softmax", "LogSoftmax", "LeakyReLU", "PReLU", "ELU", "SELU", "CELU",
    "Silu", "Swish", "Mish", "Hardswish", "Hardsigmoid", "Hardtanh",
    "Hardshrink", "Softshrink", "Tanhshrink", "Softsign", "Softplus",
    "LogSigmoid", "Maxout", "ThresholdedReLU", "GLU", "RReLU",
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "MarginRankingLoss",
    "CosineEmbeddingLoss", "HingeEmbeddingLoss", "TripletMarginLoss",
    "SoftMarginLoss", "MultiLabelSoftMarginLoss", "PoissonNLLLoss",
]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is not False and bias_attr is not False:
            self.weight = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter(
                shape=[num_features], attr=bias_attr, is_bias=True)
        else:
            self.weight = None
            self.bias = None
        self.register_buffer("_mean", Tensor(np.zeros(num_features,
                                                      np.float32)))
        self.register_buffer("_variance", Tensor(np.ones(num_features,
                                                         np.float32)))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    """The older ``BatchNorm(num_channels, act=None, ...)``: ``act="relu"``
    applies a ReLU after the norm."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW", **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act == "relu":
            out = F.relu(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


def _world_size() -> int:
    """Processes of the job: torch.distributed's world where it is
    initialised, else the launcher's ``PADDLE_TRAINERS_NUM``."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)


class SyncBatchNorm(_BatchNormBase):
    """Cross-process batch norm. In one process it is the batch norm (the
    JAX package's single-process regime). Training across processes, where
    every rank must normalise by the global batch's statistics, raises
    ``NotImplementedError``: the all-reduce of the statistics and of their
    gradients waits for the port's collectives (ROADMAP Queue 1, item
    10)."""

    def forward(self, x):
        use_stats = self._use_global_stats
        if use_stats is None:
            use_stats = not self.training
        if self.training and not use_stats and _world_size() > 1:
            raise NotImplementedError(
                "SyncBatchNorm across processes needs the all-reduce of the "
                "batch statistics, which the port does not have yet "
                "(ROADMAP Queue 1, item 10)")
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it replaced by a
        ``SyncBatchNorm`` holding its parameters and buffers."""
        out = layer
        if isinstance(layer, _BatchNormBase) \
                and not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon, None, None,
                                layer._data_format)
            with torch.no_grad():
                if layer.weight is not None:
                    out.weight.copy_(layer.weight)
                    out.bias.copy_(layer.bias)
                out._mean.copy_(layer._mean)
                out._variance.copy_(layer._variance)
        for name, sub in list(layer._sub_layers.items()):
            out.add_sublayer(name, cls.convert_sync_batchnorm(sub))
        return out


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


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_channels], attr=weight_attr,
            default_initializer=Constant(1.0)) \
            if weight_attr is not False else None
        self.bias = self.create_parameter(
            shape=[num_channels], attr=bias_attr, is_bias=True) \
            if bias_attr is not False else None

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    """Instance norm with a learned per-channel scale and shift; it keeps
    no running statistics (``momentum`` and ``data_format`` are taken and
    not read, as in the JAX package)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is not False and bias_attr is not False:
            self.weight = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter(
                shape=[num_features], attr=bias_attr, is_bias=True)
        else:
            self.weight = None
            self.bias = None

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


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
