"""Convolution and pooling layers (counterpart of
``paddle_tpu/nn/layers_conv_pool.py``): ``Conv{1,2,3}D``,
``Conv{1,2,3}DTranspose`` and the max, average and adaptive pools over
``functional.conv`` and ``functional.pooling``.

A convolution's weight is ``[out, in/groups, *k]`` (a transposed one's
``[in, out/groups, *k]``) drawn by the global weight initializer
(``XavierUniform`` unless set), its bias from ``U(-1/sqrt(fan_in),
1/sqrt(fan_in))``, both on the default place (``create_parameter``).
``padding_mode`` is taken and not read, as in the JAX package (every pad
is zeros); so are ``data_format``, ``exclusive`` and ``return_mask`` of
the pool layers, whose forwards pass only the window, the stride, the
pad and ``ceil_mode``.
"""
from __future__ import annotations

import math

from . import functional as F
from .initializer import Uniform
from .layer import Layer

__all__ = [
    "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
    "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
    "AvgPool2D", "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D",
]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(v) if len(v) == n else tuple(v) * n
    return (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n_spatial,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", transpose=False, output_padding=0):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, n_spatial)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._n_spatial = n_spatial
        self._transpose = transpose
        self._output_padding = output_padding
        if transpose:
            wshape = [in_channels, out_channels // groups, *self._kernel_size]
        else:
            wshape = [out_channels, in_channels // groups, *self._kernel_size]
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(shape=wshape, attr=weight_attr)
        if bias_attr is not False:
            self.bias = self.create_parameter(
                shape=[out_channels], attr=bias_attr, is_bias=True,
                default_initializer=Uniform(-bound, bound)
                if bias_attr is None else None)
        else:
            self.bias = None

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class _Pool(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.kw = kw

    def forward(self, x):
        return self._fn(x, self.kernel_size, self.stride, self.padding,
                        ceil_mode=self.ceil_mode)


class MaxPool1D(_Pool):
    _fn = staticmethod(F.max_pool1d)


class MaxPool2D(_Pool):
    _fn = staticmethod(F.max_pool2d)


class MaxPool3D(_Pool):
    _fn = staticmethod(F.max_pool3d)


class AvgPool1D(_Pool):
    _fn = staticmethod(F.avg_pool1d)


class AvgPool2D(_Pool):
    _fn = staticmethod(F.avg_pool2d)


class AvgPool3D(_Pool):
    _fn = staticmethod(F.avg_pool3d)


class _AdaptivePool(Layer):
    def __init__(self, output_size, **kw):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return self._fn(x, self.output_size)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool1d)


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool2d)


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_avg_pool3d)


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool1d)


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = staticmethod(F.adaptive_max_pool3d)
