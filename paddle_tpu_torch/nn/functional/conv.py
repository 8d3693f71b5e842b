"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``).

The JAX package lowers every convolution to ``lax.conv_general_dilated``
(an XLA op, no Pallas kernel); here each is torch's ``conv{1,2,3}d`` or
``conv_transpose{1,2,3}d``, which cuDNN runs on the card. The weight
layout is Paddle's, which is torch's too: ``[out, in/groups, *k]`` for a
convolution, ``[in, out/groups, *k]`` for a transposed one. What lax
decides and torch does not take is computed here:

* ``"SAME"`` pads as lax pads at any stride (``ceil(in / stride)``
  outputs, the odd pad on the high side: torch's ``padding="same"``
  refuses a stride above 1), ``"VALID"`` pads nothing, and a 2n-long list
  pads each side as given. A pad torch cannot take (one side unlike the
  other) is an explicit zero pad of the input.
* ``data_format`` ``NLC`` / ``NHWC`` / ``NDHWC``: the input is viewed
  channel-first (a permute, which torch reads as channels-last memory)
  and the output viewed back.
* A transposed convolution has lax's output at any ``output_padding``:
  ``(in - 1) * stride - pad_lo - pad_hi + dilation * (k - 1) + 1 +
  output_padding``, the ``output_padding`` rows computed (they are part
  of the stencil). Where torch's ``padding`` / ``output_padding`` can
  express it they are used; else the full transposed convolution is
  cropped or zero-extended to lax's window. A string padding adds
  ``output_padding`` as zero rows after it, as the JAX package does.
  ``output_size`` is taken and not read, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import register_op
from ...ops._helpers import _op, static_int_list

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}
_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC")


def _norm_tuple(v, n):
    t = static_int_list(v)
    return tuple(t * n if len(t) == 1 else t)


def _norm_padding(padding, n):
    """An int, n ints, 2n ints (low, high per axis) or "SAME" / "VALID"
    -> ``((lo, hi), ...)`` or the upper-cased string."""
    if isinstance(padding, str):
        return padding.upper()
    t = static_int_list(padding)
    if len(t) == 1:
        t = t * n
    if len(t) == n:
        return tuple((p, p) for p in t)
    if len(t) == 2 * n:
        return tuple((t[2 * i], t[2 * i + 1]) for i in range(n))
    raise ValueError(f"bad padding {padding}")


def _string_pads(padding, sizes, kernel, strides, dilations):
    """lax's pads for "SAME" (``ceil(in / s)`` outputs, the odd pad high)
    or "VALID" (none)."""
    if padding == "VALID":
        return ((0, 0),) * len(sizes)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    pads = []
    for n, k, s, d in zip(sizes, kernel, strides, dilations):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _pad_arg(pads):
    """``((lo, hi), ...)`` per spatial axis -> ``TF.pad``'s list (the last
    axis first); a negative entry crops."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _bias_view(b, ndim):
    return b.reshape([1, -1] + [1] * (ndim - 2))


def _conv_fwd(x, w, *rest, strides=(), padding="VALID", dilations=(),
              groups=1, n_spatial=2, channel_last=False, has_bias=False):
    xc = x.movedim(-1, 1) if channel_last else x
    if isinstance(padding, str):
        padding = _string_pads(padding, xc.shape[2:], w.shape[2:], strides,
                               dilations)
    bias = rest[0] if has_bias else None
    conv = _CONV[n_spatial]
    if all(lo == hi >= 0 for lo, hi in padding):
        out = conv(xc, w, bias, strides, [lo for lo, _ in padding],
                   dilations, groups)
    else:
        out = conv(TF.pad(xc, _pad_arg(padding)), w, bias, strides, 0,
                   dilations, groups)
    return out.movedim(1, -1) if channel_last else out


register_op("conv", _conv_fwd)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n_spatial,
             data_format):
    args = [x, weight] + ([bias] if bias is not None else [])
    return _op("conv", *args, strides=_norm_tuple(stride, n_spatial),
               padding=_norm_padding(padding, n_spatial),
               dilations=_norm_tuple(dilation, n_spatial),
               groups=int(groups), n_spatial=n_spatial,
               channel_last=data_format in _CHANNEL_LAST,
               has_bias=bias is not None)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def _transpose_string_pads(padding, k, s):
    """lax's ``_conv_transpose_padding`` for one axis of effective kernel
    ``k`` and stride ``s``."""
    if padding == "SAME":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        lo = k - 1
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    return lo, pad_len - lo


def _conv_transpose_fwd(x, w, *rest, strides=(), padding="VALID",
                        output_padding=(), dilations=(), groups=1,
                        n_spatial=2, channel_last=False, has_bias=False):
    xc = x.movedim(-1, 1) if channel_last else x
    reach = [(k - 1) * d for k, d in zip(w.shape[2:], dilations)]
    if isinstance(padding, str):
        # lax pads the stride-dilated input; output_padding is zero rows
        # after the result
        pads = [_transpose_string_pads(padding, r + 1, s)
                for r, s in zip(reach, strides)]
        extra = tuple(output_padding)
    else:
        pads = [(r - lo, r - hi + op) for r, (lo, hi), op in
                zip(reach, padding, output_padding)]
        extra = (0,) * n_spatial
    # the full transposed convolution is lax's at pads (reach, reach):
    # crop (or zero-extend, where negative) the difference
    crops = [(r - lo, r - hi) for r, (lo, hi) in zip(reach, pads)]
    bias = rest[0] if has_bias else None
    conv_t = _CONV_T[n_spatial]
    cut = [lo - hi for lo, hi in crops]
    if not any(extra) and all(lo >= 0 for lo, _ in crops) and all(
            0 <= c < max(s, d) for c, s, d in zip(cut, strides, dilations)):
        out = conv_t(xc, w, bias, strides, [lo for lo, _ in crops], cut,
                     groups, dilations)
    else:
        out = conv_t(xc, w, None, strides, 0, 0, groups, dilations)
        out = TF.pad(out, [-c for c in _pad_arg(crops)])
        if any(extra):
            out = TF.pad(out, _pad_arg([(0, e) for e in extra]))
        if bias is not None:
            out = out + _bias_view(bias, out.ndim)
    return out.movedim(1, -1) if channel_last else out


register_op("conv_transpose", _conv_transpose_fwd)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, n_spatial, data_format,
                       output_size=None):
    out_pad = _norm_tuple(output_padding, n_spatial) if output_padding \
        else (0,) * n_spatial
    args = [x, weight] + ([bias] if bias is not None else [])
    return _op("conv_transpose", *args,
               strides=_norm_tuple(stride, n_spatial),
               padding=_norm_padding(padding, n_spatial),
               output_padding=out_pad,
               dilations=_norm_tuple(dilation, n_spatial),
               groups=int(groups), n_spatial=n_spatial,
               channel_last=data_format in _CHANNEL_LAST,
               has_bias=bias is not None)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format, output_size)
