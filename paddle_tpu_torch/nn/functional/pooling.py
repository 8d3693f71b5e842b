"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``).

The JAX package pools with ``lax.reduce_window`` (an XLA op, no Pallas
kernel); here each pool is torch's, which cuDNN or torch's CUDA kernels
run on the card, with the JAX package's windows:

* ``ceil_mode`` extends the high pad until the last window fits, as the
  JAX package does, and keeps a window that lies wholly in the pad: a max
  pool gives ``-inf`` there, an ``exclusive`` average pool ``nan``
  (0 / 0). torch's ``ceil_mode`` drops such a window, so it is never
  used: a pad torch cannot take (one side unlike the other, or more than
  half the window) is explicit (``-inf`` for max, 0 for the average).
* ``exclusive`` (the default) divides an average by the count of real
  elements in its window when any pad is nonzero, else by the window's
  size.
* ``max_pool2d`` / ``max_pool3d`` with ``return_mask`` return int32
  indices into the flattened input plane (volume), as the JAX package's
  ``max_pool2d_mask`` does (NCHW / NCDHW, no ``ceil_mode``);
  ``max_pool1d`` and the adaptive max pools take ``return_mask`` and do
  not read it, as the JAX package does not.
* an adaptive pool's bins run from ``floor(i * in / out)`` to
  ``ceil((i + 1) * in / out)``; where every axis divides evenly the pool
  is a reshape and a mean (max) over each bin, as in the JAX package, so
  its backward is an expand (no atomics), else torch's adaptive pool.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import register_op
from ...ops._helpers import _op, static_int_list

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
    "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]

_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC")
_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _norm(v, n):
    t = static_int_list(v)
    return tuple(t * n if len(t) == 1 else t)


def _pad_arg(pads):
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _torch_pads(pads, kernel):
    """torch's own ``padding`` where it can take ``pads`` (each axis even
    and at most half its window), else None."""
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
        return [lo for lo, _ in pads]
    return None


def _window_counts(sizes, kernel, strides, pads, device):
    """The count of real (unpadded) elements in every window: per axis the
    overlap of the window with the input, multiplied over the axes."""
    count = np.ones((), np.float32)
    for n, k, s, (lo, hi) in zip(sizes, kernel, strides, pads):
        starts = np.arange((n + lo + hi - k) // s + 1) * s - lo
        axis = (np.minimum(starts + k, n) - np.maximum(starts, 0)).clip(0)
        count = np.multiply.outer(count, axis.astype(np.float32))
    return torch.from_numpy(np.ascontiguousarray(count)).to(device)


def _pool_fwd(x, kernel=(), strides=(), padding=(), mode="max",
              channel_last=False, exclusive=True):
    n = len(kernel)
    xc = x.movedim(-1, 1) if channel_last else x
    native = _torch_pads(padding, kernel)
    if mode == "max":
        if native is not None:
            out = _MAX[n](xc, kernel, strides, native)
        else:
            low = -math.inf if xc.is_floating_point() \
                else torch.iinfo(xc.dtype).min
            out = _MAX[n](TF.pad(xc, _pad_arg(padding), value=low), kernel,
                          strides)
    elif not any(lo or hi for lo, hi in padding):
        out = _AVG[n](xc, kernel, strides)
    elif native is not None:
        # torch divides by the real count (count_include_pad=False) or by
        # the window's size: with each pad at most half the window every
        # window lies inside the padded input, as lax's do
        out = _AVG[n](xc, kernel, strides, native,
                      count_include_pad=not exclusive)
    else:
        out = _AVG[n](TF.pad(xc, _pad_arg(padding)), kernel, strides)
        if exclusive:
            # the window's size over its real count (0 / 0 where it lies
            # wholly in the pad: nan, as in the JAX package)
            counts = _window_counts(xc.shape[2:], kernel, strides, padding,
                                    xc.device)
            out = out * (math.prod(kernel) / counts).to(out.dtype)
    return out.movedim(1, -1) if channel_last else out


register_op("pool", _pool_fwd)


def _pool(x, kernel_size, stride, padding, n_spatial, mode, data_format,
          ceil_mode=False, exclusive=True):
    channel_last = data_format in _CHANNEL_LAST
    kernel = _norm(kernel_size, n_spatial)
    strides = _norm(stride, n_spatial) if stride is not None else kernel
    if isinstance(padding, str):
        raise NotImplementedError("string padding for pools")
    pad = _norm(padding, n_spatial)
    pads = tuple((p, p) for p in pad)
    if ceil_mode:
        # extend the high pad so that ceil-division windows fit (the JAX
        # package's ceil_mode: a window wholly in the pad is kept)
        first = 1 if channel_last else 2
        new_pads = []
        for i in range(n_spatial):
            size = x.shape[first + i] + 2 * pad[i]
            rem = (size - kernel[i]) % strides[i]
            extra = (strides[i] - rem) % strides[i] if rem else 0
            new_pads.append((pad[i], pad[i] + extra))
        pads = tuple(new_pads)
    return _op("pool", x, kernel=kernel, strides=strides, padding=pads,
               mode=mode, channel_last=channel_last,
               exclusive=bool(exclusive))


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "max", data_format,
                 ceil_mode)


def _max_pool_mask_fwd(x, *, kernel, strides, pads):
    """Max pool and, int32, the index of each maximum in the flattened
    input plane (volume): the JAX package's ``max_pool{2,3}d_mask``,
    which pads with the lowest fp32 value."""
    n = len(kernel)
    sizes = x.shape[2:]
    if all(2 * p <= k for p, k in zip(pads, kernel)):
        out, idx = _MAX[n](x, kernel, strides, pads, return_indices=True)
        return out, idx.to(torch.int32)
    low = torch.finfo(torch.float32).min
    padded = TF.pad(x, _pad_arg([(p, p) for p in pads]), value=low)
    out, idx = _MAX[n](padded, kernel, strides, return_indices=True)
    # an index into the padded plane -> the same position in the input's
    coords, rest = [], idx
    for size in reversed(padded.shape[2:]):
        coords.append(rest % size)
        rest = rest // size
    flat = torch.zeros_like(idx)
    for c, p, size in zip(reversed(coords), pads, sizes):
        flat = flat * size + (c - p)
    return out, flat.to(torch.int32)


register_op("max_pool_mask", _max_pool_mask_fwd)


def _max_pool_mask(x, kernel_size, stride, padding, n):
    k = _norm(kernel_size, n)
    s = k if stride is None else _norm(stride, n)
    return _op("max_pool_mask", x, kernel=k, strides=s,
               pads=_norm(padding, n))


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    if return_mask:
        assert data_format == "NCHW" and not ceil_mode, \
            "return_mask supports NCHW, ceil_mode=False"
        return _max_pool_mask(x, kernel_size, stride, padding, 2)
    return _pool(x, kernel_size, stride, padding, 2, "max", data_format,
                 ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    if return_mask:
        assert data_format == "NCDHW" and not ceil_mode, \
            "return_mask supports NCDHW, ceil_mode=False"
        return _max_pool_mask(x, kernel_size, stride, padding, 3)
    return _pool(x, kernel_size, stride, padding, 3, "max", data_format,
                 ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", data_format,
                 ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg", data_format,
                 ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg", data_format,
                 ceil_mode, exclusive)


_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _adaptive_pool_fwd(x, out_sizes=(), mode="avg", channel_last=False):
    n = len(out_sizes)
    xc = x.movedim(-1, 1) if channel_last else x
    sizes = xc.shape[2:]
    if all(s % o == 0 for s, o in zip(sizes, out_sizes)):
        # every bin k = in / out wide: [.., o1, k1, o2, k2, ..] reduced
        # over the k axes
        split = [d for s, o in zip(sizes, out_sizes) for d in (o, s // o)]
        r = xc.reshape(*xc.shape[:2], *split)
        axes = tuple(range(3, 3 + 2 * n, 2))
        out = r.mean(dim=axes) if mode == "avg" else r.amax(dim=axes)
    else:
        out = _ADAPTIVE[mode, n](xc, out_sizes)
    return out.movedim(1, -1) if channel_last else out


register_op("adaptive_pool", _adaptive_pool_fwd)


def _adaptive(x, output_size, n_spatial, mode, data_format):
    channel_last = data_format in _CHANNEL_LAST
    out_sizes = list(output_size) if isinstance(output_size, (list, tuple)) \
        else [output_size]
    if len(out_sizes) == 1:
        out_sizes = out_sizes * n_spatial
    first = 1 if channel_last else x.ndim - n_spatial
    resolved = tuple(int(x.shape[first + i]) if s is None or int(s) < 0
                     else int(s) for i, s in enumerate(out_sizes))
    return _op("adaptive_pool", x, out_sizes=resolved, mode=mode,
               channel_last=channel_last)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max", "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "max", "NCDHW")
