"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
``linear`` (Paddle's ``[in, out]`` weight), the dropouts, ``embedding``
and the small tensor functionals, ``interpolate`` / ``upsample``,
``unfold`` and ``fold``, each dispatched through ``core.dispatch``
(``Tensor`` in, ``Tensor`` out; plain torch tensors in, plain out, as the
port's models call them).

``interpolate`` is the JAX package's, which is ``jax.image.resize`` and
neither Paddle's nor torch's resize: half-pixel centres, ``align_corners``
and ``align_mode`` taken and never read, ``"area"`` computed as linear,
``nearest`` sampling at ``floor((i + 0.5) * in / out)`` (torch's
``"nearest-exact"``), ``linear`` and ``cubic`` antialiased when they
shrink and ``cubic`` Keys' kernel at a = -0.5 (torch's bicubic is -0.75).
It builds jax.image's weight matrix for each resized axis on the host, in
fp32 as jax.image computes it, once for each (sizes, mode, device, type),
and contracts the input with each: one route for every mode and for 1-D,
2-D and 3-D.

``dropout`` draws from an explicit CPU ``torch.Generator`` where it is
given one and from the global chain (``core.random``: ``seed``) where it
is not. Each call draws one seed (``core.random.next_seed``) and hands it
to ``DropoutFunction``, whose wrapper launches the dropout kernel on a CUDA
tensor and runs the kernel's plain version on a CPU tensor: the two drop
the same elements for the same seed, so a run on the card and one on the
CPU from the same generator state agree. The backward regenerates the
mask from the seed.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import register_op
from ...core.random import default_generator, next_seed
from ...kernels.dropout import DropoutFunction
from ...ops._helpers import _op, static_int_list
from ...ops.manipulation import one_hot as _one_hot
from ...ops.manipulation import pad  # noqa: F401  (paddle.nn.functional.pad)

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "pad", "bilinear", "cosine_similarity",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
           "label_smooth", "interpolate", "upsample", "class_center_sample",
           "unfold", "fold"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight."""
    return _op("linear", x, weight, bias)


register_op("linear", lambda x, w, b=None: TF.linear(x, w.t(), b))


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None, *, generator=None):
    """``paddle.nn.functional.dropout``: each element of ``x`` (or each
    slice along the axes not in ``axis``) is zeroed with probability ``p``.

    ``mode="upscale_in_train"`` scales the kept elements by ``1 / (1 - p)``
    in training and leaves eval alone; ``"downscale_in_infer"`` keeps them
    unscaled in training and multiplies by ``1 - p`` in eval. Without
    ``axis`` the mask comes from the dropout kernel (``DropoutFunction``);
    with ``axis`` it has the shape of ``x`` cut to 1 off ``axis`` and is
    drawn with ``torch.bernoulli`` from ``generator`` (an XLA op in the JAX
    package too, not a kernel). ``generator`` (a CPU ``torch.Generator``)
    overrides the global chain, which a call without one draws from."""
    return _op("dropout", x, p=p, axis=axis, training=training, mode=mode,
               generator=generator)


def _dropout_fwd(x, p=0.5, axis=None, training=True,
                 mode="upscale_in_train", generator=None):
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    p = float(p)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p must be in [0, 1], got {p}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    upscale = mode == "upscale_in_train"
    if p == 1.0:
        return x * 0.0
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
        keep = torch.bernoulli(torch.full(shape, 1.0 - p),
                               generator=default_generator(generator)
                               ).to(x.device, x.dtype)
        return x * keep / (1.0 - p) if upscale else x * keep
    return DropoutFunction.apply(x.contiguous(), next_seed(generator), p,
                                 upscale)


register_op("dropout", _dropout_fwd)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped (the mask varies over N and C only)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: dropped elements go to the negative saturation and
    an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = torch.bernoulli(torch.full(tuple(x.shape), 1.0 - float(p)),
                           generator=default_generator()).bool()
    a = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b = -a * alpha_p * p
    return _op("alpha_dropout", x, keep.to(x.device), alpha_p=alpha_p, a=a,
               b=b)


register_op("alpha_dropout", lambda x, keep, alpha_p=0.0, a=1.0, b=0.0:
            a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``; rows at ``padding_idx`` come out
    zero (and pass no gradient). ``sparse`` gradients are ROADMAP Queue 1,
    item 4's sparse rule: the gradient here is dense."""
    if padding_idx is not None and padding_idx < 0:
        padding_idx += int(weight.shape[0])
    return _op("embedding", weight, x, padding_idx=padding_idx)


def _embedding_fwd(w, ids, padding_idx=None):
    out = TF.embedding(ids.long(), w)
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return out


register_op("embedding", _embedding_fwd)


def one_hot(x, num_classes, name=None):
    return _one_hot(x, num_classes)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``x1^T W x2 + b`` with ``weight`` ``[out, in1, in2]``."""
    return _op("bilinear", x1, x2, weight, bias)


register_op("bilinear", lambda x1, x2, w, b=None: TF.bilinear(
    x1, x2, w, None if b is None else b.reshape(-1)))


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    return _op("cosine_similarity", x1, x2, axis=int(axis), eps=float(eps))


def _cos_sim_fwd(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(torch.square(x1), dim=axis))
    n2 = torch.sqrt(torch.sum(torch.square(x2), dim=axis))
    return dot / torch.clamp_min(n1 * n2, eps)


register_op("cosine_similarity", _cos_sim_fwd)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return _op("pixel_shuffle", x, r=int(upscale_factor),
               channel_last=data_format == "NHWC")


def _channels_first(fn):
    """``fn`` on NCHW, taking and giving NHWC when ``channel_last``."""
    def run(x, r=1, channel_last=False):
        if channel_last:
            return fn(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
        return fn(x, r)
    return run


register_op("pixel_shuffle", _channels_first(TF.pixel_shuffle))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return _op("pixel_unshuffle", x, r=int(downscale_factor),
               channel_last=data_format == "NHWC")


register_op("pixel_unshuffle", _channels_first(TF.pixel_unshuffle))


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    return _op("channel_shuffle", x, groups=int(groups),
               channel_last=data_format == "NHWC")


def _channel_shuffle_fwd(x, groups=1, channel_last=False):
    ax = x.dim() - 1 if channel_last else 1
    c = x.shape[ax]
    moved = torch.movedim(x, ax, 1)
    rest = tuple(moved.shape[2:])
    out = moved.reshape((moved.shape[0], groups, c // groups) + rest)
    out = out.transpose(1, 2).reshape((moved.shape[0], c) + rest)
    return torch.movedim(out, 1, ax)


register_op("channel_shuffle", _channel_shuffle_fwd)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    return _op("label_smooth", label, prior_dist, epsilon=float(epsilon))


register_op("label_smooth", lambda label, prior=None, epsilon=0.1:
            (1 - epsilon) * label + (epsilon / label.shape[-1]
                                     if prior is None else epsilon * prior))


# Paddle's modes -> jax.image.resize's methods (the JAX package's table)
_RESIZE_METHOD = {"nearest": "nearest", "bilinear": "linear",
                  "linear": "linear", "trilinear": "linear",
                  "bicubic": "cubic", "area": "linear"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes of ``x`` to ``size`` (or ``int(in *
    scale_factor)`` each) as the JAX package does (``jax.image.resize``;
    see the module's docstring): ``align_corners`` and ``align_mode`` are
    taken and not read."""
    channel_last = data_format in ("NHWC", "NWC", "NDHWC")
    n_spatial = x.dim() - 2
    sp_shape = x.shape[1:-1] if channel_last else x.shape[2:]
    if size is not None:
        out_sizes = static_int_list(size)
    else:
        scales = [float(scale_factor)] * n_spatial \
            if isinstance(scale_factor, (int, float)) \
            else [float(v) for v in scale_factor]
        out_sizes = [int(s * f) for s, f in zip(sp_shape, scales)]
    return _op("interpolate", x, out_sizes=tuple(int(v) for v in out_sizes),
               mode=str(mode), channel_last=channel_last)


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def _triangle(x):
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


@functools.lru_cache(maxsize=256)
def _resize_matrix(m: int, n: int, method: str, device, dtype):
    """``_resize_weights(m, n, method)`` as a tensor on ``device`` in
    ``dtype``, made once: a steady-state resize only contracts."""
    return torch.from_numpy(_resize_weights(m, n, method)).to(device, dtype)


def _resize_weights(m: int, n: int, method: str) -> np.ndarray:
    """The fp32 ``[m, n]`` matrix that takes an axis of ``m`` samples to
    ``n`` as ``jax.image.resize`` does (``compute_weight_mat`` with
    antialiasing, translation 0; ``_resize_nearest``'s gather as a 0/1
    matrix)."""
    f32 = np.float32
    if method == "nearest":
        src = np.floor((np.arange(n, dtype=f32) + f32(0.5)) * f32(m)
                       / f32(n)).astype(np.int64)
        w = np.zeros((m, n), f32)
        w[src, np.arange(n)] = 1.0
        return w
    inv_scale = 1.0 / (n / m)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.0) - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) \
        / kernel_scale
    w = (_keys_cubic if method == "cubic" else _triangle)(dist)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _interpolate_fwd(x, out_sizes=(), mode="nearest", channel_last=False):
    method = _RESIZE_METHOD[mode]
    first = 1 if channel_last else 2
    out = x
    for i, n in enumerate(out_sizes):
        d = first + i
        m = int(x.shape[d])
        if m == n:                   # jax.image.resize skips such an axis
            continue
        w = _resize_matrix(m, n, method, x.device, x.dtype)
        out = torch.movedim(torch.tensordot(out, w, dims=([d], [0])), -1, d)
    return out


register_op("interpolate", _interpolate_fwd)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def class_center_sample(label, num_classes, num_samples, group=None):
    raise NotImplementedError("class_center_sample lands with the "
                              "PS/recsys stack")


def _pair(v):
    v = static_int_list(v)
    return tuple(v * 2 if len(v) == 1 else v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """``[N, C, H, W]`` -> ``[N, C*kh*kw, L]`` sliding blocks, channel-major
    then (kh, kw) (the JAX package's ``conv_general_dilated_patches``)."""
    return _op("unfold", x, k=_pair(kernel_sizes), s=_pair(strides),
               p=_pair(paddings), d=_pair(dilations))


register_op("unfold", lambda x, k=(3, 3), s=(1, 1), p=(0, 0), d=(1, 1):
            TF.unfold(x, k, dilation=d, padding=p, stride=s))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """``unfold``'s adjoint: ``[N, C*kh*kw, L]`` blocks summed into ``[N, C,
    H, W]``, one strided add per kernel offset as in the JAX package."""
    return _op("fold", x, out_hw=_pair(output_sizes), k=_pair(kernel_sizes),
               s=_pair(strides), p=_pair(paddings), d=_pair(dilations))


def _fold_fwd(x, out_hw=(1, 1), k=(3, 3), s=(1, 1), p=(0, 0), d=(1, 1)):
    n, ckk, _ = x.shape
    c = ckk // (k[0] * k[1])
    oh = (out_hw[0] + 2 * p[0] - d[0] * (k[0] - 1) - 1) // s[0] + 1
    ow = (out_hw[1] + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1
    cols = x.reshape(n, c, k[0], k[1], oh, ow)
    out = x.new_zeros((n, c, out_hw[0] + 2 * p[0], out_hw[1] + 2 * p[1]))
    for i in range(k[0]):
        for j in range(k[1]):
            hi, wj = i * d[0], j * d[1]
            out[:, :, hi:hi + oh * s[0]:s[0], wj:wj + ow * s[1]:s[1]] += \
                cols[:, :, i, j]
    return out[:, :, p[0]:out.shape[2] - p[0], p[1]:out.shape[3] - p[1]]


register_op("fold", _fold_fwd)
