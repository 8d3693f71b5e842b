"""Normalisation functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``): ``batch_norm``, ``layer_norm``,
``instance_norm``, ``group_norm``, ``local_response_norm``,
``normalize`` and the fused residual epilogue ``add_dropout_ln``,
dispatched through ``core.dispatch``.

``batch_norm`` is Paddle's: ``momentum`` (0.9) weighs the OLD running
value, ``running * momentum + batch * (1 - momentum)`` (torch's
``momentum`` weighs the batch: the port hands torch ``1 - momentum``);
the running variance takes the unbiased batch variance (``n / (n - 1)``,
``n`` the elements a channel), the normalisation the biased one. In
training the op updates the running buffers in place (so a captured
step's graph writes them where they live, once a call), but not in a
recompute region's replay (``core.remat.in_replay``); torch's
``batch_norm`` (cuDNN on the card) computes the statistics and the
update in one call where the types agree and a channel has more than one
element (and ``epsilon`` is positive, which torch requires in training),
and the JAX package's formula runs elsewhere. The batch norms,
the instance and group norms are XLA ops in the JAX package, no
Pallas kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import register_op
from ...core.remat import in_replay
from ...core.random import next_seed
from ...kernels.fused_residual import FusedAddDropoutLN
from ...ops._helpers import _op
from .common import _dropout_fwd

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm", "normalize", "add_dropout_ln"]


def _alias(t):
    """A plain ``torch.Tensor`` over ``t``'s storage: a running buffer the
    op body updates in place."""
    if type(t) is torch.Tensor:
        return t
    with torch._C.DisableTorchFunctionSubclass():
        return t.as_subclass(torch.Tensor)


def _stats_view(t, ndim):
    return t.reshape([1, -1] + [1] * (ndim - 2))


def _bn_formula(x, mean, var, weight, bias, epsilon):
    """The JAX package's ``(x - mean) / sqrt(var + eps) * w + b`` with the
    channel on axis 1."""
    out = (x - _stats_view(mean, x.ndim)) * torch.reciprocal(
        torch.sqrt(_stats_view(var, x.ndim) + epsilon))
    if weight is not None:
        out = out * _stats_view(weight, x.ndim) + _stats_view(bias, x.ndim)
    return out


def _one_type(*ts):
    return len({t.dtype for t in ts if t is not None}) == 1


def _bn_infer_fwd(x, mean, var, weight=None, bias=None, epsilon=1e-5,
                  channel_axis=1):
    xc = x if channel_axis == 1 else x.movedim(channel_axis, 1)
    if _one_type(xc, mean, var, weight, bias):
        out = TF.batch_norm(xc, mean, var, weight, bias, False, 0.0,
                            epsilon)
    else:
        out = _bn_formula(xc, mean, var, weight, bias, epsilon)
    return out if channel_axis == 1 else out.movedim(1, channel_axis)


register_op("batch_norm_infer", _bn_infer_fwd)


def _bn_train_fwd(x, weight=None, bias=None, epsilon=1e-5, channel_axis=1,
                  running=None, momentum=0.9):
    """Batch statistics; ``running`` (the two buffers, or None) updated in
    place by ``momentum``, except in a recompute region's replay
    (``core.remat.in_replay``), where copies of them take the update: the
    ops and their saved tensors stay the first forward's, the buffers keep
    the one update that forward made."""
    xc = x if channel_axis == 1 else x.movedim(channel_axis, 1)
    n = xc.numel() // xc.shape[1]
    rm, rv = running if running is not None else (None, None)
    if rm is not None and in_replay():
        rm, rv = rm.clone(), rv.clone()
    if n > 1 and epsilon > 0 and _one_type(xc, weight, bias, rm, rv):
        out = TF.batch_norm(xc, rm, rv, weight, bias, True, 1.0 - momentum,
                            epsilon)
    else:
        var, mean = torch.var_mean(xc, dim=[0] + list(range(2, xc.ndim)),
                                   correction=0)
        out = _bn_formula(xc, mean, var, weight, bias, epsilon)
        if rm is not None:
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                rm.copy_(rm * momentum + mean * (1 - momentum))
                rv.copy_(rv * momentum + unbiased * (1 - momentum))
    return out if channel_axis == 1 else out.movedim(1, channel_axis)


register_op("batch_norm_train", _bn_train_fwd)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """``paddle.nn.functional.batch_norm``: batch statistics (and the
    running update) unless ``use_global_stats`` (default ``not
    training``), else the running statistics. The channel is axis 1 for
    an ``NC*`` format or an input of at most 2 axes, else the last."""
    channel_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    if x.ndim <= 2:
        channel_axis = x.ndim - 1
    if use_global_stats is None:
        use_global_stats = not training
    affine = [weight, bias] if weight is not None else []
    if not use_global_stats:
        running = None if running_mean is None \
            else (_alias(running_mean), _alias(running_var))
        return _op("batch_norm_train", x, *affine, epsilon=float(epsilon),
                   channel_axis=int(channel_axis), running=running,
                   momentum=float(momentum))
    return _op("batch_norm_infer", x, running_mean, running_var, *affine,
               epsilon=float(epsilon), channel_axis=int(channel_axis))


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5, name=None):
    """``paddle.nn.functional.layer_norm`` over the trailing
    ``normalized_shape`` axes (an XLA op in the JAX package, not a
    kernel)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return _op("layer_norm", x, weight, bias,
               normalized_shape=tuple(int(s) for s in normalized_shape),
               epsilon=float(epsilon))


register_op("layer_norm", lambda x, w=None, b=None, normalized_shape=(),
            epsilon=1e-5: torch.nn.functional.layer_norm(
                x, normalized_shape, w, b, epsilon))


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's channels normalised over their spatial axes (axis 1
    the channel). ``running_mean``, ``running_var``, ``use_input_stats``,
    ``momentum`` and ``data_format`` are taken and not read: the JAX
    package always normalises by the input's statistics and updates
    nothing."""
    affine = [weight, bias] if weight is not None else []
    return _op("instance_norm", x, *affine, epsilon=float(eps))


register_op("instance_norm", lambda x, w=None, b=None, epsilon=1e-5:
            TF.instance_norm(x, None, None, w, b, True, 0.0, epsilon))


def _group_norm_fwd(x, weight=None, bias=None, epsilon=1e-5, num_groups=1,
                    channel_axis=1):
    xc = x if channel_axis == 1 else x.movedim(channel_axis, 1)
    out = TF.group_norm(xc, num_groups, weight, bias, epsilon)
    return out if channel_axis == 1 else out.movedim(1, channel_axis)


register_op("group_norm", _group_norm_fwd)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    affine = [weight, bias] if weight is not None else []
    return _op("group_norm", x, *affine, epsilon=float(epsilon),
               num_groups=int(num_groups), channel_axis=channel_axis)


def _lrn_fwd(x, size=5, alpha=1e-4, beta=0.75, k=1.0):
    """``x / (k + alpha * s) ** beta``, ``s`` the sum of squares over a
    window of ``size`` channels (axis 1; the JAX package's sum, not
    torch's mean over the window)."""
    c = x.shape[1]
    lo = (size - 1) // 2
    sq = TF.pad(x.square().movedim(1, -1), [lo, size - 1 - lo]).movedim(-1, 1)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + sq.narrow(1, i, c)
    return x / torch.pow(k + alpha * acc, beta)


register_op("local_response_norm", _lrn_fwd)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    return _op("local_response_norm", x, size=int(size), alpha=float(alpha),
               beta=float(beta), k=float(k))


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x`` over its ``p``-norm along ``axis`` (at least ``epsilon``)."""
    return _op("normalize", x, p=float(p), axis=int(axis),
               epsilon=float(epsilon))


register_op("normalize", lambda x, p=2.0, axis=1, epsilon=1e-12: x / (
    torch.clamp_min(torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True)
                    ** (1.0 / p), epsilon)))


def add_dropout_ln(x, sub, weight, bias, p: float = 0.0,
                   epsilon: float = 1e-12, training: bool = True,
                   generator=None):
    """``LayerNorm(x + dropout(sub))`` over the last axis: the transformer
    sublayer's residual epilogue (BERT's post-LN blocks).

    Where the JAX package fuses it (the width a multiple of 128), this is
    ``FusedAddDropoutLN``: the fused kernels on a CUDA tensor, their plain
    version on a CPU tensor, one seed drawn from ``generator`` when it
    drops. Elsewhere it is the composition ``layer_norm(x + dropout(sub))``.
    Either way the card and the CPU draw the same seeds and drop the same
    elements. Without ``generator`` the seed comes from the global chain
    (``core.random``: ``seed``)."""
    return _op("fused_add_dropout_ln", x, sub, weight, bias, p=float(p),
               epsilon=float(epsilon), training=bool(training),
               generator=generator)


def _add_dropout_ln_fwd(x, sub, weight, bias, p=0.0, epsilon=1e-12,
                        training=True, generator=None):
    rate = float(p) if training else 0.0
    if x.shape[-1] % 128 == 0:
        seed = next_seed(generator) if rate > 0.0 else 0
        return FusedAddDropoutLN.apply(x, sub, weight, bias, seed, rate,
                                       float(epsilon))
    h = x + _dropout_fwd(sub, p=rate, training=rate > 0.0,
                         generator=generator)
    return torch.nn.functional.layer_norm(h, (x.shape[-1],), weight, bias,
                                          epsilon)


register_op("fused_add_dropout_ln", _add_dropout_ln_fwd)
