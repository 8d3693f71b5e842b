"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``),
each a torch forward registered with ``core.dispatch`` with the JAX
package's formulas (a ``"mean"`` cross entropy divides by the weight of
the labels that are not ``ignore_index``)."""
from __future__ import annotations

import math

import torch

from ...core.dispatch import register_op
from ...ops._helpers import _op

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss",
    "smooth_l1_loss", "nll_loss", "kl_div", "margin_ranking_loss",
    "cosine_embedding_loss", "hinge_embedding_loss", "square_error_cost",
    "sigmoid_focal_loss", "log_loss", "soft_margin_loss",
    "triplet_margin_loss", "multi_label_soft_margin_loss",
    "poisson_nll_loss",
]


def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def _pick(logp, lbl, axis):
    """``-logp`` at the labels along ``axis`` (the label axis dropped)."""
    return -torch.gather(logp, axis, lbl.unsqueeze(axis)).squeeze(axis)


def _ce_fwd(logits, label, weight=None, soft_label=False, axis=-1,
            use_softmax=True, ignore_index=-100, reduction="mean",
            label_smoothing=0.0):
    axis = axis % logits.dim()
    logp = torch.log_softmax(logits, axis) if use_softmax \
        else torch.log(torch.clamp_min(logits, 1e-30))
    if soft_label:
        loss = -torch.sum(label * logp, dim=axis)
        valid = torch.ones_like(loss)
    else:
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        lbl = lbl.long()
        safe = torch.where(lbl == ignore_index, torch.zeros_like(lbl), lbl)
        if label_smoothing > 0.0:
            n = logits.shape[axis]
            onehot = torch.movedim(torch.nn.functional.one_hot(safe, n), -1,
                                   axis).to(logp.dtype)
            smooth = onehot * (1 - label_smoothing) + label_smoothing / n
            loss = -torch.sum(smooth * logp, dim=axis)
        else:
            loss = _pick(logp, safe, axis)
        valid = (lbl != ignore_index).to(loss.dtype)
        loss = loss * valid
        if weight is not None:
            wgt = weight[safe]
            loss = loss * wgt
            valid = valid * wgt
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp_min(torch.sum(valid), 1e-9)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


register_op("cross_entropy", _ce_fwd)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy of ``input`` against class indices (or, with
    ``soft_label``, distributions) along ``axis``."""
    return _op("cross_entropy", input, label, weight,
               soft_label=bool(soft_label), axis=int(axis),
               use_softmax=bool(use_softmax), ignore_index=int(ignore_index),
               reduction=str(reduction),
               label_smoothing=float(label_smoothing))


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = _op("softmax_ce_noreduce", logits, label,
               soft_label=bool(soft_label), axis=int(axis),
               ignore_index=int(ignore_index))
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def _softmax_ce_noreduce(logits, label, soft_label=False, axis=-1,
                         ignore_index=-100):
    axis = axis % logits.dim()
    logp = torch.log_softmax(logits, axis)
    if soft_label:
        return -torch.sum(label * logp, dim=axis, keepdim=True)
    lbl = label
    if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    lbl = lbl.long()
    safe = torch.where(lbl == ignore_index, torch.zeros_like(lbl), lbl)
    loss = _pick(logp, safe, axis).unsqueeze(axis)
    return torch.where((lbl != ignore_index).unsqueeze(axis), loss,
                       torch.zeros_like(loss))


register_op("softmax_ce_noreduce", _softmax_ce_noreduce)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    return _op("bce", input, label, weight, reduction=str(reduction))


def _bce_fwd(x, label, weight=None, reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp_min(x, eps))
             + (1 - label) * torch.log(torch.clamp_min(1 - x, eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


register_op("bce", _bce_fwd)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    return _op("bce_logits", logit, label, weight, pos_weight,
               reduction=str(reduction))


def _bce_logits_fwd(x, label, w=None, pw=None, reduction="mean"):
    max_val = torch.clamp_min(-x, 0.0)
    log_term = torch.log(torch.exp(-max_val) + torch.exp(-x - max_val)) \
        + max_val
    if pw is not None:
        loss = (1 - label) * x + ((pw - 1) * label + 1) * log_term
    else:
        loss = (1 - label) * x + log_term
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


register_op("bce_logits", _bce_logits_fwd)


def mse_loss(input, label, reduction="mean", name=None):
    return _op("mse_loss", input, label, reduction=str(reduction))


register_op("mse_loss", lambda x, y, reduction="mean":
            _reduce(torch.square(x - y), reduction))


def square_error_cost(input, label):
    return _op("mse_loss", input, label, reduction="none")


def l1_loss(input, label, reduction="mean", name=None):
    return _op("l1_loss", input, label, reduction=str(reduction))


register_op("l1_loss", lambda x, y, reduction="mean":
            _reduce(torch.abs(x - y), reduction))


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    return _op("smooth_l1", input, label, reduction=str(reduction),
               delta=float(delta))


def _smooth_l1_fwd(x, y, reduction="mean", delta=1.0):
    diff = torch.abs(x - y)
    loss = torch.where(diff < delta, 0.5 * torch.square(diff) / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


register_op("smooth_l1", _smooth_l1_fwd)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    return _op("nll_loss", input, label, weight,
               ignore_index=int(ignore_index), reduction=str(reduction))


def _nll_fwd(logp, label, weight=None, ignore_index=-100, reduction="mean"):
    lbl = label.long()
    safe = torch.where(lbl == ignore_index, torch.zeros_like(lbl), lbl)
    loss = _pick(logp, safe, 1)
    valid = (lbl != ignore_index).to(loss.dtype)
    loss = loss * valid
    if weight is not None:
        wv = weight[safe]
        loss = loss * wv
        valid = valid * wv
    if reduction == "mean":
        return torch.sum(loss) / torch.clamp_min(torch.sum(valid), 1e-9)
    return _reduce(loss, reduction)


register_op("nll_loss", _nll_fwd)


def kl_div(input, label, reduction="mean", name=None):
    return _op("kl_div", input, label, reduction=str(reduction))


def _kl_div_fwd(logp, target, reduction="mean"):
    loss = target * (torch.log(torch.clamp_min(target, 1e-12)) - logp)
    if reduction == "batchmean":
        return torch.sum(loss) / logp.shape[0]
    return _reduce(loss, reduction)


register_op("kl_div", _kl_div_fwd)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _op("margin_ranking", input, other, label, margin=float(margin),
               reduction=str(reduction))


register_op("margin_ranking", lambda x, y, label, margin=0.0,
            reduction="mean": _reduce(torch.clamp_min(
                -label * (x - y) + margin, 0.0), reduction))


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    return _op("cosine_embedding", input1, input2, label,
               margin=float(margin), reduction=str(reduction))


def _cos_emb_fwd(x1, x2, label, margin=0.0, reduction="mean"):
    cos = torch.sum(x1 * x2, dim=-1) / torch.clamp_min(
        torch.linalg.vector_norm(x1, dim=-1)
        * torch.linalg.vector_norm(x2, dim=-1), 1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp_min(cos - margin,
                                                            0.0))
    return _reduce(loss, reduction)


register_op("cosine_embedding", _cos_emb_fwd)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _op("hinge_embedding", input, label, margin=float(margin),
               reduction=str(reduction))


register_op("hinge_embedding", lambda x, label, margin=1.0, reduction="mean":
            _reduce(torch.where(label == 1, x, torch.clamp_min(margin - x,
                                                               0.0)),
                    reduction))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    return _op("focal", logit, label, normalizer, alpha=float(alpha),
               gamma=float(gamma), reduction=str(reduction))


def _focal_fwd(x, label, normalizer=None, alpha=0.25, gamma=2.0,
               reduction="sum"):
    p = torch.sigmoid(x)
    ce = torch.clamp_min(x, 0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


register_op("focal", _focal_fwd)


def log_loss(input, label, epsilon=1e-4, name=None):
    return _op("log_loss", input, label, epsilon=float(epsilon))


register_op("log_loss", lambda p, y, epsilon=1e-4:
            -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon))


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _op("soft_margin", input, label, reduction=str(reduction))


register_op("soft_margin", lambda x, y, reduction="mean":
            _reduce(torch.log1p(torch.exp(-y * x)), reduction))


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    return _op("triplet", input, positive, negative, margin=float(margin),
               p=float(p), epsilon=float(epsilon), swap=bool(swap),
               reduction=str(reduction))


def _triplet_fwd(a, pos, neg, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean"):
    def dist(u, v):
        return torch.sum(torch.abs(u - v + epsilon) ** p, dim=-1) ** (1.0 / p)
    d_pos, d_neg = dist(a, pos), dist(a, neg)
    if swap:
        d_neg = torch.minimum(d_neg, dist(pos, neg))
    return _reduce(torch.clamp_min(d_pos - d_neg + margin, 0.0), reduction)


register_op("triplet", _triplet_fwd)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    return _op("ml_soft_margin", input, label, weight,
               reduction=str(reduction))


def _ml_soft_margin_fwd(x, y, weight=None, reduction="mean"):
    loss = -(y * torch.nn.functional.logsigmoid(x)
             + (1 - y) * torch.nn.functional.logsigmoid(-x))
    if weight is not None:
        loss = loss * weight
    return _reduce(torch.mean(loss, dim=-1), reduction)


register_op("ml_soft_margin", _ml_soft_margin_fwd)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    return _op("poisson_nll", input, label, log_input=bool(log_input),
               full=bool(full), epsilon=float(epsilon),
               reduction=str(reduction))


def _poisson_nll_fwd(x, y, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean"):
    loss = torch.exp(x) - y * x if log_input \
        else x - y * torch.log(x + epsilon)
    if full:
        stirling = y * torch.log(y + epsilon) - y + 0.5 * torch.log(
            2 * math.pi * (y + epsilon))
        loss = loss + torch.where(y > 1, stirling, torch.zeros_like(y))
    return _reduce(loss, reduction)


register_op("poisson_nll", _poisson_nll_fwd)
