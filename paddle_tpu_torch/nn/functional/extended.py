"""Extended functionals (counterpart of
``paddle_tpu/nn/functional/extended.py``): distance and margin losses,
CTC and RNN-T, spatial sampling (``affine_grid``, ``grid_sample``),
unpooling, beam-search utilities and three in-place activations.

Each is the JAX function's arithmetic written over torch tensors and
dispatched through ``core.dispatch`` (``Tensor`` in, ``Tensor`` out), so
autograd gives what the JAX tape gives. Where the JAX function differs
from Paddle's or torch's function of the same name, the port follows the
JAX function:

- ``ctc_loss`` takes raw logits ``[T, B, V]`` and applies ``log_softmax``
  itself; its alpha recursion is in log space with -1e30 for an
  impossible path (torch's ``ctc_loss`` takes log-probabilities and gives
  inf there); ``"mean"`` divides each loss by its label length clamped
  to 1; ``norm_by_times`` is taken and not read.
- ``rnnt_loss`` walks the (T, U + 1) lattice, a label move before each
  frame's blank; ``fastemit_lambda`` is taken and not read.
- ``grid_sample`` (default ``align_corners=True``) reflects about
  [0, size - 1] whatever ``align_corners`` says, and its ``nearest``
  rounds half to even; it gathers the corner taps itself (not torch's
  ``grid_sample``).
- ``sparse_attention`` builds a dense additive mask from the CSR offsets
  and columns on the host and runs the port's
  ``scaled_dot_product_attention`` with it, so q, k and v get
  gradients."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import register_op
from ...core.dtype import convert_dtype
from ...core.tensor import wrap_outputs
from ...ops._helpers import _op

__all__ = [
    "pairwise_distance", "diag_embed", "sequence_mask", "zeropad2d",
    "max_unpool1d", "max_unpool2d", "max_unpool3d", "dice_loss",
    "hsigmoid_loss", "npair_loss", "margin_cross_entropy", "ctc_loss",
    "rnnt_loss", "affine_grid", "grid_sample", "gather_tree",
    "temporal_shift", "sparse_attention", "triplet_margin_with_distance_loss",
    "multi_margin_loss", "elu_", "softmax_", "tanh_",
]

_NEG = -1e30            # the JAX recursions' "impossible" log-probability


def _reduce(per, reduction):
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per


# ------------------------------------------------------------------ distances

def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``||x - y + epsilon||_p`` over the last axis."""
    return _op("pairwise_distance", x, y, p=float(p), epsilon=epsilon,
               keepdim=keepdim)


register_op("pairwise_distance", lambda x, y, p=2.0, epsilon=1e-6,
            keepdim=False: torch.linalg.vector_norm(
                (x - y + epsilon).abs(), ord=p, dim=-1, keepdim=keepdim))


# ---------------------------------------------------------------- embeddings

def _diag_embed_fwd(x, offset=0, dim1=-2, dim2=-1):
    n = x.shape[-1] + abs(offset)
    idx = torch.arange(x.shape[-1], device=x.device)
    out = x.new_zeros(tuple(x.shape[:-1]) + (n, n))
    out[..., idx + max(-offset, 0), idx + max(offset, 0)] = x
    nd = out.dim()
    perm = [i for i in range(nd - 2)]
    for pos, src in sorted([(dim1 % nd, nd - 2), (dim2 % nd, nd - 1)]):
        perm.insert(pos, src)
    return out.permute(perm)


register_op("diag_embed", _diag_embed_fwd)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return _op("diag_embed", input, offset=int(offset), dim1=int(dim1),
               dim2=int(dim2))


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` over ``maxlen`` columns (the largest
    length, read on the host, where it is None)."""
    x = torch.as_tensor(x)
    m = int(maxlen) if maxlen is not None else int(x.max())
    mask = torch.arange(m, device=x.device) < x[..., None]
    return wrap_outputs(mask.to(convert_dtype(dtype)))


def zeropad2d(x, padding, data_format="NCHW", name=None):
    l, r, t, b = [int(p) for p in padding]
    pads = (l, r, t, b) if data_format == "NCHW" else (0, 0, l, r, t, b)
    return _op("zeropad2d", x, pads=pads)


register_op("zeropad2d", lambda x, pads=(): TF.pad(x, pads))


# ---------------------------------------------------------------- unpooling

def _unpool_fwd(x, indices, out_spatial=()):
    """``indices`` index each (n, c) plane's flattened output."""
    n, c = x.shape[:2]
    out = x.new_zeros((n, c, int(np.prod(out_spatial))))
    out = out.scatter(2, indices.reshape(n, c, -1).long().to(x.device),
                      x.reshape(n, c, -1))
    return out.reshape((n, c) + tuple(out_spatial))


register_op("max_unpool", _unpool_fwd)


def _unpool(x, indices, kernel_size, stride, padding, output_size, ndim):
    ks = (kernel_size,) * ndim if isinstance(kernel_size, int) \
        else tuple(kernel_size)
    st = ks if stride is None else (
        (stride,) * ndim if isinstance(stride, int) else tuple(stride))
    pd = (padding,) * ndim if isinstance(padding, int) else tuple(padding)
    if output_size is None:
        out_spatial = tuple((int(si) - 1) * s - 2 * p + k for si, s, k, p in
                            zip(x.shape[2:], st, ks, pd))
    else:
        out_spatial = tuple(int(s) for s in output_size[-ndim:])
    return _op("max_unpool", x, indices, out_spatial=out_spatial)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 3)


# -------------------------------------------------------------------- losses

def _dice_fwd(iv, lv, epsilon=1e-5):
    onehot = TF.one_hot(lv[..., 0].long(), iv.shape[-1]).to(iv.dtype)
    dims = tuple(range(1, iv.dim()))
    inter = torch.sum(iv * onehot, dim=dims)
    union = torch.sum(iv, dim=dims) + torch.sum(onehot, dim=dims)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


register_op("dice_loss", _dice_fwd)


def dice_loss(input, label, epsilon=1e-5, name=None):
    return _op("dice_loss", input, label, epsilon=float(epsilon))


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree (the
    reference's non-custom-tree mode); gradients reach input, weight and
    bias."""
    return _op("hsigmoid_loss", input, label, weight, bias,
               num_classes=int(num_classes))


def _hsigmoid_fwd(iv, lv, wv, bv=None, num_classes=2):
    # leaves at [num_classes, 2 * num_classes); internal node k is weight
    # row k - 1
    node = lv.reshape(-1).long() + num_classes
    losses = []
    for _ in range(int(math.ceil(math.log2(max(num_classes, 2))))):
        parent = node // 2
        bit = (node & 1).to(iv.dtype)
        row = torch.clamp(parent - 1, 0, wv.shape[0] - 1)
        valid = (parent >= 1).to(iv.dtype)
        logits = torch.sum(iv * wv[row], dim=-1)
        if bv is not None:
            logits = logits + bv.reshape(-1)[row]
        losses.append(valid * (torch.clamp_min(logits, 0) - logits * bit
                               + torch.log1p(torch.exp(-logits.abs()))))
        node = parent
    return torch.stack(losses).sum(0).mean()


register_op("hsigmoid_loss", _hsigmoid_fwd)


def _npair_fwd(a, p, lv, l2_reg=0.002):
    sim = a @ p.t()
    lv = lv.reshape(-1)
    same = (lv[:, None] == lv[None, :]).to(a.dtype)
    same = same / torch.clamp_min(same.sum(-1, keepdim=True), 1)
    xent = -torch.sum(same * torch.log_softmax(sim, -1), dim=-1).mean()
    return xent + l2_reg * (torch.sum(a * a) + torch.sum(p * p)) \
        / (2 * a.shape[0])


register_op("npair_loss", _npair_fwd)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    return _op("npair_loss", anchor, positive, labels, l2_reg=float(l2_reg))


def _margin_ce_fwd(lv, yv, margin1=1.0, margin2=0.5, margin3=0.0,
                   scale=64.0, reduction="mean"):
    yv = yv.reshape(-1).long()
    cos = torch.clamp(lv, -1.0 + 1e-6, 1.0 - 1e-6)
    tgt = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    onehot = TF.one_hot(yv, lv.shape[-1]).to(lv.dtype)
    logp = torch.log_softmax(scale * (onehot * tgt + (1 - onehot) * cos), -1)
    per = -logp.gather(1, yv[:, None])[:, 0]
    return _reduce(per, reduction), torch.exp(logp)


register_op("margin_cross_entropy", _margin_ce_fwd)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0,
                         scale=64.0, group=None, return_softmax=False,
                         reduction="mean"):
    """ArcFace-family margin softmax: the loss (and the softmax with
    ``return_softmax``)."""
    loss, probs = _op("margin_cross_entropy", logits, label,
                      margin1=float(margin1), margin2=float(margin2),
                      margin3=float(margin3), scale=float(scale),
                      reduction=reduction)
    return (loss, probs) if return_softmax else loss


def _ctc_fwd(logits, labels, input_lengths, label_lengths, blank=0):
    """The negative log-likelihood of each sequence: the alpha recursion
    over the extended labels (blank, l1, blank, l2, ..., blank) in log
    space, one step a frame; a sample past its input length keeps its
    alpha."""
    log_probs = torch.log_softmax(logits, -1)
    T, B, _ = log_probs.shape
    dev = logits.device
    S = 2 * labels.shape[1] + 1
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long().to(dev)
    emit = log_probs.transpose(0, 1).gather(
        2, ext[:, None, :].expand(B, T, S))                # [B, T, S]
    skip_ok = torch.cat([torch.zeros(B, 2, dtype=torch.bool, device=dev),
                         ext[:, 2:] != ext[:, :-2]], 1)[:, :S]
    col = torch.arange(S, device=dev)
    alpha = torch.where(col <= (1 if S > 1 else 0), emit[:, 0], _NEG)
    lengths = input_lengths.to(dev)
    pad = torch.full((B, 2), _NEG, dtype=alpha.dtype, device=dev)
    for t in range(1, T):
        prev1 = torch.cat([pad[:, :1], alpha], 1)[:, :S]
        prev2 = torch.where(skip_ok, torch.cat([pad, alpha], 1)[:, :S], _NEG)
        new = torch.logaddexp(alpha, torch.logaddexp(prev1, prev2)) \
            + emit[:, t]
        alpha = torch.where((t < lengths)[:, None], new, alpha)
    lab = label_lengths.to(dev).long()
    last = 2 * lab
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, torch.clamp_min(last - 1, 0)[:, None])[:, 0]
    return -torch.logaddexp(a_last, torch.where(lab > 0, a_prev, _NEG))


register_op("ctc_loss", _ctc_fwd)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over raw logits ``[T, B, V]`` (the module's docstring says how
    it differs from torch's); ``norm_by_times`` is not read."""
    per = _op("ctc_loss", log_probs, labels, input_lengths, label_lengths,
              blank=int(blank))
    if reduction == "mean":
        lens = torch.as_tensor(label_lengths).to(per.device)
        return (per / torch.clamp_min(lens.float(), 1.0)).mean()
    return _reduce(per, reduction)


def _rnnt_fwd(raw, labels, input_lengths, label_lengths, blank=0):
    """The transducer's negative log-likelihood over the (T, U + 1)
    lattice: at each frame the label moves (a prefix recursion over u),
    then the frame's blank; a sample past its input length keeps its
    row."""
    logits = torch.log_softmax(raw, -1)
    B, T, U1, _ = logits.shape
    U = U1 - 1
    dev = raw.device
    blank_lp = logits[..., blank]                              # [B, T, U+1]
    lab_lp = logits[:, :, :U, :].gather(
        3, labels.long().to(dev)[:, None, :, None].expand(B, T, U, 1))[..., 0]
    lab_lp = torch.cat([lab_lp, torch.full((B, T, 1), _NEG, dtype=raw.dtype,
                                           device=dev)], 2)
    alpha = torch.where(torch.arange(U1, device=dev) == 0, 0.0,
                        _NEG).to(raw.dtype).expand(B, U1)
    neg = torch.full((B,), _NEG, dtype=raw.dtype, device=dev)
    lengths = input_lengths.to(dev)
    for t in range(T):
        prev, cols = neg, []
        for u in range(U1):
            prev = torch.logaddexp(alpha[:, u], prev + lab_lp[:, t, u - 1]
                                   if u > 0 else neg)
            cols.append(prev)
        row = torch.stack(cols, 1) + blank_lp[:, t]
        alpha = torch.where((t < lengths)[:, None], row, alpha)
    return -alpha.gather(1, label_lengths.long().to(dev)[:, None])[:, 0]


register_op("rnnt_loss", _rnnt_fwd)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """The transducer loss over raw logits ``[B, T, U + 1, V]``;
    ``fastemit_lambda`` is not read."""
    per = _op("rnnt_loss", input, label, input_lengths, label_lengths,
              blank=int(blank))
    return _reduce(per, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    from ...ops import maximum, minimum
    dfn = distance_function or pairwise_distance
    d_pos = dfn(input, positive)
    d_neg = dfn(input, negative)
    if swap:
        d_neg = minimum(d_neg, dfn(positive, negative))
    gap = d_pos - d_neg + margin
    return _reduce(maximum(gap, torch.zeros_like(gap)), reduction)


def _multi_margin_fwd(iv, yv, weight=None, p=1, margin=1.0,
                      reduction="mean"):
    yv = yv.reshape(-1).long()
    gold = iv.gather(1, yv[:, None])
    m = torch.clamp_min(margin - gold + iv, 0) ** p
    m = m.scatter(1, yv[:, None], 0.0)
    if weight is not None:
        m = m * weight[yv][:, None]
    return _reduce(m.sum(-1) / iv.shape[1], reduction)


register_op("multi_margin_loss", _multi_margin_fwd)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    return _op("multi_margin_loss", input, label, weight, p=int(p),
               margin=float(margin), reduction=reduction)


# --------------------------------------------------------- spatial sampling

def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The ``[N, H, W, 2]`` sampling grid of the affine maps ``theta``
    ``[N, 2, 3]``; ``theta`` gets a gradient."""
    _, _, h, w = [int(s) for s in out_shape]
    return _op("affine_grid", theta, out_hw=(h, w),
               align_corners=bool(align_corners))


def _affine_grid_fwd(tv, out_hw=(1, 1), align_corners=True):
    h, w = out_hw

    def coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, dtype=tv.dtype,
                                  device=tv.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                              dtype=tv.dtype, device=tv.device)

    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(-1, 3)
    return torch.einsum("nij,pj->npi", tv, base).reshape(tv.shape[0], h, w, 2)


register_op("affine_grid", _affine_grid_fwd)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` ``[N, C, H, W]`` at ``grid`` ``[N, Hg, Wg, 2]``
    (x, y in [-1, 1]); gradients reach both ``x`` and ``grid``."""
    return _op("grid_sample", x, grid, mode=str(mode),
               padding_mode=str(padding_mode),
               align_corners=bool(align_corners))


def _grid_sample_fwd(xv, gv, mode="bilinear", padding_mode="zeros",
                     align_corners=True):
    n, c, h, w = xv.shape
    hg, wg = gv.shape[1], gv.shape[2]

    def unnormalize(coord, size):
        if align_corners:
            return (coord + 1) * (size - 1) / 2
        return ((coord + 1) * size - 1) / 2

    px, py = unnormalize(gv[..., 0], w), unnormalize(gv[..., 1], h)
    if padding_mode == "reflection":
        # a triangular wave about [0, size - 1]
        px = (w - 1) - ((w - 1) - torch.remainder(px.abs(),
                                                  2 * max(w - 1, 1))).abs()
        py = (h - 1) - ((h - 1) - torch.remainder(py.abs(),
                                                  2 * max(h - 1, 1))).abs()
    flat = xv.reshape(n, c, h * w)

    def fetch(yy, xx):
        yc, xc = yy.clamp(0, h - 1), xx.clamp(0, w - 1)
        idx = (yc * w + xc).reshape(n, 1, hg * wg).expand(n, c, hg * wg)
        v = flat.gather(2, idx).reshape(n, c, hg, wg)
        if padding_mode == "zeros":
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            return torch.where(inside[:, None], v, 0.0)
        return v                             # border, reflection: clamped

    if mode == "nearest":                    # half to even, as jnp.round
        return fetch(torch.round(py).long(), torch.round(px).long())
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = (px - x0)[:, None], (py - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    return (fetch(y0, x0) * ((1 - fx) * (1 - fy))
            + fetch(y0, x0 + 1) * (fx * (1 - fy))
            + fetch(y0 + 1, x0) * ((1 - fx) * fy)
            + fetch(y0 + 1, x0 + 1) * (fx * fy))


register_op("grid_sample", _grid_sample_fwd)


# ------------------------------------------------------------- misc utilities

def gather_tree(ids, parents):
    """Beam-search backtrace: ``ids`` / ``parents`` ``[T, B, beam]`` ->
    the full sequences, following the parent pointers from the last
    step."""
    iv, pv = torch.as_tensor(ids), torch.as_tensor(parents).long()
    beam = torch.arange(iv.shape[2], device=iv.device).expand(
        iv.shape[1:]).contiguous()
    toks = []
    for t in range(iv.shape[0] - 1, -1, -1):
        toks.append(iv[t].gather(-1, beam))
        beam = pv[t].gather(-1, beam)
    return wrap_outputs(torch.stack(toks[::-1]))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    return _op("temporal_shift", x, seg_num=int(seg_num),
               shift_ratio=float(shift_ratio))


def _temporal_shift_fwd(xv, seg_num=1, shift_ratio=0.25):
    nt, c, h, w = xv.shape
    v = xv.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([v[:, 1:, :fold], torch.zeros_like(v[:, :1, :fold])], 1)
    right = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                       v[:, :-1, fold:2 * fold]], 1)
    return torch.cat([left, right, v[:, :, 2 * fold:]], 2).reshape(nt, c, h,
                                                                   w)


register_op("temporal_shift", _temporal_shift_fwd)


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """Block-sparse attention on ``[B, H, L, D]``: the CSR pattern becomes
    a dense additive mask (0 where a column is listed, -1e9 elsewhere) for
    the port's ``scaled_dot_product_attention``, as in the JAX package,
    which builds it on the host; here it is built on ``query``'s device
    (each listed column's row found by ``searchsorted`` over the offsets,
    then one scatter). ``key_padding_mask`` and ``attn_mask`` are taken
    and not read, as in the JAX package."""
    from .attention import scaled_dot_product_attention
    B, H, L, _ = query.shape
    dev = query.device
    off = torch.as_tensor(sparse_csr_offset, device=dev).long()
    cols = torch.as_tensor(sparse_csr_columns, device=dev).long()
    nnz = cols.shape[-1]
    j = torch.arange(nnz, device=dev).expand(B, H, nnz).contiguous()
    row = torch.searchsorted(off[..., 1:].contiguous(), j, right=True)
    # a column past the last row's end is in no row: it lands in a spare
    # slot that is cut off
    listed = (j >= off[..., :1]) & (row < L)
    flat = torch.where(listed, row * L + cols, L * L)
    hit = torch.zeros(B, H, L * L + 1, dtype=torch.bool, device=dev)
    hit.scatter_(2, flat, True)
    mask = torch.where(hit[..., :L * L].reshape(B, H, L, L),
                       torch.zeros((), dtype=query.dtype, device=dev),
                       torch.full((), -1e9, dtype=query.dtype, device=dev))
    swap = (lambda t: t.transpose(1, 2))
    out = scaled_dot_product_attention(swap(query), swap(key), swap(value),
                                       attn_mask=mask)
    return swap(out)


# ----------------------------------------------------------- inplace variants

register_op("elu_", lambda x, alpha=1.0: x.copy_(TF.elu(x, alpha)))
register_op("softmax_", lambda x, axis=-1: x.copy_(torch.softmax(x, axis)))
register_op("tanh_", lambda x: x.copy_(torch.tanh(x)))


def elu_(x, alpha=1.0, name=None):
    """ELU written into ``x``; returns ``x``."""
    return _op("elu_", x, alpha=float(alpha))


def softmax_(x, axis=-1, dtype=None, name=None):
    return _op("softmax_", x, axis=int(axis))


def tanh_(x, name=None):
    return _op("tanh_", x)
