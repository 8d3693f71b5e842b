"""Layers closing the nn surface (counterpart of
``paddle_tpu/nn/layers_extended.py``): distance and margin losses, CTC
and RNN-T, unpooling, ``SpectralNorm``, and beam-search decoding
(``BeamSearchDecoder`` with ``dynamic_decode``, a host loop as in the JAX
package).

``SpectralNorm`` returns ``weight / sigma`` with sigma from the power
iteration on ``weight_u`` / ``weight_v`` (updated in place each call, as
the JAX layer's are). The JAX layer wraps its output in a new Tensor,
which cuts the tape, so no gradient reaches ``weight`` there; the port
keeps autograd's gradient through the power iteration and sigma."""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import wrap_outputs
from . import functional as F
from .layer import Layer

__all__ = ["PairwiseDistance", "Softmax2D", "CTCLoss", "RNNTLoss",
           "HSigmoidLoss", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
           "MultiMarginLoss", "TripletMarginWithDistanceLoss", "SpectralNorm",
           "BeamSearchDecoder", "dynamic_decode"]


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Softmax2D(Layer):
    """Softmax over the channel axis of NCHW inputs."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           blank=self.blank, reduction=self.reduction)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = self.create_parameter([num_classes - 1, feature_size])
        self.bias = self.create_parameter([num_classes - 1, 1], is_bias=True) \
            if bias_attr is not False else None

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias)


class MaxUnPool1D(Layer):
    _fn = staticmethod(F.max_unpool1d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__()
        self._a = (kernel_size, stride, padding, output_size)

    def forward(self, x, indices):
        k, s, p, o = self._a
        return self._fn(x, indices, k, s, p, output_size=o)


class MaxUnPool2D(MaxUnPool1D):
    _fn = staticmethod(F.max_unpool2d)


class MaxUnPool3D(MaxUnPool1D):
    _fn = staticmethod(F.max_unpool3d)


class MultiMarginLoss(Layer):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__()
        self._a = (p, margin, weight, reduction)

    def forward(self, input, label):
        p, m, w, r = self._a
        return F.multi_margin_loss(input, label, p, m, w, r)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._a = (distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):
        d, m, s, r = self._a
        return F.triplet_margin_with_distance_loss(input, positive, negative,
                                                   d, m, s, r)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma the largest singular value of ``weight``
    (moved so ``dim`` leads, flattened to 2-D) estimated by
    ``power_iters`` steps of the power iteration from ``weight_u`` /
    ``weight_v`` (seeded with numpy seeds 0 and 1, as in the JAX package;
    not trained). Each call writes the iteration's u and v back."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter([h])
        self.weight_u.set_value(np.random.RandomState(0).randn(h).astype(
            dtype))
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter([w])
        self.weight_v.set_value(np.random.RandomState(1).randn(w).astype(
            dtype))
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        mat = torch.movedim(weight, self.dim, 0).reshape(
            weight.shape[self.dim], -1)
        # copies: the backward reads the u and v it started from
        u, v = self.weight_u.detach().clone(), self.weight_v.detach().clone()
        for _ in range(self.power_iters):
            v = mat.t() @ u
            v = v / (torch.linalg.vector_norm(v) + self.eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self.eps)
        sigma = u @ mat @ v
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return weight / sigma


class BeamSearchDecoder:
    """Beam decoding over a cell: each step scores ``log_softmax(
    output_fn(cell_out))`` (the JAX package's simplified decoder)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _tree_map(fn, *trees):
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tree_map(fn, *parts) for parts in
                              zip(*trees))
    return fn(*trees)


@torch.no_grad()
def dynamic_decode(decoder: BeamSearchDecoder, inits=None, max_step_num=32,
                   **kwargs):
    """Beam search (a host loop, as in the JAX package): ``beam`` calls of
    the cell a step, the candidates ranked on the host with numpy; each
    batch element follows its own source beam's state. Returns ``(ids
    [B, beam, T], scores [B, beam])``."""
    cell, beam = decoder.cell, decoder.beam_size
    first = _leaves(inits)[0]
    B, dev = int(first.shape[0]), first.device
    tokens = np.full((B, beam), decoder.start_token, np.int64)
    scores = np.zeros((B, beam), np.float64)
    scores[:, 1:] = -1e9                 # every beam starts from the root
    states = [inits] * beam
    finished = np.zeros((B, beam), bool)
    rows = np.arange(B)[:, None]
    out_ids = []
    for _ in range(max_step_num):
        cand_scores, cand_states = [], []
        for b in range(beam):
            inp = wrap_outputs(torch.from_numpy(tokens[:, b].copy()).to(dev))
            if decoder.embedding_fn is not None:
                inp = decoder.embedding_fn(inp)
            out, new_state = cell(inp, states[b])
            logits = decoder.output_fn(out) if decoder.output_fn else out
            logp = torch.log_softmax(logits, -1).float().cpu().numpy()
            cand_scores.append(scores[:, b:b + 1]
                               + np.where(finished[:, b:b + 1], 0.0, logp))
            cand_states.append(new_state)
        V = cand_scores[0].shape[-1]
        allc = np.concatenate(cand_scores, axis=1)         # [B, beam * V]
        top = np.argsort(-allc, axis=1)[:, :beam]
        scores = np.take_along_axis(allc, top, axis=1)
        src = top // V
        tokens = np.where(finished[rows, src], decoder.end_token,
                          (top % V).astype(np.int64))
        finished = finished[rows, src] | (tokens == decoder.end_token)

        def pick_states(b):
            return _tree_map(lambda *leaves: torch.stack(
                [leaves[int(src[i, b])][i] for i in range(B)]), *cand_states)
        states = [pick_states(b) for b in range(beam)]
        out_ids.append(tokens.copy())
        if finished.all():
            break
    ids = np.stack(out_ids, axis=-1)                       # [B, beam, T]
    return (wrap_outputs(torch.from_numpy(ids).to(dev)),
            wrap_outputs(torch.from_numpy(scores.astype(np.float32)).to(
                dev)))
