"""Metrics (counterpart of ``paddle_tpu/metric``; reference:
python/paddle/metric/metrics.py). Host numpy, as in the JAX package: the
inputs may be numpy arrays or tensors on any device (read back to the
host), and ``Accuracy.compute`` / ``accuracy`` return CPU ``Tensor``s."""
from __future__ import annotations

import numpy as np
import torch

from ..io.dataloader import host_tensor


def _np(x) -> np.ndarray:
    """A metric input on the host (a tensor read back, bf16 as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np.squeeze(-1)
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        correct = topk_idx == label_np[..., None]
        return host_tensor(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num = c[..., :k].sum()
            tot = c.shape[0] if c.ndim > 1 else len(c)
            self.total[i] += num
            self.count[i] += tot
            accs.append(float(num) / max(tot, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_cls = (p > 0.5).astype(np.int32).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_cls == 1) & (l == 1)).sum())
        self.fp += int(((pred_cls == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_cls = (p > 0.5).astype(np.int32).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_cls == 1) & (l == 1)).sum())
        self.fn += int(((pred_cls == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels).reshape(-1)
        pos_prob = p[:, 1] if p.ndim == 2 and p.shape[1] == 2 else p.reshape(-1)
        bins = np.round(pos_prob * self.num_thresholds).astype(int)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            auc += self._stat_neg[i] * (tot_pos + self._stat_pos[i] / 2.0)
            tot_pos += self._stat_pos[i]
            tot_neg += self._stat_neg[i]
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    pred = _np(input)
    lbl = _np(label)
    if lbl.ndim == 2 and lbl.shape[1] == 1:
        lbl = lbl[:, 0]
    topk = np.argsort(-pred, axis=-1)[:, :k]
    acc = float((topk == lbl[:, None]).any(axis=1).mean())
    return host_tensor(np.asarray(acc, np.float32))
