"""Sequence-length bucketing: the variable-length policy for a static-shape
compiler (counterpart of ``paddle_tpu/io/bucketing.py``).

Reference analog: the LoD (level-of-detail) world — `phi/core/dense_tensor.h:38`
LoD metadata, `fluid/operators/sequence_ops/` and the DataLoader's per-batch
padding. The reference tolerates ragged tensors at runtime; XLA compiles one
executable per shape, so unconstrained raggedness means a recompile per new
sequence length. The TPU-native policy is a CONTRACT instead:

1. **Bucket**: every batch is padded up to the smallest boundary in
   `boundaries` that fits its longest sequence — so an entire workload
   compiles at most `len(boundaries)` executables per program (in the
   port the captured ``TrainStep`` holds one program, a CUDA graph, per
   input signature: ``TrainStep.num_compiles``).
2. **Pad right**: sequences are padded at the END. For causal decoders this
   makes padded numerics EXACT: position ids of real tokens are unchanged and
   causal attention never lets a real token attend to a pad.
3. **Mask**: pad label positions carry `label_pad` (default -100, the
   cross_entropy/lm_head_ce `ignore_index`), so the loss ignores them; for
   bidirectional models `padding_attn_mask(lengths, L)` builds the additive
   attention mask that hides pad KEYS from every query.

Taken together: a causal-LM batch of any length mix trains with numerics
identical to per-sequence unpadded runs (dropout off), while compiling a
bounded, reusable set of executables. The padded arrays come back as CPU
``Tensor``s (the collated batch's form, ``io.dataloader``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import torch

from ..core.tensor import Tensor
from .dataloader import host_tensor

__all__ = ["DEFAULT_BOUNDARIES", "bucket_length", "pad_to_bucket",
           "padding_attn_mask", "BucketingCollate",
           "LengthGroupedBatchSampler"]

DEFAULT_BOUNDARIES: Tuple[int, ...] = (128, 256, 512, 1024)


def bucket_length(length: int, boundaries: Sequence[int] = DEFAULT_BOUNDARIES
                  ) -> int:
    """Smallest boundary >= length. Raises if length exceeds every boundary —
    silently growing would leak unbounded executable counts, the exact failure
    mode this module exists to prevent."""
    for b in sorted(boundaries):
        if length <= b:
            return int(b)
    raise ValueError(
        f"sequence length {length} exceeds the largest bucket boundary "
        f"{max(boundaries)}; add a boundary or truncate the input")


def pad_to_bucket(seqs, boundaries: Sequence[int] = DEFAULT_BOUNDARIES,
                  pad_value=0, dtype=None):
    """Pad a list of 1-D sequences to their common bucket.

    Returns (padded [B, L_bucket] ndarray, lengths [B] int32 ndarray).
    """
    if not len(seqs):
        raise ValueError("pad_to_bucket: empty batch")
    arrs = [np.asarray(s) for s in seqs]
    lengths = np.asarray([a.shape[0] for a in arrs], np.int32)
    L = bucket_length(int(lengths.max()), boundaries)
    dt = dtype or arrs[0].dtype
    out = np.full((len(arrs), L), pad_value, dtype=dt)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0]] = a
    return out, lengths


def padding_attn_mask(lengths, max_len: int, dtype="float32") -> Tensor:
    """Additive attention mask [B, 1, 1, L]: 0 where the KEY position is real,
    -1e9 where it is padding. Broadcasts over heads and query positions;
    combine with a causal mask by addition. Convention shared by
    nn.functional.scaled_dot_product_attention's `attn_mask` argument."""
    ln = np.asarray(lengths.detach().cpu().numpy()
                    if isinstance(lengths, torch.Tensor) else lengths)
    valid = np.arange(max_len)[None, :] < ln[:, None]
    mask = np.where(valid, 0.0, -1e9).astype(dtype)
    return host_tensor(mask[:, None, None, :])


class BucketingCollate:
    """DataLoader collate_fn implementing the bucketing contract.

    Samples are tuples of same-length 1-D arrays (e.g. ``(ids, labels)``) or a
    single 1-D array. Every field is padded to the batch's common bucket;
    field ``i`` pads with ``pad_values[i]`` (labels default to -100 so the
    loss ignores pad positions). The batch comes back as
    ``(*padded_fields, lengths)`` — models that don't need lengths ignore the
    last element; encoders turn it into a mask via `padding_attn_mask`.
    """

    def __init__(self, boundaries: Sequence[int] = DEFAULT_BOUNDARIES,
                 pad_values: Sequence = (0, -100),
                 return_lengths: bool = True):
        self.boundaries = tuple(boundaries)
        self.pad_values = tuple(pad_values)
        self.return_lengths = return_lengths

    def __call__(self, batch):
        first = batch[0]
        fields = list(zip(*batch)) if isinstance(first, (tuple, list)) \
            else [batch]
        padded = []
        lengths = None
        for i, field in enumerate(fields):
            pv = self.pad_values[i] if i < len(self.pad_values) \
                else self.pad_values[-1]
            arr, ln = pad_to_bucket(field, self.boundaries, pad_value=pv)
            padded.append(host_tensor(arr))
            if lengths is None:
                lengths = ln
        if self.return_lengths:
            padded.append(host_tensor(lengths))
        return padded if len(padded) > 1 else padded[0]


class LengthGroupedBatchSampler:
    """Batch sampler that groups similar lengths to cut padding waste.

    Shuffles a window of `window_mult * batch_size` indices, sorts the window
    by length, carves batches, then shuffles batch order — the standard
    bucketing sampler (reference recipes do this in user code over LoD
    readers). `lengths` may be a list or a callable(index)->int.
    """

    def __init__(self, lengths, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, window_mult: int = 50, seed=None):
        if callable(lengths):
            raise TypeError("pass the materialized lengths list; computing "
                            "them lazily would re-read the dataset every epoch")
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.window = max(window_mult * batch_size, batch_size)
        self._rng = np.random.RandomState(seed)

    def __iter__(self):
        n = len(self.lengths)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        batches = []
        for w0 in range(0, n, self.window):
            win = order[w0:w0 + self.window]
            win = win[np.argsort(self.lengths[win], kind="stable")]
            for b0 in range(0, len(win), self.batch_size):
                b = win[b0:b0 + self.batch_size]
                if len(b) < self.batch_size and self.drop_last:
                    continue
                batches.append(b.tolist())
        if self.shuffle:
            self._rng.shuffle(batches)
        return iter(batches)

    def __len__(self):
        if self.drop_last:
            return len(self.lengths) // self.batch_size
        return (len(self.lengths) + self.batch_size - 1) // self.batch_size
