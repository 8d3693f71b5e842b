"""The port's ``io`` (datasets, samplers, ``DataLoader``, bucketing,
``stack_microbatches``, ``DeviceLoader``) and ``metric`` against the JAX
package on the CPU.

Data goes in as numpy. Batch order is the same index lists under one
numpy seed (both packages draw from numpy alike). Collated values are
compared exactly: the port's batches are CPU tensors, the JAX package's
its Tensors (whose int64 is int32: the values are held, not the types).
Metrics agree to 1e-12 (both compute in numpy on the same arrays).
``DeviceLoader(device="cpu")`` is the port's host path; its card path
(side stream, events) runs in ``chip_smoke.py`` ``[hapi-*]``."""
import collections
import gc
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from _torch_op_parity import _on_cpu  # noqa: F401

METRIC_TOL = 1e-12


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x.numpy()) if hasattr(x, "numpy") else np.asarray(x)


def _same(a, b):
    """Nested batches hold the same values (types aside)."""
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b.astype(a.dtype))


def _both(make, seed=7):
    """``make(pkg)`` iterated under numpy seed ``seed`` in each package."""
    out = []
    for pkg in (jp, tp):
        np.random.seed(seed)
        out.append(list(make(pkg)))
    return out


class _Squares:
    """A plain map-style dataset: (x, x^2) of float rows and int labels."""

    def __init__(self, n=23):
        self.x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        self.y = np.arange(n, dtype=np.int64) % 4

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


SAMPLERS = {
    "sequence": lambda pkg: pkg.io.SequenceSampler(range(9)),
    "random": lambda pkg: pkg.io.RandomSampler(range(17)),
    "random_replacement": lambda pkg: pkg.io.RandomSampler(
        range(17), replacement=True, num_samples=30),
    "weighted": lambda pkg: pkg.io.WeightedRandomSampler(
        [0.1, 0.5, 0.2, 0.2], 12),
    "batch_shuffle_drop_last": lambda pkg: pkg.io.BatchSampler(
        range(23), shuffle=True, batch_size=5, drop_last=True),
    "batch_keep_last": lambda pkg: pkg.io.BatchSampler(
        range(23), batch_size=5),
    "batch_over_sampler": lambda pkg: pkg.io.BatchSampler(
        sampler=pkg.io.RandomSampler(range(11)), batch_size=4),
}


@pytest.mark.parametrize("case", sorted(SAMPLERS))
def test_sampler_order_matches_jax(case):
    want, got = _both(SAMPLERS[case])
    assert got == want
    assert len(SAMPLERS[case](tp)) == len(SAMPLERS[case](jp))


@pytest.mark.parametrize("shuffle,drop_last,epoch", [
    (False, False, 0), (True, False, 0), (True, True, 3)])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last, epoch):
    """Explicit ranks of 3: each rank's batches as the JAX sampler's, and
    the ranks together cover the padded index set."""
    seen = []
    for rank in range(3):
        out = []
        for pkg in (jp, tp):
            s = pkg.io.DistributedBatchSampler(
                list(range(22)), batch_size=3, num_replicas=3, rank=rank,
                shuffle=shuffle, drop_last=drop_last)
            s.set_epoch(epoch)
            out.append((list(s), len(s)))
        assert out[1] == out[0]
        seen += [i for b in out[1][0] for i in b]
    if not drop_last:
        assert sorted(set(seen)) == list(range(22)) and len(seen) == 24


def test_distributed_batch_sampler_defaults_to_one_process():
    s = tp.io.DistributedBatchSampler(list(range(10)), batch_size=4)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert list(s) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


LOADERS = {
    "plain": dict(batch_size=4),
    "shuffle_drop_last": dict(batch_size=5, shuffle=True, drop_last=True),
    "threads": dict(batch_size=4, shuffle=True, num_workers=2),
    "batch_sampler": "sampler",
    "no_batching": dict(batch_size=None),
}


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_dataloader_batches_match_jax(case):
    """The same batches, in the same order, as the JAX ``DataLoader``;
    the port's are CPU tensors."""
    kw = LOADERS[case]

    def make(pkg):
        if kw == "sampler":
            return pkg.io.DataLoader(_Squares(), batch_sampler=pkg.io
                                     .BatchSampler(range(23), shuffle=True,
                                                   batch_size=6))
        return pkg.io.DataLoader(_Squares(), **kw)
    want, got = _both(make)
    assert len(got) == len(want) == len(make(tp))
    for g, w in zip(got, want):
        _same(g, w)
    leaves = [t for b in got for t in (b if isinstance(b, (list, tuple))
                                       else [b])]
    assert all(isinstance(t, (np.ndarray, np.generic)) or (
        isinstance(t, tp.Tensor) and t.device.type == "cpu")
        for t in leaves)


def test_dataloader_process_workers_and_iterable_datasets():
    """Forked process workers (numpy-only dataset, the parent collates)
    give the thread workers' batches; an ``IterableDataset`` batches
    alike in both packages and shards by ``get_worker_info``."""
    base = tp.io.DataLoader(_Squares(), batch_size=4)
    forked = tp.io.DataLoader(_Squares(), batch_size=4, num_workers=2,
                              use_process_workers=True)
    for g, w in zip(list(forked), list(base)):
        _same(g, w)

    def stream(pkg):
        class Stream(pkg.io.IterableDataset):
            def __iter__(self):
                info = pkg.io.get_worker_info()
                lo, step = (0, 1) if info is None else (info.id,
                                                        info.num_workers)
                for i in range(lo, 10, step):
                    yield np.float32(i)
        return Stream()
    want, got = _both(lambda pkg: pkg.io.DataLoader(stream(pkg),
                                                     batch_size=4))
    for g, w in zip(got, want):
        _same(g, w)
    parts = list(tp.io.DataLoader(stream(tp), batch_size=4, num_workers=2,
                                  use_process_workers=True))
    assert sorted(float(v) for b in parts for v in _np(b)) == \
        [float(i) for i in range(10)]


def test_datasets_match_jax():
    """``TensorDataset``, ``ComposeDataset``, ``ConcatDataset``,
    ``Subset``, ``ChainDataset`` and ``random_split`` (numpy's generator)
    index as the JAX ones."""
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = np.arange(6, dtype=np.int64)
    sets = [(pkg.io.TensorDataset([x, y]),
             pkg.io.ComposeDataset([pkg.io.TensorDataset([x]),
                                    pkg.io.TensorDataset([y])]),
             pkg.io.ConcatDataset([pkg.io.TensorDataset([x]),
                                   pkg.io.TensorDataset([x * 2])]),
             pkg.io.Subset(pkg.io.TensorDataset([y]), [5, 1, 3]))
            for pkg in (jp, tp)]
    for a, b in zip(*sets):
        assert len(a) == len(b)
        for i in list(range(len(a))) + [-1]:
            _same(list(b[i]), list(a[i]))
    chain = tp.io.ChainDataset([[1, 2], [3]])
    assert [v for v in chain] == [1, 2, 3]
    want, got = _both(lambda pkg: [list(s.indices) for s in
                                   pkg.io.random_split(range(10), [7, 3])])
    assert got == want
    with pytest.raises(ValueError):
        tp.io.random_split(range(10), [4, 4])


def test_default_collate_fn_matches_jax():
    """Nested tuples, dicts, numpy rows, Python ints and floats and
    tensors: the JAX collate's values, as CPU tensors."""
    samples = [({"a": np.full(3, i, np.float32), "b": i}, float(i) / 2,
                np.int64(i)) for i in range(4)]
    want = jp.io.default_collate_fn(samples)
    got = tp.io.default_collate_fn(samples)
    _same(got, want)
    assert got[0]["b"].dtype == torch.int64 and \
        got[1].dtype == torch.float32
    t = tp.io.default_collate_fn([tp.to_tensor([1.0, 2.0])] * 3)
    assert isinstance(t, tp.Tensor) and tuple(t.shape) == (3, 2)


def test_bucketing_matches_jax():
    """``bucket_length``, ``pad_to_bucket``, ``BucketingCollate`` (through
    ``DataLoader(bucket_boundaries=...)``), ``padding_attn_mask`` and a
    seeded ``LengthGroupedBatchSampler``: the JAX arrays and order."""
    for length in (1, 128, 129, 700):
        assert tp.io.bucket_length(length) == jp.io.bucket_length(length)
    with pytest.raises(ValueError, match="exceeds the largest"):
        tp.io.bucket_length(2000)
    r = np.random.default_rng(0)
    seqs = [r.integers(1, 50, int(n)) for n in r.integers(5, 40, 12)]
    _same(list(tp.io.pad_to_bucket(seqs, (8, 16, 32, 64))),
          list(jp.io.pad_to_bucket(seqs, (8, 16, 32, 64))))
    pairs = [(s, s + 1) for s in seqs]
    got, want = (list(pkg.io.DataLoader(pairs, batch_size=5,
                                        bucket_boundaries=(16, 32, 64)))
                 for pkg in (tp, jp))
    for g, w in zip(got, want):
        _same(g, w)
    _same(tp.io.padding_attn_mask(tp.to_tensor([3, 5]), 6),
          jp.io.padding_attn_mask(jp.to_tensor([3, 5]), 6))
    lengths = [len(s) for s in seqs] * 5
    got, want = (list(pkg.io.LengthGroupedBatchSampler(
        lengths, batch_size=4, window_mult=3, seed=11, drop_last=True))
        for pkg in (tp, jp))
    assert got == want
    assert len(tp.io.LengthGroupedBatchSampler(lengths, 4)) == 15


def test_stack_microbatches_and_stacked_device_loader_match_jax():
    """``stack_microbatches`` of nested batches and
    ``DeviceLoader(stack_batches=3, device="cpu")`` over the 11 batches
    of 2 of a 23-sample loader: the JAX windows, the partial one
    dropped."""
    batches = [([np.full((2, 3), i, np.float32)], {"y": np.arange(2) + i})
               for i in range(3)]
    _same(list(tp.io.stack_microbatches(batches)),
          list(jp.io.stack_microbatches(batches)))
    host = tp.io.stack_microbatches([tp.to_tensor(np.ones(2) * i)
                                     for i in range(3)])
    assert isinstance(host, tp.Tensor) and tuple(host.shape) == (3, 2)

    def make(pkg):
        kw = {"device": "cpu"} if pkg is tp else {}
        return pkg.io.DeviceLoader(pkg.io.DataLoader(_Squares(),
                                                     batch_size=2,
                                                     drop_last=True),
                                   stack_batches=3, **kw)
    want, got = _both(make)
    assert len(got) == len(want) == len(make(tp)) == 3
    for g, w in zip(got, want):
        _same(g, w)
        assert tuple(g[0].shape) == (3, 2, 3)


def test_device_loader_cpu_passes_nested_and_namedtuple_batches():
    Pair = collections.namedtuple("Pair", "x y")
    src = [Pair(np.ones(2, np.float32) * i, {"z": [np.int64(i)]})
           for i in range(4)]
    with tp.io.DeviceLoader(src, device="cpu") as dl:
        out = list(dl)
    assert [type(b) for b in out] == [Pair] * 4
    for i, b in enumerate(out):
        assert isinstance(b.x, tp.Tensor) and b.x.device.type == "cpu"
        np.testing.assert_array_equal(b.x.numpy(), np.ones(2) * i)
        assert b.y["z"][0] == i
    assert dl.last_wait_s >= 0.0


def test_device_loader_teardown_and_errors():
    """An abandoned iteration's producer stops once the iterator is
    collected; ``close()`` joins it; an error in the source re-raises in
    the consumer; ``sharding=`` and ``batch_sharding`` raise naming
    ROADMAP item 10."""
    def alive():
        return sum(t.name == "DeviceLoader-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    before = alive()
    dl = tp.io.DeviceLoader(range(1000), prefetch_depth=2, device="cpu")
    it = iter(dl)
    next(it)
    del it
    gc.collect()
    deadline = time.time() + 5
    while alive() > before and time.time() < deadline:
        time.sleep(0.05)
    assert alive() == before
    it = iter(dl)
    next(it)
    dl.close()
    assert alive() == before

    def bad():
        yield np.zeros(2)
        raise RuntimeError("source failed")
    with pytest.raises(RuntimeError, match="source failed"):
        list(tp.io.DeviceLoader(bad(), device="cpu"))
    with pytest.raises(NotImplementedError, match="item 10"):
        tp.io.DeviceLoader([], sharding=object())
    with pytest.raises(NotImplementedError, match="item 10"):
        tp.io.batch_sharding(None)


def test_metrics_match_jax():
    """``Accuracy`` (top 1 and 3, labels ``[N, 1]``), ``Precision``,
    ``Recall``, ``Auc`` over three updates, and ``accuracy``: the JAX
    values; the port's inputs may be tensors."""
    r = np.random.default_rng(2)
    logits = [r.standard_normal((16, 5)).astype(np.float32)
              for _ in range(3)]
    labels = [r.integers(0, 5, (16, 1)).astype(np.int64) for _ in range(3)]
    probs = [r.random(16).astype(np.float32) for _ in range(3)]
    binary = [r.integers(0, 2, 16).astype(np.int64) for _ in range(3)]
    res = {}
    for pkg in (jp, tp):
        acc = pkg.metric.Accuracy(topk=(1, 3))
        prec, rec, auc = (pkg.metric.Precision(), pkg.metric.Recall(),
                          pkg.metric.Auc())
        steps = []
        for lg, lb, p, b in zip(logits, labels, probs, binary):
            if pkg is tp:
                lg, lb = torch.from_numpy(lg), tp.to_tensor(lb)
            steps.append(acc.update(acc.compute(lg, lb)))
            for m in (prec, rec, auc):
                m.update(p, b)
        res[pkg] = (steps, acc.accumulate(),
                    [m.accumulate() for m in (prec, rec, auc)],
                    float(pkg.metric.accuracy(pkg.to_tensor(logits[0]),
                                              pkg.to_tensor(labels[0]),
                                              k=2)),
                    [m.name() for m in (acc, prec, rec, auc)])
    (js, ja, jm, jx, jn), (ts, ta, tm, tx, tn) = res[jp], res[tp]
    assert tn == jn
    np.testing.assert_allclose(np.array(ts), np.array(js), atol=METRIC_TOL)
    np.testing.assert_allclose(ta, ja, atol=METRIC_TOL)
    np.testing.assert_allclose(tm, jm, atol=METRIC_TOL)
    assert abs(tx - jx) < 1e-7
