"""DataLoader (counterpart of ``paddle_tpu/io/dataloader.py``; reference:
python/paddle/fluid/reader.py:311 + dataloader/worker.py).

num_workers > 0 prefetches batches on worker THREADS by default (numpy decode/
augment releases the GIL). use_process_workers=True opts into forked WORKER
PROCESSES (the reference's multiprocess outstanding-queue design): workers
inherit the dataset via fork — no dataset pickling — fetch samples for a batch
and ship them back; the parent collates and owns the device transfer.

Two rules of the port:

* **Collated batches live on the host.** ``default_collate_fn`` makes CPU
  ``Tensor``s (the JAX package's collate puts its batches on the device).
  ``io.DeviceLoader``, ``Model`` or the captured ``TrainStep``'s staged
  copy moves them to the card; a worker thread never makes a CUDA tensor,
  which would queue on the default stream behind the training step.
* **A forked worker never touches CUDA.** A process that forked after CUDA
  initialised cannot use it, so process workers are opt-in and meant for
  numpy-only datasets: they fetch samples and the parent collates.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import CPUPlace
from ..core.tensor import Tensor
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

# fork-inherited worker state (reference worker.py passes it over pipes; fork
# makes the dataset visible for free and start cost O(1) in dataset size).
# _FORK_LOCK serializes the assign→fork window so two concurrently-starting
# loaders cannot hand each other's dataset to their workers.
_FORK_STATE = {}
_FORK_LOCK = threading.Lock()


def _worker_init(counter, init_fn, token, num_workers):
    with counter.get_lock():
        wid = counter.value
        counter.value += 1
    _FORK_STATE["worker_id"] = wid
    from .dataset import WorkerInfo, _set_worker_info
    _set_worker_info(WorkerInfo(wid, num_workers, _FORK_STATE.get(token)))
    # re-key the fork-captured dataset so the parent can drop its entry while
    # respawned workers (after a child crash) still find it
    _FORK_STATE["dataset"] = _FORK_STATE[token]
    if init_fn is not None:
        init_fn(wid)


def _worker_fetch(indices):
    ds = _FORK_STATE["dataset"]
    return [ds[i] for i in indices]


def host_tensor(arr) -> Tensor:
    """A CPU ``Tensor`` over a numpy array or a host torch tensor (the
    collated batch's form)."""
    return Tensor(arr, place=CPUPlace())


def default_collate_fn(batch):
    """Stack a list of samples field by field into CPU ``Tensor``s
    (tensors stack with ``torch.stack`` where they lie, numpy arrays with
    ``np.stack``; Python ints as int64, floats as float32)."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn([b[i] for b in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return host_tensor(torch.stack([torch.as_tensor(b) for b in batch]))
    if isinstance(sample, np.ndarray):
        return host_tensor(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return host_tensor(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return host_tensor(np.asarray(batch, np.float32))
    return batch


class _PrefetchIterator:
    _END = object()

    def __init__(self, produce, num_workers: int, prefetch: int):
        self._q = queue.Queue(maxsize=max(prefetch, 2))
        self._produce = produce
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            gen = self._produce()
            try:
                for item in gen:
                    # bounded put that notices abandonment: a consumer that
                    # stopped iterating would otherwise leave this thread
                    # blocked forever (and leak any worker-process pool the
                    # generator's finally would have torn down)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
                self._q.put(self._END)
            finally:
                if hasattr(gen, "close"):
                    gen.close()  # runs the generator's finally (pool teardown)
        except BaseException as e:  # propagate worker errors to the consumer
            self._err = e
            self._q.put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()

    def __del__(self):
        self._stop.set()


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler: Optional[BatchSampler] = None,
                 batch_size: int = 1, shuffle: bool = False, drop_last: bool = False,
                 collate_fn: Optional[Callable] = None, num_workers: int = 0,
                 use_buffer_reader: bool = True, prefetch_factor: int = 2,
                 use_shared_memory: bool = True, timeout: int = 0,
                 worker_init_fn=None, persistent_workers: bool = False,
                 use_process_workers: bool = False,
                 bucket_boundaries=None):
        self.dataset = dataset
        if bucket_boundaries is not None:
            # variable-length policy: pad each batch to a bucket boundary so
            # downstream jit/TrainStep compiles a bounded executable set
            # (see io/bucketing.py for the full contract)
            if collate_fn is not None:
                raise ValueError("pass either collate_fn or bucket_boundaries "
                                 "(wrap BucketingCollate yourself to combine)")
            from .bucketing import BucketingCollate
            collate_fn = BucketingCollate(boundaries=bucket_boundaries)
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self._use_process_workers = use_process_workers
        self._worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("length of IterableDataset loader is unknown")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _iter_batches(self, it):
        """Shared iterable batching (single- and multi-process paths)."""
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch:
                return
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield batch

    def _produce_batches(self):
        if self._iterable_mode:
            if self.num_workers > 1 and self._use_process_workers \
                    and "fork" in mp.get_all_start_methods():
                yield from self._produce_iterable_multiprocess()
                return
            for batch in self._iter_batches(iter(self.dataset)):
                yield self.collate_fn(batch)
        elif self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
        else:
            if self.num_workers > 1 and self._use_process_workers \
                    and "fork" in mp.get_all_start_methods():
                yield from self._produce_multiprocess()
            elif self.num_workers > 1:
                # thread-pool fetch: numpy augmentation releases the GIL
                import concurrent.futures as cf
                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    for indices in self.batch_sampler:
                        samples = list(pool.map(self.dataset.__getitem__, indices))
                        yield self.collate_fn(samples)
            else:
                for indices in self.batch_sampler:
                    yield self.collate_fn([self.dataset[i] for i in indices])

    def _produce_iterable_multiprocess(self):
        """IterableDataset process workers: each forked worker gets
        WorkerInfo(id, num_workers) — the dataset's __iter__ shards its own
        stream (reference _DataLoaderIterMultiProcess iterable mode) — and
        ships raw samples back; the parent collates."""
        ctx = mp.get_context("fork")
        q = ctx.Queue(maxsize=self.num_workers * self.prefetch_factor)
        END = None

        def worker(wid):
            try:
                from .dataset import WorkerInfo, _set_worker_info
                _set_worker_info(WorkerInfo(wid, self.num_workers,
                                            self.dataset))
                if self._worker_init_fn is not None:
                    self._worker_init_fn(wid)
                for batch in self._iter_batches(iter(self.dataset)):
                    q.put(batch)
            except BaseException as e:   # propagate instead of hanging parent
                import traceback
                q.put(("__worker_error__",
                       f"{e!r}\n{traceback.format_exc()[-2000:]}"))
            finally:
                q.put(END)

        procs = [ctx.Process(target=worker, args=(w,), daemon=True)
                 for w in range(self.num_workers)]
        for p in procs:
            p.start()
        try:
            done = 0
            while done < self.num_workers:
                item = q.get()
                if item is END:
                    done += 1
                    continue
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == "__worker_error__":
                    raise RuntimeError(f"DataLoader worker failed: {item[1]}")
                yield self.collate_fn(item)
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join()

    def _produce_multiprocess(self):
        """Process workers: one batch of __getitem__ calls per task, results
        streamed back in order (reference _DataLoaderIterMultiProcess)."""
        ctx = mp.get_context("fork")
        token = f"dataset_{id(self)}"
        with _FORK_LOCK:
            _FORK_STATE[token] = self.dataset
            counter = ctx.Value("i", 0)
            try:
                pool = ctx.Pool(self.num_workers, initializer=_worker_init,
                                initargs=(counter, self._worker_init_fn,
                                          token, self.num_workers))
            except BaseException:
                _FORK_STATE.pop(token, None)
                raise
        try:
            batches = pool.imap(_worker_fetch, list(self.batch_sampler),
                                chunksize=1)
            for samples in batches:
                yield self.collate_fn(samples)
        finally:
            pool.terminate()
            pool.join()
            _FORK_STATE.pop(token, None)

    def __iter__(self):
        if self.num_workers > 0:
            return _PrefetchIterator(self._produce_batches, self.num_workers,
                                     self.prefetch_factor * max(self.num_workers, 1))
        return self._produce_batches()
