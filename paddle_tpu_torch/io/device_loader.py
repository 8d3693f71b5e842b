"""DeviceLoader — double-buffered host→device batch pipeline (counterpart
of ``paddle_tpu/io/device_loader.py``).

Reference analog: tf.data's ``prefetch_to_device`` and torch_xla's
``MpDeviceLoader`` — an accelerator that idles between steps waiting for the
next batch's collate + H2D transfer is pure lost time. The DataLoader already
hides decode/collate behind worker threads/processes; this layer hides the
*transfer*: a background thread pulls collated batches (CPU tensors) and
copies them to the card ahead of consumption with a bounded prefetch depth,
so step N+1's transfer overlaps step N's device compute.

Stream order on the card. The producer thread pins each host leaf, copies
it with ``non_blocking=True`` on a side stream of the loader's own and
records a ``torch.cuda.Event`` behind the copies (it waits for that event
itself, so the ``loader/h2d`` span is the transfer's time and a queued
batch is a delivered one). The consumer makes the current stream wait on
the event before it hands the batch out and calls ``record_stream`` on
each of its device tensors: the caching allocator then keeps their memory
until the work queued on the consumer's stream (a captured step's copy of
its inputs into its own buffers, the replay) has read them. A batch whose
leaves already lie on the card passes through.

``stack_batches=K`` stacks every K collated batches leaf-wise on a new
leading axis before the transfer (host leaves with ``np.stack`` /
``torch.stack`` on the host, device leaves with ``torch.stack`` on the
card): one prefetch slot carries a whole ``TrainStep(accumulate_steps=K)``
window, and a trailing partial window is dropped.

An abandoned iteration (``break`` without ``close()``) stops its producer
and frees its device batches when the iterator is collected: the loader
holds it weakly and the producer thread holds neither.

Tracing: with the port's tracer on (``monitor.trace``), the producer
records ``loader/fetch`` and ``loader/h2d`` and the consumer
``loader/wait`` as floating spans the next step trace adopts; with the
monitor on, each wait feeds ``loader/*`` and goodput's ``data_wait``.
The JAX package's profiler stage events wait for the port's profiler
(ROADMAP item 12). ``sharding=`` and ``batch_sharding`` need a device mesh
(ROADMAP item 10) and raise.
"""
from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Optional

import numpy as np
import torch

from .. import monitor as _monitor
from ..core.device import get_default_place, to_place
from ..monitor import trace as _trace
from .dataloader import host_tensor

__all__ = ["DeviceLoader", "batch_sharding", "stack_microbatches"]

_MESH = ("need a device mesh (data-parallel placement), which is not "
         "ported yet: ROADMAP Queue 1, item 10's rest")


def _map_leaves(batch, fn):
    """``batch`` (a leaf or a nested list / tuple / namedtuple / dict) with
    ``fn`` applied to every leaf."""
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_map_leaves(b, fn) for b in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_leaves(b, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: _map_leaves(v, fn) for k, v in batch.items()}
    return fn(batch)


def stack_microbatches(batches):
    """Stack K collated batches leaf-wise along a NEW leading axis.

    The result is the input format of ``jit.TrainStep(accumulate_steps=K)``:
    every array leaf gains a leading axis of length K. A tensor leaf stacks
    where it lies (host leaves on the host, before the transfer; device
    leaves on the card, with no round trip); numpy leaves stack with
    ``np.stack``."""
    b0 = batches[0]
    if isinstance(b0, tuple) and hasattr(b0, "_fields"):
        return type(b0)(*(stack_microbatches([b[i] for b in batches])
                          for i in range(len(b0))))
    if isinstance(b0, (list, tuple)):
        return type(b0)(stack_microbatches([b[i] for b in batches])
                        for i in range(len(b0)))
    if isinstance(b0, dict):
        return {k: stack_microbatches([b[k] for b in batches]) for k in b0}
    if isinstance(b0, torch.Tensor):
        return torch.stack(list(batches))
    return np.stack([np.asarray(b) for b in batches])


def _stacked_iter(inner, k: int):
    """Group the inner iterator into stacks of K microbatches (one TrainStep
    call each). A trailing group of fewer than K batches is dropped —
    ``drop_last`` semantics, the accumulation window needs exactly K."""
    try:
        while True:
            group = []
            for _ in range(k):
                try:
                    group.append(next(inner))
                except StopIteration:
                    return
            yield stack_microbatches(group)
    finally:
        close = getattr(inner, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass


def batch_sharding(mesh, axis_name=None):
    """The data-parallel input placement over a device mesh: not ported."""
    raise NotImplementedError(f"batch_sharding: sharded inputs {_MESH}")


_END = object()


def _produce(inner, put_fn, q, stop, state):
    """Producer thread body. MODULE-LEVEL on purpose: a running thread is a
    GC root, so a bound-method target would pin the iterator object forever
    and its __del__ (the abandonment teardown) could never fire. The thread
    only holds the pieces it needs; the iterator stays collectable."""
    try:
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                batch = next(inner)
            except StopIteration:
                break
            t1 = time.perf_counter()
            item = put_fn(batch)
            t2 = time.perf_counter()
            tracer = _trace._active
            if tracer is not None:
                # producer-side work, recorded as floating spans the NEXT
                # step trace adopts: the waterfall shows fetch/H2D that ran
                # (hidden or not) ahead of that step's dispatch
                tracer.floating("loader/fetch", t0, t1)
                tracer.floating("loader/h2d", t1, t2)
            # bounded put that notices abandonment (same pattern as
            # DataLoader._PrefetchIterator): a consumer that stopped
            # iterating must not leave this thread blocked forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
    except BaseException as e:  # propagate to the consumer
        state["err"] = e
    finally:
        close = getattr(inner, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass
        # stop-aware END delivery: a single bounded put could time out while
        # the consumer is busy on a full queue, leaving it blocked on get()
        # forever once it drains the queue
        while not stop.is_set():
            try:
                q.put(_END, timeout=0.2)
                break
            except queue.Full:
                continue


class _DeviceIterator:
    """One pass over the inner loader: background transfer thread + bounded
    queue of ``(batch, event)``. ``close()`` is idempotent and joins the
    thread; dropping the last reference (abandoned iteration) tears the
    thread down via __del__."""

    def __init__(self, inner_iter, put_fn, depth: int, owner):
        self._q = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._state = {"err": None}
        self._done = False
        # keep the owning DeviceLoader alive for the duration of the
        # iteration: the loader only holds US weakly, so without this ref a
        # temporary like `iter(DeviceLoader(...))` can be collected mid-epoch
        # and its __del__ would tear down this live iteration
        self._owner = owner
        self._thread = threading.Thread(
            target=_produce, args=(inner_iter, put_fn, self._q, self._stop,
                                   self._state),
            daemon=True, name="DeviceLoader-prefetch")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        t1 = time.perf_counter()
        if item is _END:
            self._done = True
            err = self._state["err"]
            if err is not None:
                self._state["err"] = None
                raise err
            raise StopIteration
        batch, event = item
        if event is not None:
            # the copies ran on the producer's side stream: order this
            # stream's work after them, and keep each device tensor's memory
            # until this stream's work has read it
            stream = torch.cuda.current_stream(self._owner._device)
            stream.wait_event(event)

            def keep(leaf):
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    leaf.record_stream(stream)
                return leaf
            _map_leaves(batch, keep)
        mon = _monitor._active
        if mon is not None:
            # feed-health telemetry: queue depth gauge + stall counter (a
            # blocking get means the producer lost the race this step; the
            # terminal END wait above is epoch teardown, not a stall)
            mon.loader_wait(t1 - t0, self._q.qsize(), span=(t0, t1))
        tracer = _trace._active
        if tracer is not None:
            # consumer stall ahead of the next step: adopted by that step's
            # trace, so "slow step" splits into waited-on-feed vs dispatch
            tracer.floating("loader/wait", t0, t1, qsize=self._q.qsize())
        self._owner.last_wait_s += t1 - t0
        return batch

    def close(self):
        """Stop the producer and release its queue slots; safe to call from
        ``finally`` blocks and repeatedly."""
        self._stop.set()
        # drain so a producer blocked in put() observes the stop quickly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        self._done = True

    def __del__(self):
        self._stop.set()


class DeviceLoader:
    """Wrap a :class:`DataLoader` (or any iterable of batches) so batches
    arrive already resident on the device.

    Args:
        loader: the inner batch source. Each batch may be a tensor, an
            ndarray, or a (possibly nested) list/tuple/dict of them.
        prefetch_depth: how many device-resident batches to hold ahead of the
            consumer (the double-buffer depth; 2 hides one full transfer).
        sharding: a mesh placement; not ported (ROADMAP item 10), raises.
        device: the target (a ``Place``, ``torch.device`` or "gpu" / "cpu"
            string); default the default place (the card, or what
            ``set_device`` chose). On the CPU the batches pass as CPU
            tensors.
        stack_batches: K > 1 stacks every K consecutive collated batches
            leaf-wise along a new leading axis *before* the transfer —
            one prefetch slot then carries a full
            ``jit.TrainStep(accumulate_steps=K)`` accumulation window. A
            trailing partial group is dropped (``drop_last`` semantics).

    ``last_wait_s`` is the consumer's wait summed over the newest pass.
    """

    def __init__(self, loader, prefetch_depth: int = 2, sharding=None,
                 device=None, stack_batches: int = 1):
        if sharding is not None:
            raise NotImplementedError(f"DeviceLoader(sharding=...): sharded "
                                      f"placement {_MESH}")
        self.loader = loader
        self.prefetch_depth = max(int(prefetch_depth), 1)
        self._device = (get_default_place() if device is None
                        else to_place(device)).device
        self.stack_batches = max(int(stack_batches), 1)
        # weakref: abandoning an iteration (break/exception without close())
        # must let the iterator be collected, so its __del__ stops the
        # producer thread and frees the prefetched device batches — a strong
        # ref here would pin them for the loader's whole lifetime
        self._live: Optional[weakref.ref] = None
        self._stream = None
        self.last_wait_s = 0.0

    def __len__(self):
        return len(self.loader) // self.stack_batches

    # ------------------------------------------------------------- transfer

    def _put_leaf(self, leaf):
        if isinstance(leaf, np.ndarray):
            leaf = host_tensor(leaf)
        if not isinstance(leaf, torch.Tensor) or leaf.device == self._device:
            return leaf
        if self._device.type != "cuda":
            return leaf.to(self._device)
        if leaf.device.type == "cpu" and not leaf.is_pinned():
            leaf = leaf.pin_memory()
        return leaf.to(self._device, non_blocking=True)

    def _put_batch(self, batch):
        """The producer's transfer: ``(batch on the device, the event
        behind its copies)`` (no event off the card)."""
        if self._device.type != "cuda":
            return _map_leaves(batch, self._put_leaf), None
        with torch.cuda.stream(self._stream):
            out = _map_leaves(batch, self._put_leaf)
            event = torch.cuda.Event()
            event.record(self._stream)
        event.synchronize()
        return out, event

    # ------------------------------------------------------------ iteration

    def __iter__(self):
        self.close()
        self.last_wait_s = 0.0
        if self._device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        inner = iter(self.loader)
        if self.stack_batches > 1:
            inner = _stacked_iter(inner, self.stack_batches)
        it = _DeviceIterator(inner, self._put_batch, self.prefetch_depth,
                             self)
        self._live = weakref.ref(it)
        return it

    def close(self):
        """Shut down the active iteration's prefetch thread (idempotent)."""
        it = self._live() if self._live is not None else None
        if it is not None:
            it.close()
        self._live = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
