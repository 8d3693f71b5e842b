"""Activation recompute (counterpart of
``paddle_tpu/distributed/fleet/recompute.py``).

``recompute(function, *args, policy=...)`` runs ``function`` and keeps,
of what its backward needs, only what the policy names; the backward runs
the function again to rebuild the rest. It is built on
``torch.utils.checkpoint`` in its non-reentrant form, whose
``context_fn`` opens one context around the first forward and another
around the recompute:

* the policy (``core.remat``): "full" keeps only the region's inputs,
  "dots" also the outputs of its matrix products, "selective" the outputs
  of those products that carry a tag of ``SELECTIVE_SAVE_NAMES``
  (``core.remat._Keep`` serves them to the recompute instead of running
  the product again). Everything else is recomputed, the flash kernels'
  forward with it: the kernels' ``lse`` carries no name in the JAX package
  either, so under every policy each recomputed block launches its
  attention forward a second time (and, in GPT, the dropout kernel after
  the attention, whose output the second LayerNorm needs);
* the seeds (``preserve_rng_state``): the port's dropouts draw their seeds
  from CPU ``torch.Generator``s, the model's own or the global chain,
  which ``torch.utils.checkpoint`` does not restore. The first forward
  snapshots each generator it draws from (``core.random.record_generators``)
  and the recompute draws again from those states
  (``replay_generators``), so every kernel drops the elements it dropped
  in the forward (inside a training program's seed stage the snapshot is
  the draw count, and the recompute reads the forward's seed slots).
  ``torch.utils.checkpoint`` keeps torch's own generators as well, except
  while a CUDA graph captures: it would read the card's generator state
  from the host, which a capture does not allow, and no op of the port
  draws from it;
* AMP: the forward's ``auto_cast`` state is put back in force around the
  recompute, which runs in the backward, outside the ``auto_cast`` block;
* the monitor: a region counts once in the recompute trace statistics
  (``core.remat.note_region``), and its replay runs under
  ``monitor.health.suspend_taps``, so the replayed forward neither taps
  the health plane's activations nor counts its tags a second time;
* state: the replay runs under ``core.remat.replaying``, where a batch
  norm computes its batch statistics and leaves its running buffers as
  they are (the first forward updated them), so a recomputed region moves
  ``_mean`` / ``_variance`` once a step, as the JAX package's
  ``TrainStep`` does.

The recompute runs the same code on the same inputs, so on the CPU a
recomputed region gives the gradients of the plain run bit for bit.
"""
from __future__ import annotations

from contextlib import ExitStack, contextmanager

import torch
from torch.utils.checkpoint import checkpoint

from ...core import amp_state
from ...core import random as rnd
from ...core import remat as _remat
from ...monitor.health import suspend_taps

__all__ = ["recompute", "recompute_sequential"]


def _contexts(policy: str, preserve_rng_state: bool):
    """``context_fn`` for one region: the contexts of its first forward and
    of its recompute, sharing the region's keep store, generator snapshot
    and AMP state."""
    keep = _remat._Keep(policy) if policy != "full" else None
    snap = []
    amp = amp_state.amp_state()

    @contextmanager
    def forward():
        with ExitStack() as stack:
            if preserve_rng_state:
                stack.enter_context(rnd.record_generators(snap))
            if keep is not None:
                stack.enter_context(keep)
            yield

    @contextmanager
    def again():
        with ExitStack() as stack:
            if preserve_rng_state:
                stack.enter_context(rnd.replay_generators(snap))
            stack.enter_context(amp_state.applied(amp))
            stack.enter_context(suspend_taps())
            stack.enter_context(_remat.replaying())
            if keep is not None:
                stack.enter_context(keep)
            yield

    return forward(), again()


def recompute(function, *args, preserve_rng_state: bool = True,
              use_reentrant: bool = True, policy="full", **kwargs):
    """``paddle.distributed.fleet.utils.recompute`` with ``policy=`` ("full",
    "dots" or "selective"; see the module docstring). Without grad mode
    the function just runs. ``use_reentrant`` is taken for the reference's
    signature; the region is always the non-reentrant form, the only one
    that takes the contexts above."""
    policy = _remat.resolve_policy(policy)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    _remat.note_region(policy)
    capturing = torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state
                      and not capturing,
                      context_fn=lambda: _contexts(policy,
                                                   preserve_rng_state),
                      **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``paddle.distributed.fleet.utils.recompute_sequential``: run the
    layers of ``functions`` (a list, ``nn.Sequential`` or ``ModuleList``)
    in ``ctx["segments"]`` chunks (default 1), each chunk under
    ``recompute`` with ``ctx``'s ``preserve_rng_state`` and ``policy``. A
    layer that returns a list or tuple passes it on unpacked, inside a
    chunk and at a chunk's edge alike."""
    ctx = ctx or {}
    segments = max(int(ctx.get("segments", 1)), 1)
    preserve = bool(ctx.get("preserve_rng_state", True))
    policy = ctx.get("policy", "full")
    layers = list(functions)
    if not layers:
        raise ValueError("recompute_sequential: empty function list")
    per = max((len(layers) + segments - 1) // segments, 1)

    def run_chunk(chunk, *xs):
        out = chunk[0](*xs, **kwargs)
        for fn in chunk[1:]:
            out = fn(*out, **kwargs) if isinstance(out, (list, tuple)) \
                else fn(out, **kwargs)
        return out

    out = args
    for s in range(0, len(layers), per):
        chunk = layers[s:s + per]
        xs = tuple(out) if isinstance(out, (list, tuple)) else (out,)
        out = recompute(lambda *a, _c=chunk: run_chunk(_c, *a), *xs,
                        preserve_rng_state=preserve, policy=policy)
    return out
