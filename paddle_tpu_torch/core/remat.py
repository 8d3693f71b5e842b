"""Named activations and recompute policies (counterpart of
``paddle_tpu/core/remat.py``).

``tag_activation(x, name)`` marks a tensor of a transformer block under
one of the canonical names below; the ``"selective"`` policy of
``distributed.fleet.recompute`` keeps the tensors tagged with
``SELECTIVE_SAVE_NAMES`` and recomputes the rest of the block in the
backward (every ``[B, H, S, S]``-sized part of attention among it). Outside
a selective region a tag is the identity and costs one thread-local read.

The JAX package names values inside a ``jax.checkpoint`` trace; eager
PyTorch has no trace to name them in, so here a tag tells the open region
(``_Keep``, below) which of the matrix products it ran wrote the tensor,
and the region serves that product from memory when it recomputes the
block. A tagged tensor that no matrix product wrote (LLaMA's rotated q/k,
the attention context a kernel wrote) is recomputed: keeping it would
spare only the last operation that wrote it, since everything that leads
up to it runs again anyway.

The JAX module's trace statistics (``remat/*`` gauges) feed the monitor,
which the port does not have yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["ATTN_QKV", "ATTN_CONTEXT", "ATTN_OUT", "MLP_HIDDEN",
           "SELECTIVE_SAVE_NAMES", "POLICY_NAMES", "resolve_policy",
           "normalize_granularity", "tag_activation"]

ATTN_QKV = "attn_qkv"           # fused qkv (or per-tensor q/k/v) projection
ATTN_CONTEXT = "attn_context"   # softmax(qk^T) v, before the out projection
ATTN_OUT = "attn_out"           # attention output projection
MLP_HIDDEN = "mlp_hidden"       # first MLP matmul output (pre-activation)

# what "selective" keeps: the linear residuals; the attention score and
# softmax region stays unnamed, the memory being spent back
SELECTIVE_SAVE_NAMES = (ATTN_QKV, ATTN_CONTEXT, ATTN_OUT, MLP_HIDDEN)

POLICY_NAMES = ("none", "full", "dots", "selective")

# The matrix products without batch dimensions, the ones "dots" keeps (the
# JAX package's dots_with_no_batch_dims_saveable): every nn.Linear runs one
# of them; attention's batched products (bmm) are recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def resolve_policy(policy):
    """Validate a policy spec and return its name: ``"full"``, ``True`` and
    None give ``"full"`` (keep only the region's inputs), ``"dots"`` keeps
    the outputs of the region's matrix products, ``"selective"`` the
    tensors tagged with ``SELECTIVE_SAVE_NAMES``. The JAX package also
    takes a ``jax.checkpoint_policies`` callable; the port has none to
    take, so anything else raises ``ValueError``."""
    if policy is None or policy is True or policy == "full":
        return "full"
    if policy in ("dots", "selective"):
        return policy
    raise ValueError(f"unknown recompute policy {policy!r}; expected one of "
                     f"{POLICY_NAMES[1:]}")


def normalize_granularity(granularity, interval=1):
    """The one definition of the granularity surface that model configs
    and every ``enable_recompute`` share: True gives "full", None and
    False give "none", anything outside ``POLICY_NAMES`` raises, and the
    interval is clamped to at least 1. Returns ``(granularity,
    interval)``."""
    if granularity in (None, False):
        granularity = "none"
    elif granularity is True:
        granularity = "full"
    if granularity not in POLICY_NAMES:
        raise ValueError(f"recompute granularity {granularity!r} not in "
                         f"{POLICY_NAMES}")
    return granularity, max(int(interval), 1)


# the open _Keep regions of this thread, innermost last
_open = threading.local()


def tag_activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """Return ``x``; inside a ``"selective"`` region, a name of
    ``SELECTIVE_SAVE_NAMES`` first tells the region to keep the matrix
    product that wrote ``x``."""
    stack = getattr(_open, "regions", None)
    if stack and name in SELECTIVE_SAVE_NAMES:
        stack[-1].tag(x)
    return x


class _Keep(TorchDispatchMode):
    """The keep store of one recompute region, a dispatch mode open while
    the region runs: its first forward (``recording``) and its recompute.

    The matrix products of ``_DOTS`` are numbered per operator in the order
    they run. In the first forward each one's output is held; at the end
    of it "dots" keeps them all, "selective" only those whose storage a
    tag reached. In the recompute a kept product is not run: its output
    comes from the store, so the tensors built from it are the forward's
    own bits. The recompute runs the same code on the same shapes, so its
    products come in the same order. The store is emptied when the
    recompute ends: the recomputed block's saved tensors hold what the
    backward still needs."""

    def __init__(self, policy: str):
        super().__init__()
        self.policy = policy
        self.recording = True
        self.kept = {}               # (op, index) -> output
        self._count = {}
        self._by_storage = {}        # storage address -> (op, index)
        self._tagged = set()

    def __enter__(self):
        self._count = {}
        stack = getattr(_open, "regions", None)
        if stack is None:
            stack = _open.regions = []
        stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _open.regions.remove(self)
        if not self.recording:
            self.kept = {}     # the recomputed block holds what it needs
        elif self.policy == "selective":
            self.kept = {k: v for k, v in self.kept.items()
                         if k in self._tagged}
        self.recording = False
        self._by_storage = {}
        self._tagged = set()
        return super().__exit__(*exc)

    def tag(self, x):
        if self.recording:
            key = self._by_storage.get(x.untyped_storage().data_ptr())
            if key is not None:
                self._tagged.add(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _DOTS:
            return func(*args, **kwargs)
        i = self._count.get(func, 0)
        self._count[func] = i + 1
        key = (func, i)
        if not self.recording:
            if key in self.kept:
                return self.kept[key].detach()
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        # held as an alias without autograd history: the graph the forward
        # builds on ``out`` must not be reachable from the store
        self.kept[key] = out.detach()
        self._by_storage[out.untyped_storage().data_ptr()] = key
        return out
