"""Distributed training of the port (``paddle_tpu.distributed``'s
counterpart). Ported so far: ``fleet.recompute`` and
``fleet.recompute_sequential`` (activation recompute on one card),
``checkpoint`` (single-card fault-tolerant checkpointing: atomic commits,
verification and quarantine, async and emergency saves, retry),
``preemption`` (SIGTERM/SIGINT as a checkpoint request), and, for the
serving fleet, ``launch.KVServer`` / ``KVClient`` (the HTTP KV master)
and ``reshard.snapshot``'s block wire format."""
from . import checkpoint, fleet, preemption

__all__ = ["checkpoint", "fleet", "preemption"]
