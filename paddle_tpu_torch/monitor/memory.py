"""Memory accounting — per-program memory readings and a live-tensor census
(counterpart of ``paddle_tpu/monitor/memory.py``).

The JAX package reads an executable's footprint from XLA's compile-time
``memory_analysis()`` and the live population from ``jax.live_arrays()``.
The port has neither: its programs (``core/programs.py``) are CUDA graphs
whose memory the caching allocator hands out while the program is warmed
up and captured. So a program's footprint is measured around that first
call, from ``torch.cuda.memory_stats``, and the census walks the Python
heap for CUDA tensors, on demand only.
"""
from __future__ import annotations

import gc
from typing import Optional

import torch

__all__ = ["executable_memory_stats", "live_array_census",
           "capture_reading"]


def capture_reading(device) -> Optional[dict]:
    """The allocator's counters on ``device`` now (``None`` off the card):
    read before and after a program's first call."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    st = torch.cuda.memory_stats(device)
    return {"reserved": int(st.get("reserved_bytes.all.current", 0)),
            "allocated": int(st.get("allocated_bytes.all.current", 0))}


def _state_bytes(state):
    """(input bytes, other bytes) of the tensors a program was built with:
    a ``StagedBuffer``'s device buffer counts as its inputs, any other
    tensor (an output buffer, a scratch cache) as the rest."""
    if state is None:
        return 0, 0
    dev = getattr(state, "_dev", None)
    if isinstance(dev, torch.Tensor):
        return dev.numel() * dev.element_size(), 0
    if isinstance(state, torch.Tensor):
        return 0, state.numel() * state.element_size()
    if isinstance(state, (tuple, list)):
        a = o = 0
        for s in state:
            sa, so = _state_bytes(s)
            a, o = a + sa, o + so
        return a, o
    return 0, 0


def executable_memory_stats(program) -> Optional[dict]:
    """The memory footprint of one program (``core.programs.Program``),
    in the JAX function's fields, or None when it was not measured (the
    CPU, where a program is its eager body, as the JAX function gives None
    on a backend without memory analysis; or a program built while the
    monitor was off). The fields' counterparts:

    * ``argument_bytes``: the program's staged inputs (XLA: its arguments);
    * ``output_bytes``: the other buffers it was built with, its output
      buffer and any scratch cache (XLA: its outputs);
    * ``temp_bytes``: the growth of reserved memory across its warm-up and
      capture, the intermediates its graph's memory pool keeps (XLA: temp);
    * ``alias_bytes``: 0 — the KV pools and caches a program updates in
      place are the engine's, allocated before it (XLA: donated buffers);
    * ``generated_code_bytes``: 0 — kernels live outside device memory's
      allocator;
    * ``total_bytes``: arguments + outputs + temp - alias, as in JAX.
    """
    reading = getattr(program, "memory", None)
    if reading is None:
        return None
    arg, out = _state_bytes(getattr(program, "state", None))
    vals = {"argument_bytes": int(arg), "output_bytes": int(out),
            "temp_bytes": max(int(reading["reserved"]), 0),
            "alias_bytes": 0, "generated_code_bytes": 0}
    vals["total_bytes"] = (vals["argument_bytes"] + vals["output_bytes"]
                           + vals["temp_bytes"] - vals["alias_bytes"])
    return vals


def live_array_census(top: int = 10, device: str = "cuda") -> dict:
    """Snapshot of every live tensor on ``device`` (a type: "cuda" or
    "cpu") that the Python heap reaches, counted once per storage.

    Returns ``{"count", "total_bytes", "top": [{"shape", "dtype",
    "nbytes", "sharded"}...]}`` sorted by size, the JAX function's shape
    (``sharded`` is always False: the port shards nothing yet). The "why
    is memory full" helper: it walks every object the collector tracks,
    so run it when the memory gauges trend up, not on a hot path.
    """
    seen = set()
    sized = []
    total = 0
    for obj in gc.get_objects():
        try:
            if not isinstance(obj, torch.Tensor) \
                    or obj.device.type != device:
                continue
            st = obj.untyped_storage()
            key = (st.data_ptr(), st.nbytes())
        except Exception:
            continue
        if key in seen:
            continue
        seen.add(key)
        nb = int(key[1])
        total += nb
        sized.append((nb, obj))
    sized.sort(key=lambda t: t[0], reverse=True)
    top_list = [{"shape": list(a.shape), "dtype": str(a.dtype).replace(
                     "torch.", ""), "nbytes": nb, "sharded": False}
                for nb, a in sized[:max(int(top), 0)]]
    return {"count": len(sized), "total_bytes": total, "top": top_list}
