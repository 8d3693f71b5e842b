"""The block wire format of ``paddle_tpu/distributed/reshard/snapshot.py``
(``encode_block`` / ``decode_block``) on torch tensors.

A block is raw C-order bytes plus a JSON-ready meta ``{"shape": [...],
"dtype": name}``, ``name`` the numpy dtype name (``"bfloat16"`` for bf16,
the name ``ml_dtypes`` gives it). The serving KV pool (``serving/
kvpool.py``) moves exported prefix blocks in it, so a payload written by
either package decodes bit for bit in the other. numpy has no bf16 of its
own (and the card's machine has no ``ml_dtypes``), so every dtype goes
through torch: bf16 bytes are read with ``torch.frombuffer`` and written
through an ``int16`` view. The rest of the JAX module (sharded snapshots,
resharding on load) is not ported: the port checkpoints on one card.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

__all__ = ["encode_block", "decode_block", "DTYPE_NAMES"]

# torch dtype <-> the numpy name the JAX package writes into the meta
DTYPE_NAMES: Dict[torch.dtype, str] = {
    torch.bfloat16: "bfloat16", torch.float16: "float16",
    torch.float32: "float32", torch.float64: "float64",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}
_BY_NAME = {name: dt for dt, name in DTYPE_NAMES.items()}


def encode_block(arr) -> Tuple[bytes, Dict[str, Any]]:
    """Raw C-order bytes + meta for ONE tensor (a numpy array is taken as
    its tensor). A tensor on the card is copied to the host first, on the
    current stream, so the read is ordered after the work queued before
    it."""
    t = torch.as_tensor(arr).detach()
    if t.dtype not in DTYPE_NAMES:
        raise TypeError(f"encode_block: no wire name for {t.dtype}")
    t = t.cpu().contiguous()
    # numpy cannot hold bf16: ship its bits through a same-width int view
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return raw.numpy().tobytes(), {"shape": [int(s) for s in t.shape],
                                   "dtype": DTYPE_NAMES[t.dtype]}


def decode_block(data: bytes, meta: Dict[str, Any]) -> torch.Tensor:
    """Inverse of :func:`encode_block`: a CPU tensor of the meta's shape
    and dtype. Size-validated against the meta (``prod(()) == 1`` covers
    scalars), so a truncated or mis-keyed payload raises ``ValueError``
    instead of reshaping garbage into the KV cache; an unknown dtype name
    raises ``ValueError`` too."""
    shape = tuple(int(s) for s in meta["shape"])
    dtype = _BY_NAME.get(str(meta["dtype"]))
    if dtype is None:
        raise ValueError(f"block dtype {meta['dtype']!r} has no torch "
                         f"counterpart here")
    itemsize = torch.empty((), dtype=dtype).element_size()
    want = itemsize * int(math.prod(shape))
    if len(data) != want:
        raise ValueError(f"block payload is {len(data)} bytes, expected "
                         f"{want} for shape {shape} dtype {meta['dtype']}")
    if want == 0:
        return torch.empty(shape, dtype=dtype)
    # a private writable copy: frombuffer over immutable bytes would warn,
    # and the result must not alias the caller's payload
    return torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape)
