"""The flash backwards' ordered dq sum (``csrc/dq_sum.cu``).

Every flash backward body stores the dq contribution of each of its parts
(a kv tile, or one consumer warpgroup's half of one) into a slab of its
own, ``[parts, B, Lq, H*D]`` fp32 in the backward's workspace, and this
kernel adds, for each dq element, the slabs that hold its row's partials
in part order (the order in which the Pallas kernels' sequential grid
sums dq over the kv tiles), scales by ``sm_scale`` and rounds to the input
type. So a backward's dq is the same bit for bit from launch to launch;
``csrc/dq_parts.cuh`` sets out which slabs hold which rows, and
``dq_parts_geometry`` / ``parts_of_rows`` here mirror it.

``dq_ordered_sum`` launches the kernel on a CUDA tensor (counted in
``dq_ordered_sum.launches``) and computes ``dq_ordered_sum_reference`` on a
CPU tensor: the same fp32 adds in the same order, so the two agree bit for
bit on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["dq_ordered_sum", "dq_ordered_sum_reference", "dq_parts_geometry",
           "dq_parts", "parts_of_rows"]

_ROWS_Q = 64   # q rows of a backward step, in every body


def dq_parts_geometry(d: int, dtype) -> tuple:
    """``(kv_tile, per_tile)`` of the body that runs a backward of head size
    ``d`` in ``dtype``: kv rows of its tile (128 in bf16, 32 in fp32) and
    its parts a tile (2 in the bf16 body at 64, 80 and 96, whose two
    consumer warpgroups each store their own 64 kv rows' partials)."""
    if dtype != torch.bfloat16:
        return 32, 1
    return 128, (2 if d in (64, 80, 96) else 1)


def dq_parts(lk: int, d: int, dtype) -> int:
    """The slabs of a backward over ``lk`` keys."""
    kv_tile, per_tile = dq_parts_geometry(d, dtype)
    return -(-lk // kv_tile) * per_tile


def parts_of_rows(b: int, lq: int, lk: int, causal: bool, kv_tile: int,
                  per_tile: int, lens=None, device="cpu") -> torch.Tensor:
    """``[B, Lq]`` int64: how many of the first slabs hold each q row's
    partials. A tile starting at or past the row's key length (``lens``,
    clamped to ``[0, Lk]``) writes none; a causal tile ``j`` reaches q tile
    ``r // 64`` iff ``j * kv_tile < (r // 64 + 1) * 64 + Lk - Lq``."""
    if lens is None:
        length = torch.full((b,), lk, dtype=torch.int64, device=device)
    else:
        length = lens.to(device=device, dtype=torch.int64).clamp(0, lk)
    tiles = ((length + kv_tile - 1) // kv_tile)[:, None].expand(b, lq)
    if causal:
        r = torch.arange(lq, device=device)
        reach = (r // _ROWS_Q + 1) * _ROWS_Q + (lk - lq)
        t = torch.where(reach > 0, (reach + kv_tile - 1) // kv_tile, 0)
        tiles = torch.minimum(tiles, t[None, :])
    return tiles * per_tile


def dq_ordered_sum_reference(parts: torch.Tensor, lk: int, causal: bool,
                             kv_tile: int, per_tile: int, sm_scale: float,
                             dtype, lens=None) -> torch.Tensor:
    """The kernel's sum in plain torch: for each element of ``[B, Lq, hd]``,
    0.0 plus slabs ``0 .. n - 1`` of ``parts`` (``[P, B, Lq, hd]`` fp32) in
    that order, ``n`` from ``parts_of_rows``, times ``sm_scale`` in fp32,
    rounded to ``dtype``."""
    _, b, lq, _ = parts.shape
    n = parts_of_rows(b, lq, lk, causal, kv_tile, per_tile, lens,
                      parts.device)[..., None]
    acc = torch.zeros(parts.shape[1:], dtype=torch.float32,
                      device=parts.device)
    for p in range(int(n.max()) if n.numel() else 0):
        acc = torch.where(n > p, acc + parts[p], acc)
    return (acc * torch.tensor(sm_scale, dtype=torch.float32)).to(dtype)


_ARGTYPES = (ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_void_p)


def dq_ordered_sum(parts: torch.Tensor, dq: torch.Tensor, lk: int,
                   causal: bool, kv_tile: int, per_tile: int,
                   sm_scale: float, lens=None) -> torch.Tensor:
    """Write the ordered sum of ``parts`` (``[P, B, Lq, hd]`` fp32, the
    backward's slabs) times ``sm_scale`` into ``dq`` (``[B, Lq, hd]`` of
    bf16 or fp32, unit stride along ``hd`` and rows evenly spaced: a column
    slice of a packed gradient will do) and return ``dq``. ``lk``,
    ``causal`` and ``lens`` (``[B]`` int32 key lengths or None) are the
    backward's; ``kv_tile`` and ``per_tile`` its body's
    (``dq_parts_geometry``).

    A CUDA tensor launches the kernel on the current stream (one counted
    launch in ``dq_ordered_sum.launches``); a CPU tensor runs
    ``dq_ordered_sum_reference``. Raises on mismatched shapes, types or
    devices and on layouts the kernel does not take."""
    if parts.dim() != 4 or parts.dtype != torch.float32 \
            or not parts.is_contiguous():
        raise ValueError(f"dq_ordered_sum: parts must be contiguous fp32 "
                         f"[P, B, Lq, hd], got {tuple(parts.shape)} "
                         f"{parts.dtype}")
    _, b, lq, hd = parts.shape
    if tuple(dq.shape) != (b, lq, hd) or dq.dtype not in (torch.bfloat16,
                                                         torch.float32):
        raise ValueError(f"dq_ordered_sum: dq must be [B, Lq, hd] = "
                         f"{(b, lq, hd)} of bf16 or fp32, got "
                         f"{tuple(dq.shape)} {dq.dtype}")
    if dq.stride(2) != 1 or dq.stride(0) != lq * dq.stride(1) \
            or dq.device != parts.device:
        raise ValueError("dq_ordered_sum: dq must have unit stride along hd, "
                         "evenly spaced rows and parts' device")
    if parts.device.type == "cpu":
        dq.copy_(dq_ordered_sum_reference(parts, lk, causal, kv_tile,
                                          per_tile, sm_scale, dq.dtype,
                                          lens))
        return dq
    if parts.device.type != "cuda":
        raise ValueError(f"dq_ordered_sum: unsupported device "
                         f"{parts.device}")
    if hd % 4 or parts.data_ptr() % 16 or dq.data_ptr() % 8:
        raise ValueError("dq_ordered_sum: hd must be a multiple of 4, parts "
                         "16-byte and dq 8-byte aligned")
    if lens is not None:
        if lens.dtype != torch.int32 or tuple(lens.shape) != (b,) \
                or lens.device != parts.device or not lens.is_contiguous():
            raise ValueError("dq_ordered_sum: lens must be contiguous int32 "
                             "[B] on parts' device")
    lib = _build.load("dq_ordered_sum", _ARGTYPES)
    with torch.cuda.device(parts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dq_ordered_sum(
            parts.data_ptr(), b * lq * hd, dq.data_ptr(), dq.stride(1),
            None if lens is None else lens.data_ptr(), lq, lk, hd,
            int(bool(causal)), kv_tile, per_tile, float(sm_scale),
            int(dq.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"dq_ordered_sum: kernel launch failed "
                           f"(cudaError {rc})")
    dq_ordered_sum.launches += 1
    return dq


dq_ordered_sum.launches = 0
