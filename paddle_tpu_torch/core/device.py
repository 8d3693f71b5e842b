"""Device resolution (counterpart of ``paddle_tpu/core/device.py``).

The port runs on the GPU. ``resolve_device()`` with no argument returns
``cuda:0`` and raises when CUDA is absent; the CPU is used only when the
caller asks for it (the CPU tests do), never as a silent fallback.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; a string or ``torch.device`` is taken as
    given. Raises ``RuntimeError`` when the resolved device is CUDA and
    CUDA is not available."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on the GPU by default "
                "(pass device='cpu' to run the plain versions on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
