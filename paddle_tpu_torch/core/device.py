"""Device resolution and places (counterpart of ``paddle_tpu/core/device.py``).

The port runs on the GPU. ``resolve_device()`` with no argument returns
``cuda:0`` and raises when CUDA is absent; the CPU is used only when the
caller asks for it (the CPU tests do), never as a silent fallback.

The Paddle surface's places: ``Place`` wraps a ``torch.device``;
``CUDAPlace(i)`` is the counterpart of the JAX package's ``TPUPlace``;
``set_device("gpu:0")`` / ``set_device("cpu")`` choose the default place
of ``to_tensor``, the creation ops and ``nn.Layer``'s parameters, which
is the card until the caller says otherwise (``get_default_place``
raises without CUDA, as ``resolve_device`` does).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace",
           "set_device", "get_device", "get_default_place", "chosen_place",
           "device_count", "is_compiled_with_cuda"]


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


class Place:
    """A device place: a ``torch.device``."""

    __slots__ = ("device",)

    def __init__(self, device):
        self.device = torch.device(device)

    @property
    def device_type(self) -> str:
        return self.device.type

    @property
    def device_id(self) -> int:
        return self.device.index or 0

    def is_cpu_place(self) -> bool:
        return self.device.type == "cpu"

    def is_gpu_place(self) -> bool:
        return self.device.type == "cuda"

    def __eq__(self, other):
        return isinstance(other, Place) and self.device == other.device

    def __hash__(self):
        return hash(self.device)

    def __repr__(self):
        kind = "gpu" if self.device.type == "cuda" else self.device.type
        return f"Place({kind}:{self.device_id})"


def CPUPlace() -> Place:
    return Place("cpu")


def CUDAPlace(dev_id: int = 0) -> Place:
    """The card ``dev_id``; raises without CUDA."""
    return Place(resolve_device(f"cuda:{int(dev_id)}"))


_default = [None]   # the place set_device chose; None = the card


def to_place(device) -> Place:
    """A ``Place``, ``torch.device`` or Paddle device string ("gpu",
    "gpu:1", "cuda:0", "cpu") -> ``Place`` (CUDA ones checked)."""
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return Place(resolve_device(device))
    kind, _, idx = str(device).partition(":")
    if kind == "cpu":
        return CPUPlace()
    if kind in ("gpu", "cuda", "tpu", "xpu", "accel"):
        return CUDAPlace(int(idx or 0))
    raise ValueError(f"unknown device string {device!r}")


def set_device(device) -> Place:
    """``set_device("gpu")`` / ``("gpu:0")`` / ``("cpu")``: the default
    place from now on. Returns it."""
    place = to_place(device)
    _default[0] = place
    return place


def chosen_place():
    """The place ``set_device`` chose, or None where it was never
    called."""
    return _default[0]


def get_default_place() -> Place:
    """The place ``set_device`` chose, else the card (raises without
    CUDA)."""
    if _default[0] is None:
        return CUDAPlace(0)
    return _default[0]


def get_device() -> str:
    """``"gpu:0"`` on the card, ``"cpu"`` after ``set_device("cpu")``."""
    p = get_default_place()
    return "cpu" if p.is_cpu_place() else f"gpu:{p.device_id}"


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()
