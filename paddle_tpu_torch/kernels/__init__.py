"""Hand-written Hopper kernels of the port, each beside its plain version:
``flash_pair_fwd`` (``csrc/flash_pair_fwd.cu``) and ``flash_pair_bwd``
(``csrc/flash_pair_bwd.cu``), the packed flash-attention forward and
backward, tied together under autograd by ``FlashPairPacked``.

Every wrapper counts its launches in a plain integer attribute
(``<wrapper>.launches``); ``launch_counts()`` reads them all and
``reset_launch_counts()`` zeroes them, so a run can show that its main path
went through the kernels.
"""
from .flash_pair import (FlashPairPacked, flash_pair_bwd,
                         flash_pair_bwd_reference, flash_pair_fwd,
                         flash_pair_fwd_reference, pair_layout_supported)

__all__ = ["flash_pair_fwd", "flash_pair_fwd_reference", "flash_pair_bwd",
           "flash_pair_bwd_reference", "FlashPairPacked",
           "pair_layout_supported", "launch_counts", "reset_launch_counts"]

WRAPPERS = {"flash_pair_fwd": flash_pair_fwd,
            "flash_pair_bwd": flash_pair_bwd}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
