"""Hand-written Hopper kernels of the port, each beside its plain version:

* ``flash_pair_fwd`` (``csrc/flash_pair_fwd.cu``) and ``flash_pair_bwd``
  (``csrc/flash_pair_bwd.cu``), the flash-attention forward and backward
  over the packed qkv layout, tied together under autograd by
  ``FlashPairPacked`` (GPT);
* ``flash_attention_fwd`` (``csrc/flash_attention_fwd.cu``) and
  ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``), the same on
  the ``[B, L, H, D]`` layout with grouped-query attention, tied together
  by ``FlashAttention`` (LLaMA, ``F.flash_attention`` and the no-mask
  ``F.scaled_dot_product_attention``).

Every wrapper counts its launches in a plain integer attribute
(``<wrapper>.launches``); ``launch_counts()`` reads them all and
``reset_launch_counts()`` zeroes them, so a run can show that its main path
went through the kernels.
"""
from .flash_attention import (FlashAttention, flash_attention_bwd,
                              flash_attention_bwd_reference,
                              flash_attention_fwd,
                              flash_attention_fwd_reference)
from .flash_pair import (FlashPairPacked, flash_pair_bwd,
                         flash_pair_bwd_reference, flash_pair_fwd,
                         flash_pair_fwd_reference, pair_layout_supported)

__all__ = ["flash_pair_fwd", "flash_pair_fwd_reference", "flash_pair_bwd",
           "flash_pair_bwd_reference", "FlashPairPacked",
           "pair_layout_supported", "flash_attention_fwd",
           "flash_attention_fwd_reference", "flash_attention_bwd",
           "flash_attention_bwd_reference", "FlashAttention",
           "launch_counts", "reset_launch_counts"]

WRAPPERS = {"flash_pair_fwd": flash_pair_fwd,
            "flash_pair_bwd": flash_pair_bwd,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
