"""Hand-written Hopper kernels of the port, each beside its plain version:

* ``flash_pair_fwd`` (``csrc/flash_pair_fwd.cu``) and ``flash_pair_bwd``
  (``csrc/flash_pair_bwd.cu``), the flash-attention forward and backward
  over the packed qkv layout with in-kernel dropout, tied together under
  autograd by ``FlashPairPacked`` (GPT, BERT, and
  ``flash_attention_qkv_packed``, the packed-qkv call for heads of a
  multiple of 128);
* ``flash_attention_fwd`` (``csrc/flash_attention_fwd.cu``) and
  ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``), the same on
  the ``[B, L, H, D]`` layout with grouped-query attention, per-sequence
  key lengths, segment ids and in-kernel dropout, tied together by
  ``FlashAttention`` (LLaMA, BERT's padded batches, ``F.flash_attention``
  and ``F.scaled_dot_product_attention`` without an additive mask);
* ``dq_ordered_sum`` (``csrc/dq_sum.cu``), the last step of both flash
  backwards: their bodies store dq's partials a kv tile apart and this
  kernel adds them in kv-tile order, so every gradient is the same bit for
  bit from call to call;
* ``dropout_fwd`` (``csrc/dropout.cu``), dropout with the mask drawn in the
  kernel, forward and backward under ``DropoutFunction`` (``F.dropout``);
* ``fused_add_dropout_ln_fwd`` (``csrc/fused_residual_fwd.cu``) and
  ``fused_add_dropout_ln_bwd`` (``csrc/fused_residual_bwd.cu``),
  ``LayerNorm(x + dropout(sub))`` in one pass each way, under
  ``FusedAddDropoutLN`` (``F.add_dropout_ln``, BERT).

Every dropout draws its bits from one counter-based Philox4x32-10
(``csrc/philox.cuh``, plain version ``philox.py``), keyed on the element,
so a kernel and its plain version drop the same elements.

Every wrapper counts its launches in a plain integer attribute
(``<wrapper>.launches``); ``launch_counts()`` reads them all and
``reset_launch_counts()`` zeroes them, so a run can show that its main path
went through the kernels. The four flash wrappers also count the launches
of the wide-head bodies: ``csrc/flash_wide_sm90.cuh`` (bf16 heads above 256
both ways, the bf16 backward at 256) in ``<wrapper>.wide_launches``, read by
``wide_launch_counts()``, and ``csrc/flash_f32_wide.cuh`` (fp32 heads above
256 both ways) in ``<wrapper>.f32_wide_launches``, read by
``f32_wide_launch_counts()``. The fp32 bodies at heads up to 256 (of
``csrc/flash_f32_wide.cuh`` too) are counted apart: the forward
(``flash_fwd_f32_small_kernel``) by the two forward wrappers in
``<wrapper>.f32_fwd_launches``, read by ``f32_fwd_launch_counts()``, the
backward (``flash_bwd_f32_kernel``) by the two backward wrappers in
``<wrapper>.f32_bwd_launches``, read by ``f32_bwd_launch_counts()``. The
backward wrappers also count the bf16 backward at heads of 80 and 96
(``csrc/flash_bwd_sm90.cuh`` on 32-byte swizzle blocks) in
``<wrapper>.sw32_bwd_launches``, read by ``sw32_bwd_launch_counts()``.

A wrapper counts when Python calls it, which a CUDA graph's replay does
not: a captured program (``core/programs.py``) takes the counts its
capture added back out (``count_snapshot``, ``add_counts``), keeps them,
and adds them again at each replay, so the counts are the launches the
device ran.
"""
from .dq_sum import dq_ordered_sum, dq_ordered_sum_reference
from .dropout import DropoutFunction, dropout_fwd, dropout_fwd_reference
from .flash_attention import (FlashAttention, flash_attention_bwd,
                              flash_attention_bwd_reference,
                              flash_attention_fwd,
                              flash_attention_fwd_reference,
                              flash_attention_qkv_packed)
from .flash_pair import (FlashPairPacked, flash_pair_bwd,
                         flash_pair_bwd_reference, flash_pair_fwd,
                         flash_pair_fwd_reference, pair_layout_supported)
from .fused_residual import (FusedAddDropoutLN, fused_add_dropout_ln_bwd,
                             fused_add_dropout_ln_bwd_reference,
                             fused_add_dropout_ln_fwd,
                             fused_add_dropout_ln_fwd_reference)

__all__ = ["flash_pair_fwd", "flash_pair_fwd_reference", "flash_pair_bwd",
           "flash_pair_bwd_reference", "FlashPairPacked",
           "pair_layout_supported", "flash_attention_fwd",
           "flash_attention_fwd_reference", "flash_attention_bwd",
           "flash_attention_bwd_reference", "FlashAttention",
           "flash_attention_qkv_packed", "dq_ordered_sum",
           "dq_ordered_sum_reference",
           "dropout_fwd", "dropout_fwd_reference", "DropoutFunction",
           "fused_add_dropout_ln_fwd", "fused_add_dropout_ln_fwd_reference",
           "fused_add_dropout_ln_bwd", "fused_add_dropout_ln_bwd_reference",
           "FusedAddDropoutLN", "launch_counts", "reset_launch_counts",
           "wide_launch_counts", "f32_wide_launch_counts",
           "f32_fwd_launch_counts", "f32_bwd_launch_counts",
           "sw32_bwd_launch_counts", "count_snapshot", "add_counts"]

WRAPPERS = {"flash_pair_fwd": flash_pair_fwd,
            "flash_pair_bwd": flash_pair_bwd,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd,
            "dq_ordered_sum": dq_ordered_sum,
            "dropout_fwd": dropout_fwd,
            "fused_add_dropout_ln_fwd": fused_add_dropout_ln_fwd,
            "fused_add_dropout_ln_bwd": fused_add_dropout_ln_bwd}


# the wrappers that also count their wide-head bodies' launches, and of
# them the forward ones, which count one more body, and the backward ones,
# which count two more
WIDE_WRAPPERS = ("flash_pair_fwd", "flash_pair_bwd", "flash_attention_fwd",
                 "flash_attention_bwd")
FWD_WRAPPERS = ("flash_pair_fwd", "flash_attention_fwd")
BWD_WRAPPERS = ("flash_pair_bwd", "flash_attention_bwd")


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def wide_launch_counts() -> dict:
    return {name: WRAPPERS[name].wide_launches for name in WIDE_WRAPPERS}


def f32_wide_launch_counts() -> dict:
    return {name: WRAPPERS[name].f32_wide_launches for name in WIDE_WRAPPERS}


def f32_fwd_launch_counts() -> dict:
    return {name: WRAPPERS[name].f32_fwd_launches for name in FWD_WRAPPERS}


def f32_bwd_launch_counts() -> dict:
    return {name: WRAPPERS[name].f32_bwd_launches for name in BWD_WRAPPERS}


def sw32_bwd_launch_counts() -> dict:
    return {name: WRAPPERS[name].sw32_bwd_launches for name in BWD_WRAPPERS}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
    for name in WIDE_WRAPPERS:
        WRAPPERS[name].wide_launches = 0
        WRAPPERS[name].f32_wide_launches = 0
    for name in FWD_WRAPPERS:
        WRAPPERS[name].f32_fwd_launches = 0
    for name in BWD_WRAPPERS:
        WRAPPERS[name].f32_bwd_launches = 0
        WRAPPERS[name].sw32_bwd_launches = 0


def _counters():
    """Every (wrapper, attribute) pair that counts launches."""
    out = [(fn, "launches") for fn in WRAPPERS.values()]
    out += [(WRAPPERS[n], a) for n in WIDE_WRAPPERS
            for a in ("wide_launches", "f32_wide_launches")]
    out += [(WRAPPERS[n], "f32_fwd_launches") for n in FWD_WRAPPERS]
    out += [(WRAPPERS[n], a) for n in BWD_WRAPPERS
            for a in ("f32_bwd_launches", "sw32_bwd_launches")]
    return out


def count_snapshot() -> tuple:
    """Every launch counter's value, in ``_counters()`` order."""
    return tuple(getattr(fn, a) for fn, a in _counters())


def add_counts(delta, times: int = 1):
    """Add ``times`` x ``delta`` (a difference of two ``count_snapshot()``
    readings) to the counters."""
    for (fn, a), d in zip(_counters(), delta):
        if d:
            setattr(fn, a, getattr(fn, a) + times * d)
