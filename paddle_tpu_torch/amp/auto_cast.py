"""``auto_cast`` and ``decorate`` (counterpart of
``paddle_tpu/amp/auto_cast.py``).

O1 casts by op: the white list runs in the low type, the black list in
fp32, the rest as its inputs come (``core/amp_state.py`` names torch calls
and the port's ops by the JAX package's op names). O2 casts every named op
outside the black list to the low type; ``decorate`` casts the fp32
parameters to the low type and turns on the optimizers' fp32 masters.

The low type is bf16 by default. fp16 casts as the reference's does, but
the port's kernels take bf16 and fp32 only: an fp16 tensor that reaches
one raises (ROADMAP lists the fp16 kernels as not ported).
"""
from __future__ import annotations

import torch

from ..core.amp_state import AmpAttrs, applied

__all__ = ["auto_cast", "amp_guard", "decorate"]


def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """A context in which the named ops cast their floating inputs by the
    ``level``'s rule; ``custom_white_list`` / ``custom_black_list`` add op
    names to the lists (a name in both is black)."""
    return applied(AmpAttrs(enable, dtype, level, custom_white_list,
                            custom_black_list))


amp_guard = auto_cast


def _low(dtype):
    return torch.bfloat16 if str(dtype) in ("bfloat16", "bf16",
                                            "torch.bfloat16") \
        else torch.float16


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 decoration: every fp32 parameter of ``models`` is cast to the low
    type in place (the same ``Parameter`` objects, so an optimizer built on
    them keeps them), and each optimizer keeps fp32 masters
    (``multi_precision``, or ``master_weight`` where given). Decorate
    before the first step: masters are made at a parameter's first
    update. Returns the models, or ``(models, optimizers)`` when
    optimizers are given, in the form they came. O1 changes nothing."""
    single_model = not isinstance(models, (list, tuple))
    single_opt = optimizers is not None and \
        not isinstance(optimizers, (list, tuple))
    model_list = [models] if single_model else list(models)
    opt_list = [optimizers] if single_opt else list(optimizers or [])
    if level == "O2":
        low = _low(dtype)
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(low)
        for opt in opt_list:
            opt._multi_precision = True if master_weight is None \
                else bool(master_weight)
    if optimizers is None:
        return models if single_model else model_list
    return ((model_list[0] if single_model else model_list),
            (opt_list[0] if single_opt else opt_list))
