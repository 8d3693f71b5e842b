"""Serving: the decode engine with continuous batching.

    from paddle_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(model, max_slots=16, max_len=256, block_size=16,
                       prefill_chunk=32)   # None: whole-prompt buckets
    req = eng.submit(prompt_ids, max_new_tokens=64)
    eng.run()                      # or eng.step() inside a serving loop
    print(req.output_tokens, eng.stats()["compile_count"])

``DecodeEngine(model, paged=False)`` serves from a row cache (each slot
owns a ``max_len`` row, bucketed prefill), ``quantize="int8"`` swaps the
model's Linear layers for ``Int8Linear`` in place
(``quantize_for_serving``), and ``drafter=`` (``PromptLookupDrafter()``,
``DraftModelDrafter(small_model)``, ``EarlyExitDrafter(model)``) turns on
speculative decoding. The engine's steps are fixed-shape programs: CUDA
graphs on the card. ``generate_via_engine`` is
``model.generate(use_engine=True)``.
"""
from ..quantization import Int8Linear
from .engine import DecodeEngine, generate_via_engine, quantize_for_serving
from .pager import TRASH_BLOCK, BlockPager, prefix_digest
from .scheduler import (TERMINAL_STATUSES, AdmissionQueue, Request,
                        SlotAllocator)
from .spec import (DraftModelDrafter, Drafter, EarlyExitDrafter,
                   PromptLookupDrafter)

__all__ = ["DecodeEngine", "generate_via_engine", "quantize_for_serving",
           "Int8Linear", "Drafter", "PromptLookupDrafter",
           "DraftModelDrafter", "EarlyExitDrafter", "Request", "BlockPager",
           "prefix_digest", "TRASH_BLOCK", "TERMINAL_STATUSES",
           "AdmissionQueue", "SlotAllocator"]
