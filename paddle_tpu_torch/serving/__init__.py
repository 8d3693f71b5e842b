"""Serving: the paged decode engine with continuous batching.

    from paddle_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(model, max_slots=16, max_len=256, block_size=16,
                       prefill_chunk=32)   # None: whole-prompt buckets
    req = eng.submit(prompt_ids, max_new_tokens=64)
    eng.run()                      # or eng.step() inside a serving loop
    print(req.output_tokens, eng.stats()["compile_count"])

The engine's steps are fixed-shape programs: CUDA graphs on the card.
``generate_via_engine`` is ``model.generate(use_engine=True)``.
"""
from .engine import DecodeEngine, generate_via_engine
from .pager import TRASH_BLOCK, BlockPager, prefix_digest
from .scheduler import (TERMINAL_STATUSES, AdmissionQueue, Request,
                        SlotAllocator)

__all__ = ["DecodeEngine", "generate_via_engine", "Request", "BlockPager",
           "prefix_digest", "TRASH_BLOCK", "TERMINAL_STATUSES",
           "AdmissionQueue", "SlotAllocator"]
