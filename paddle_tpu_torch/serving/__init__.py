"""Serving: the paged decode engine with continuous batching.

    from paddle_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(model, max_slots=16, max_len=256, block_size=16,
                       prefill_chunk=32)
    req = eng.submit(prompt_ids, max_new_tokens=64)
    eng.run()                      # or eng.step() inside a serving loop
    print(req.output_tokens)
"""
from .engine import DecodeEngine
from .pager import TRASH_BLOCK, BlockPager, prefix_digest
from .scheduler import (TERMINAL_STATUSES, AdmissionQueue, Request,
                        SlotAllocator)

__all__ = ["DecodeEngine", "Request", "BlockPager", "prefix_digest",
           "TRASH_BLOCK", "TERMINAL_STATUSES", "AdmissionQueue",
           "SlotAllocator"]
