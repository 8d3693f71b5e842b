"""Serving: the decode engine with continuous batching, its guardrails,
and the fleet plane around it.

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

Failure is a specified contract (``guardrails.py``): deadlines
(``submit(..., ttft_deadline_s=, deadline_s=)``), ``cancel()``,
``drain()`` / ``drain_on_preemption()``, idempotent ``request_id``s, the
dispatch watchdog (``hang_s``) and the ``PADDLE_SERVE_FAULT`` chaos seam;
every request ends in exactly one of ``TERMINAL_STATUSES``.

The fleet (the JAX package's, host code shared in kind): ``Router`` over
replicas found on a directory (``LocalDirectory`` in process,
``KVDirectory`` over ``distributed.launch.KVServer``), each registered by
an ``EngineEndpoint`` and, across processes, served by a ``DoorServer``
(``HTTPEngineClient`` on the router's side); ``kv_pool=`` (``LocalPool`` /
``KVPool``, ``resolve_kv_pool()``) shares exported prefix blocks between
engines, so a cold replica adopts a warm one's system prompt.
"""
from ..quantization import Int8Linear
from .endpoint import DoorServer, EngineEndpoint, KVDirectory, LocalDirectory
from .engine import (DecodeEngine, EngineHangError, generate_via_engine,
                     quantize_for_serving)
from .guardrails import (DispatchWatchdog, FaultSchedule, InjectedFault,
                         InjectedRouteFault, RouteFaultSchedule)
from .kvpool import KVPool, LocalPool, resolve_kv_pool
from .pager import TRASH_BLOCK, BlockPager, prefix_digest
from .router import (EngineDown, HTTPEngineClient, LocalEngineClient,
                     NoEngineAvailable, RouteTicket, Router)
from .scheduler import (TERMINAL_STATUSES, AdmissionQueue, Request,
                        SlotAllocator)
from .spec import (DraftModelDrafter, Drafter, EarlyExitDrafter,
                   PromptLookupDrafter)

__all__ = ["DecodeEngine", "Request", "generate_via_engine",
           "quantize_for_serving", "Int8Linear", "AdmissionQueue",
           "SlotAllocator", "BlockPager", "TRASH_BLOCK", "TERMINAL_STATUSES",
           "FaultSchedule", "InjectedFault", "DispatchWatchdog",
           "EngineHangError", "Drafter", "PromptLookupDrafter",
           "DraftModelDrafter", "EarlyExitDrafter",
           "Router", "RouteTicket", "LocalEngineClient", "HTTPEngineClient",
           "EngineDown", "NoEngineAvailable", "RouteFaultSchedule",
           "InjectedRouteFault", "EngineEndpoint", "DoorServer",
           "LocalDirectory", "KVDirectory", "prefix_digest",
           "KVPool", "LocalPool", "resolve_kv_pool"]
