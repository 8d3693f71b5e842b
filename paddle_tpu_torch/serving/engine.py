"""Decode engine: block-paged KV cache (or a row cache) + continuous
batching, with speculative decoding and int8 weight-only serving.

Counterpart of ``paddle_tpu/serving/engine.py`` (``DecodeEngine``), over
GPT or LLaMA (``_model_spec``). With ``paged=True`` (the default) the KV
pool is per-layer ``[kv_blocks, block_size, n_kv_heads, head_dim]`` K/V
tensors plus a ``[max_slots, max_blocks_per_slot]`` block table; which
physical block backs which logical position is table DATA owned by the
host-side ``pager.BlockPager`` (free list, refcounts, shared prefix
blocks, the persistent prefix LRU, copy-on-write decisions). Each
scheduler iteration:

* admits queued requests into free slots, adopting any shared prompt
  prefix (co-resident tenants or parked LRU blocks);
* advances every in-flight prefill by one ``[1, sc]`` chunk, where ``sc``
  is ``prefill_chunk``, or (``prefill_chunk=None``) the smallest of
  ``prefill_buckets`` that holds the whole prompt;
* runs one ``[max_slots, 1]`` decode step over every slot (a slot that is
  not decoding, free or mid-prefill, sits at position 0 behind an
  all-trash table row, so its writes land in trash block 0), or, with a
  ``drafter`` (``spec.py``), one ``[1, vw]`` verify call per live slot
  that scores the carried token and up to ``vw - 1`` drafts and emits the
  longest agreeing prefix plus the verifier's own next token.

``paged=False`` keeps the slot-owns-a-row layout, the control arm of the
paged benches: per-layer ``[max_slots, max_len, n_kv_heads, head_dim]``
buffers, one whole-prompt ``[1, sb]`` prefill per bucket at admission
(written into the slot's row, its padded tail too: the causal mask hides
it), and the ``[max_slots, 1]`` decode step at each row's cursor.

The steps are fixed-shape programs (``core/programs.py``: one per kind
and shape, a CUDA graph captured at its first call on the card, the eager
step on the CPU), and ``compile_count`` counts the programs built: flat
in steady state. Every input that changes per call is data in a
program's static buffers: token ids, the table, the slot, cursors, the
end of valid positions, the copy-on-write pairs the pager reports
(applied inside the program before anything reads or writes the pools,
as ``max_slots`` (src, dst) pairs padded with (0, 0) trash no-ops) and,
when sampling, the key ``(seed, step)`` whose step the program advances
itself. The caches are updated in place. Pool pressure preempts the
youngest tenant back to the head of the queue (recompute on
re-admission), and a slot whose logits go non-finite fails alone.

``quantize="int8"`` swaps every ``nn.Linear`` but the LM head for a
``quantization.Int8Linear`` in place (``quantize_for_serving``) before
any program is built: the same programs then run int8 products.
"""
from __future__ import annotations

import itertools
import time
import weakref
from functools import partial
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from torch import nn

from ..core.programs import (ProgramRegistry, StagedInputs, leaf_addresses,
                             serving_mode)
from ..models.gpt import (_as_ids, _check_seed, _lm_head_logits,
                          _pick_token, _resolve_decode_horizon)
from .pager import TRASH_BLOCK, BlockPager
from .scheduler import (TERMINAL_STATUSES, AdmissionQueue, Request,
                        SlotAllocator)

__all__ = ["DecodeEngine", "Request", "TERMINAL_STATUSES",
           "generate_via_engine", "quantize_for_serving"]


class ModelSpec(NamedTuple):
    """What the engine drives: the cached-forward backbone and the KV
    cache's geometry."""
    backbone: torch.nn.Module
    num_layers: int
    num_kv_heads: int
    head_dim: int


def _model_spec(model) -> ModelSpec:
    """Resolve the causal-LM surface the engine drives (the JAX package's
    ``_model_spec``), duck-typed over ``GPTForCausalLM`` (``model.gpt``)
    and ``LlamaForCausalLM`` (``model.model``, pools sized by the KV head
    count): both backbones take ``(ids, kv_caches=, start_pos=,
    write_end=)`` and return hidden states, and both models expose
    ``head_weight``."""
    cfg = getattr(model, "config", None)
    if cfg is None:
        raise TypeError(f"{type(model).__name__} has no .config: the "
                        f"engine serves GPT/LLaMA-style causal LMs")
    head_dim = cfg.hidden_size // cfg.num_heads
    if hasattr(model, "gpt"):                       # GPTForCausalLM
        return ModelSpec(model.gpt, cfg.num_layers, cfg.num_heads, head_dim)
    if hasattr(model, "model"):                     # LlamaForCausalLM
        return ModelSpec(model.model, cfg.num_layers, cfg.num_kv_heads,
                         head_dim)
    raise TypeError(f"cannot resolve a decode backbone on "
                    f"{type(model).__name__}")


def quantize_for_serving(model, skip=()):
    """Weight-only int8 conversion of every ``nn.Linear`` of ``model`` IN
    PLACE (the JAX package's ``quantize_for_serving``): each becomes a
    ``quantization.Int8Linear`` (per-output-channel int8 weights, per-token
    activation scales at run time), and the float weight it held is
    dropped with it. The LM head is always kept (the engine's head product
    reads its raw weight, and its logits are the most quantization-
    sensitive tensor of the model); ``skip`` names more layers (by
    identity) to keep. Returns ``model`` (the replacement when ``model``
    itself is a Linear)."""
    from ..quantization import Int8Linear

    keep = {id(s) for s in skip if s is not None}
    head = getattr(model, "lm_head", None)
    if head is not None:
        keep.add(id(head))

    def swap(layer):
        if isinstance(layer, nn.Linear) and id(layer) not in keep:
            return Int8Linear.from_linear(layer)
        for name, child in list(layer.named_children()):
            new = swap(child)
            if new is not child:
                setattr(layer, name, new)
        return layer

    return swap(model)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"DecodeEngine: {what} is not ported yet "
                              f"(ROADMAP {item})")


class _PrefillState:
    """One slot's in-flight chunked prefill: which prompt positions are
    cached so far (shared-prefix coverage counts) and the pending COW
    copies the next chunk call must apply."""

    __slots__ = ("req", "prompt", "n", "done", "pending_copies", "chunks")

    def __init__(self, req: Request, start: int, pending_copies):
        self.req = req
        self.prompt = np.asarray(req.prompt, np.int64)
        self.n = len(req.prompt)
        self.done = int(start)            # positions already cached
        self.pending_copies = list(pending_copies)
        self.chunks = 0


class _Step(NamedTuple):
    """The static buffers of one program: its staged int64 inputs and its
    int64 output (``[2, B]``: the picked tokens and the finite-logits
    flags)."""
    inputs: StagedInputs
    out: torch.Tensor


class DecodeEngine:
    """Serving engine over one ``GPTForCausalLM`` or ``LlamaForCausalLM``.

    Knobs:
      max_slots        batch rows of the decode step (concurrent requests)
      max_len          per-slot KV horizon; prompt + new tokens must fit
      paged            block page table (default) or the row cache (each
                       slot owns a ``max_len`` row; bucketed prefill)
      block_size       tokens per KV block (paged)
      kv_blocks        physical pool size incl. the reserved trash block;
                       default max_slots*ceil(max_len/block_size)+1 — set
                       it SMALLER to oversubscribe (prefix sharing and
                       preemption make that safe)
      prefill_chunk    paged only: at most this many prompt tokens run per
                       scheduler iteration, through one ``[1,
                       prefill_chunk]`` call; None: each prompt prefills in
                       one call of the smallest bucket that holds it whole
      prefill_buckets  the chunk widths of ``prefill_chunk=None`` and the
                       row cache's prefill widths (default 8, 16, 32, ...
                       below max_len, then max_len); a longer prompt fails
                       at submit
      max_queue        admission-queue bound; a full queue answers
                       ``rejected_overload`` (None: unbounded)
      quantize         None, or "int8": ``quantize_for_serving`` on the
                       model, in place, before any program is built
      do_sample, temperature, top_k, seed
                       the sampling config, static per engine (greedy by
                       default); the key stream advances once per call
      drafter          a ``spec.Drafter``: speculative decoding (paged and
                       greedy only; the verify width is ``min(max(2,
                       drafter.max_k + 1), max_len)``)

    The JAX engine's other knobs (``kv_pool``, ``hang_s``,
    ``fault_schedule``) raise ``NotImplementedError`` naming the ROADMAP
    item that ports them.
    """

    def __init__(self, model, *, max_slots: int = 8, max_len: int = 256,
                 paged: bool = True, block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_buckets=None, max_queue: Optional[int] = 1024,
                 quantize: Optional[str] = None, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, seed: int = 0,
                 hang_s: Optional[float] = None, fault_schedule=None,
                 drafter=None, kv_pool=None):
        if kv_pool is not None:
            _not_ported("the cross-process KV pool", "Queue 1, item 9")
        if hang_s or fault_schedule is not None:
            _not_ported("the guardrail plane (hang_s, fault_schedule)",
                        "Queue 1, item 8")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', "
                             f"got {quantize!r}")
        cfg = model.config
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len {max_len} exceeds the model's position horizon "
                f"({cfg.max_position_embeddings})")
        spec = _model_spec(model)
        self.model = model
        self._spec = spec
        self.backbone = spec.backbone
        self.quantize = quantize
        self.paged = bool(paged)
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self._do_sample = bool(do_sample)
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        # speculative decoding (spec.py): a drafter guesses up to vw - 1
        # tokens, ONE [1, vw] verify call scores them all, and the longest
        # agreeing prefix plus the verifier's next token are emitted.
        # Greedy only: acceptance is argmax agreement, so the output is the
        # sequential greedy decode's
        self.drafter = drafter
        self._spec_width = None
        if drafter is not None:
            if not self.paged:
                raise NotImplementedError(
                    "speculative decoding requires paged=True (draft K/V "
                    "lands in speculatively reserved pager blocks)")
            if self._do_sample:
                raise NotImplementedError(
                    "speculative decoding is greedy-only (acceptance is "
                    "argmax agreement; sampling would need a rejection-"
                    "sampling rule)")
            self._spec_width = int(min(
                max(2, int(getattr(drafter, "max_k", 4)) + 1), max_len))
        if prefill_buckets is None:
            buckets, width = [], 8
            while width < self.max_len:
                buckets.append(width)
                width *= 2
            buckets.append(self.max_len)
        else:
            buckets = [int(w) for w in prefill_buckets]
            if any(w < 1 or w > self.max_len for w in buckets):
                raise ValueError(f"prefill_buckets must lie in "
                                 f"[1, max_len={self.max_len}]: {buckets}")
        self.prefill_buckets = sorted(set(buckets))
        head = model.head_weight
        self.device = head.device
        geom = (spec.num_kv_heads, spec.head_dim)
        if self.paged:
            if block_size < 1:
                raise ValueError(f"block_size must be >= 1, got {block_size}")
            self.block_size = int(min(block_size, self.max_len))
            self._mbs = -(-self.max_len // self.block_size)
            if kv_blocks is None:
                kv_blocks = self.max_slots * self._mbs + 1
            if kv_blocks < self._mbs + 2:
                raise ValueError(
                    f"kv_blocks {kv_blocks} cannot back even one full slot "
                    f"({self._mbs} blocks + trash)")
            self.kv_blocks = int(kv_blocks)
            if prefill_chunk is not None \
                    and not 1 <= int(prefill_chunk) <= self.max_len:
                raise ValueError(f"prefill_chunk must lie in [1, max_len="
                                 f"{self.max_len}], got {prefill_chunk}")
            self.prefill_chunk = None if prefill_chunk is None \
                else int(prefill_chunk)
            # every layer's K and V pool in one tensor, so a program copies
            # the copy-on-write blocks of all of them in one gather and one
            # scatter; _pools[l] = (K, V) of layer l, contiguous views
            self._kv = torch.zeros(spec.num_layers, 2, self.kv_blocks,
                                   self.block_size, *geom, dtype=head.dtype,
                                   device=self.device)
            self._pools = [(kv[0], kv[1]) for kv in self._kv]
            self._pager = BlockPager(self.kv_blocks, self.block_size,
                                     self.max_slots, self._mbs)
        else:
            if prefill_chunk is not None:
                raise ValueError("prefill_chunk requires paged=True")
            self.block_size = self.kv_blocks = self.prefill_chunk = None
            self._pager = None
            # the row cache: layer l's K and V rows are _rows[l, 0], [l, 1]
            self._rows = torch.zeros(spec.num_layers, 2, self.max_slots,
                                     self.max_len, *geom, dtype=head.dtype,
                                     device=self.device)
            self._caches = [(kv[0], kv[1]) for kv in self._rows]
        # the int8 swap comes after every check: a refused engine leaves
        # the model as it was
        if quantize == "int8":
            quantize_for_serving(model)
        # every parameter and buffer the programs read (an int8 swap
        # replaces both): a cached engine whose list no longer matches the
        # model's is stale (generate_via_engine)
        self._leaves = list(model.parameters()) + list(model.buffers())
        # the sampling key (seed, step): device data every sampling
        # program reads and advances by one
        self._key = torch.tensor([_check_seed(seed), 0], dtype=torch.int64,
                                 device=self.device)
        # programs run and capture in eval mode with autograd off
        self._programs = ProgramRegistry(self.device,
                                         partial(serving_mode, model))
        # in-flight chunked prefills: slot -> _PrefillState (paged only;
        # the row cache prefills at admission)
        self._prefilling: dict = {}
        self._admit_seq = itertools.count()   # eviction picks the youngest
        self._slot_seq = [0] * self.max_slots
        self.preemptions = 0
        # host-side slot state: cursors / last token per row; dead rows sit
        # at pos 0 (paged: behind an all-trash table row)
        self._pos = np.zeros(self.max_slots, np.int64)
        self._tok = np.zeros(self.max_slots, np.int64)
        self._live = np.zeros(self.max_slots, bool)
        self._slot_req: List[Optional[Request]] = [None] * self.max_slots
        self._slots = SlotAllocator(self.max_slots)
        self._queue = AdmissionQueue(max_queue)
        # terminal transitions made between steps (cancel()): the next
        # step() returns them
        self._terminal_buf: List[Request] = []
        self.decode_steps = 0
        self.prefill_calls = 0
        self.tokens_generated = 0
        self.nan_logits = 0
        self.cancelled = 0
        # speculation: verify calls, drafts proposed, drafts accepted,
        # tokens emitted by verify calls (accepted + the verifier's own)
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0

    @property
    def compile_count(self) -> int:
        """Programs built (the serving recompile sentinel): one per kind
        and shape, and again after the parameters' storage changed."""
        return self._programs.count

    def _reseed(self, seed: int):
        """Restart the key stream at ``(seed, 0)`` and, when the engine is
        idle, the slot order and the prefix cache with it: a draw is per
        batch row, so the same requests reproduce only in the same slots
        (the JAX package's reuse of a sampling engine), and a prefix-cache
        hit would change how many chunk calls, and so which keys, a
        request takes. Nothing is rebuilt."""
        self._key.copy_(torch.tensor([_check_seed(seed), 0]))
        if not self.active_count and not self._queue:
            self._slots = SlotAllocator(self.max_slots)
            if self.paged:
                self._pager.drop_prefix_cache()

    # -------------------------------------------------------- device calls

    def _pick(self, logits):
        """The token of each row (``_pick_token`` under the engine's
        sampling config); a sampling pick advances the key's step."""
        if not self._do_sample:
            return _pick_token(logits)
        tok = _pick_token(logits, self._key, True, self._temperature,
                          self._top_k)
        self._key[1:].add_(1)
        return tok

    def _apply_cow(self, src, dst):
        """Apply copy-on-write block copies inside a program, ``pools[l][
        dst[i]] = pools[l][src[i]]`` for every layer's K and V before the
        call reads or writes anything. ``src``/``dst`` are ``[max_slots]``
        device tensors padded with (0, 0) trash-to-trash no-ops."""
        self._kv.index_copy_(2, dst, self._kv.index_select(2, src))

    def _stage_cow(self, inputs: StagedInputs, copies):
        """The pager's (src, dst) pairs into a program's ``cow`` input,
        padded with (0, 0); more than ``max_slots`` pairs raise (a copy is
        never dropped)."""
        if len(copies) > self.max_slots:
            raise RuntimeError(f"{len(copies)} copy-on-write pairs exceed "
                               f"the program's {self.max_slots}")
        cow = inputs.host["cow"]
        cow.fill(0)
        for i, (src, dst) in enumerate(copies):
            cow[0, i], cow[1, i] = src, dst

    def _program(self, key, build):
        """The program under ``key``, rebuilt (and counted) when a
        parameter's storage moved since the programs were captured."""
        self._programs.validate(leaf_addresses(self.model))
        return self._programs.get(key, build)

    def _build_slot_call(self, width: int, every_position: bool):
        """One slot's ``[1, width]`` call through its table ``row`` at
        absolute start ``p0``, K/V written below ``end`` (the padded tail
        goes to trash). A prefill chunk (``every_position=False``) picks
        the token at hidden position ``end - p0 - 1`` by a device index
        and flags that position's logits; the speculative verify picks at
        every position (position i's pick is the model's token after
        ``ids[i]``) and flags the whole window, since a non-finite logit
        anywhere spoils the accept test. Out: ``[2, 1]`` or ``[2,
        width]``, the picks and the finite flag."""
        inputs = StagedInputs(self.device, ids=(1, width),
                              row=(1, self._mbs), p0=(), end=(),
                              cow=(2, self.max_slots))
        out = torch.zeros(2, width if every_position else 1,
                          dtype=torch.int64, device=self.device)
        t = inputs.dev
        # the program holds its engine weakly, so dropping the engine
        # frees its caches and graphs without the cycle collector
        eng = weakref.proxy(self)

        def fn():
            eng._apply_cow(t["cow"][0], t["cow"][1])
            caches = [(pk, pv, t["row"]) for pk, pv in eng._pools]
            hidden = eng.backbone(t["ids"], kv_caches=caches,
                                  start_pos=t["p0"], write_end=t["end"])
            if every_position:
                logits = _lm_head_logits(hidden[0], eng.model.head_weight)
            else:
                last = (t["end"] - t["p0"] - 1).reshape(1)
                logits = _lm_head_logits(hidden.index_select(1, last)[:, 0],
                                         eng.model.head_weight)
            out[0].copy_(eng._pick(logits))
            out[1].copy_(torch.isfinite(logits).all())
        return fn, _Step(inputs, out)

    def _build_decode(self):
        """One token for every slot: ``[max_slots, 1]`` at each row's own
        cursor, through the (trash-masked) table or into the slot's row."""
        s = self.max_slots
        shapes = dict(tok=(s,), pos=(s,))
        if self.paged:
            shapes.update(table=(s, self._mbs), cow=(2, s))
        inputs = StagedInputs(self.device, **shapes)
        out = torch.zeros(2, s, dtype=torch.int64, device=self.device)
        t = inputs.dev
        eng = weakref.proxy(self)

        def fn():
            if eng.paged:
                eng._apply_cow(t["cow"][0], t["cow"][1])
                caches = [(pk, pv, t["table"]) for pk, pv in eng._pools]
            else:
                caches = eng._caches
            hidden = eng.backbone(t["tok"][:, None], kv_caches=caches,
                                  start_pos=t["pos"])
            logits = _lm_head_logits(hidden[:, -1], eng.model.head_weight)
            out[0].copy_(eng._pick(logits))
            out[1].copy_(torch.isfinite(logits).all(dim=-1))
        return fn, _Step(inputs, out)

    def _build_prefill(self, sb: int):
        """Row-cache prefill ``[1, sb]``: the whole prompt, padded to its
        bucket, through the backbone over its own ``[1, sb]`` K/V, which
        then lands at positions ``0 .. sb-1`` of row ``slot`` (a staged
        index: one program a bucket, not one a slot); the padded tail is
        written too and the causal mask hides it. The token is picked from
        the true last position ``n - 1``."""
        spec = self._spec
        inputs = StagedInputs(self.device, ids=(1, sb), slot=(), n=())
        out = torch.zeros(2, 1, dtype=torch.int64, device=self.device)
        small = torch.zeros(spec.num_layers, 2, 1, sb, spec.num_kv_heads,
                            spec.head_dim, dtype=self._rows.dtype,
                            device=self.device)
        caches = [(kv[0], kv[1]) for kv in small]
        t = inputs.dev
        eng = weakref.proxy(self)

        def fn():
            hidden = eng.backbone(t["ids"], kv_caches=caches, start_pos=0)
            eng._rows.narrow(3, 0, sb).index_copy_(2, t["slot"].reshape(1),
                                                   small)
            last = (t["n"] - 1).reshape(1)
            logits = _lm_head_logits(hidden.index_select(1, last)[:, 0],
                                     eng.model.head_weight)
            out[0].copy_(eng._pick(logits))
            out[1].copy_(torch.isfinite(logits).all())
        return fn, _Step(inputs, out)

    def _slot_call(self, key, build, copies, slot: int, ids, p0: int,
                   end: int):
        """Stage and run one slot's ``[1, w]`` call (``_build_slot_call``)
        at absolute start ``p0``: ``ids`` is ``[1, w]`` (padded past
        ``end``, the exclusive end of valid tokens, whose writes go to
        trash). Returns the program's output as numpy."""
        prog = self._program(key, build)
        inputs, out = prog.state
        host = inputs.host
        host["ids"][:] = ids
        host["row"][:] = self._pager.tables[slot:slot + 1]
        host["p0"][...] = p0
        host["end"][...] = end
        self._stage_cow(inputs, copies)
        inputs.upload()
        prog()
        return out.cpu().numpy()

    def _chunk_call(self, copies, slot: int, ids, p0: int, end: int):
        """Run one prefill chunk of ``slot``. Returns (token picked at the
        last valid position, finite-logits flag)."""
        sc = ids.shape[1]
        tok, ok = self._slot_call(
            ("chunk", sc), lambda: self._build_slot_call(sc, False), copies,
            slot, ids, p0, end)[:, 0]
        return int(tok), bool(ok)

    def _verify_call(self, copies, slot: int, ids, p0: int, end: int):
        """Run the speculative verify of ``slot`` over ``ids`` ``[1, vw]``
        (the carried token, then the drafts). Returns (the pick at every
        position, one finite-logits flag over the window)."""
        vw = self._spec_width
        out = self._slot_call(
            ("verify", vw), lambda: self._build_slot_call(vw, True), copies,
            slot, ids, p0, end)
        return out[0], bool(out[1, 0])

    def _decode_call(self, copies):
        """One token for every slot. Returns (picked tokens, per-slot
        finite-logits flags) as numpy arrays."""
        prog = self._program(("decode",), self._build_decode)
        inputs, out = prog.state
        host = inputs.host
        host["tok"][:] = self._tok
        host["pos"][:] = self._pos
        if self.paged:
            # only live rows may write: a slot mid-prefill is not live,
            # sits at position 0 and already owns blocks (perhaps a shared
            # prefix block), so its row reads and writes the trash block
            host["table"][:] = np.where(self._live[:, None],
                                        self._pager.tables, TRASH_BLOCK)
            self._stage_cow(inputs, copies)
        inputs.upload()
        prog()
        nxt, ok = out.cpu().numpy()
        return nxt, ok.astype(bool)

    def _prefill_call(self, slot: int, prompt):
        """Row-cache prefill of ``prompt`` into ``slot``'s row in one call
        of its bucket. Returns (first token, finite-logits flag)."""
        n = len(prompt)
        sb = self._bucket_for(n)                  # validated at submit
        prog = self._program(("prefill", sb),
                             lambda: self._build_prefill(sb))
        inputs, out = prog.state
        host = inputs.host
        host["ids"][:] = 0
        host["ids"][0, :n] = prompt
        host["slot"][...] = slot
        host["n"][...] = n
        inputs.upload()
        prog()
        tok, ok = out.cpu().numpy()[:, 0]
        return int(tok), bool(ok)

    # ------------------------------------------------------------ requests

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None) -> Request:
        """Validate + enqueue one request. A malformed request comes back
        ``failed`` with ``error`` set and is never admitted; one hitting a
        full admission queue comes back ``rejected_overload``."""
        try:
            req = Request(prompt, max_new_tokens=max_new_tokens,
                          eos_token_id=eos_token_id)
        except (TypeError, ValueError, OverflowError) as e:
            req = Request([], max_new_tokens=1)
            self._reject(req, f"invalid request: {e}")
            return req
        n = len(req.prompt)
        need = self._pager.blocks_for(n + req.max_new_tokens) \
            if self.paged else 0
        if n == 0:
            self._reject(req, "empty prompt")
        elif req.max_new_tokens < 1:
            self._reject(req, f"max_new_tokens must be >= 1, "
                              f"got {req.max_new_tokens}")
        elif n >= self.max_len:
            self._reject(req, f"prompt length {n} >= engine max_len "
                              f"{self.max_len} (no room to decode)")
        elif n + req.max_new_tokens > self.max_len:
            self._reject(req, f"prompt {n} + max_new_tokens "
                              f"{req.max_new_tokens} exceeds engine "
                              f"max_len {self.max_len}")
        elif self.paged and need > self._pager.usable_blocks:
            self._reject(req, f"request needs {need} KV blocks, pool holds "
                              f"{self._pager.usable_blocks}")
        elif self.prefill_chunk is None and self._bucket_for(n) is None:
            self._reject(req, f"prompt length {n} exceeds the largest "
                              f"prefill bucket ({self.prefill_buckets[-1]})")
        elif not self._queue.push(req):
            req.status, req.error = "rejected_overload", \
                f"admission queue full ({self._queue.max_queue})"
            req.t_done = time.time()
        return req

    def _bucket_for(self, n: int) -> Optional[int]:
        """The smallest prefill bucket that holds ``n`` tokens (None: no
        bucket does)."""
        for width in self.prefill_buckets:
            if width >= n:
                return width
        return None

    def _chunk_len(self, n: int) -> int:
        """Width of the chunk program serving a length-``n`` prompt: the
        fixed ``prefill_chunk``, else the bucket of the whole prompt, sized
        as if unshared, so prefix sharing never changes which program
        runs."""
        return self.prefill_chunk or self._bucket_for(n)

    def _reject(self, req: Request, why: str):
        req.status, req.error, req.t_done = "failed", why, time.time()

    # ---------------------------------------------------------- scheduling

    @property
    def live_count(self) -> int:
        return int(self._live.sum())

    @property
    def active_count(self) -> int:
        """Admitted concurrent requests: decoding + mid-prefill."""
        return self.live_count + len(self._prefilling)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def step(self) -> List[Request]:
        """ONE iteration of continuous batching: fold queued prompts into
        free slots, advance every in-flight prefill by one chunk, then
        decode every live slot one token.
        Returns every request that reached a terminal status since the
        last step."""
        finished: List[Request] = list(self._terminal_buf)
        self._terminal_buf.clear()
        while self._queue and self._slots.n_free:
            if not self.paged:
                self._admit(self._queue.pop(), self._slots.alloc(), finished)
                continue
            if not self._try_admit(self._queue.peek()):
                break          # head-of-line waits for blocks, FIFO kept
            self._queue.pop()
        for slot in sorted(self._prefilling, key=lambda s: self._slot_seq[s]):
            if slot in self._prefilling:   # an earlier ensure may evict
                self._advance_prefill(slot, finished)
        if self._live.any():
            self._decode(finished)
        return finished

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Step until queue and slots are empty. ``max_steps`` is a hard
        budget: the undrained engine raises after that many steps."""
        out: List[Request] = []
        steps = 0
        while self._queue or self._live.any() or self._prefilling \
                or self._terminal_buf:
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"run() exceeded max_steps={max_steps} with "
                    f"{len(self._queue)} queued / {self.live_count} live")
            out.extend(self.step())
            steps += 1
        return out

    def _release_slot_state(self, slot: int):
        """Return ``slot`` to the allocator and zero its host row — the ONE
        release path shared by finish / preempt / cancel / failure, so a
        request's blocks are released exactly once."""
        self._prefilling.pop(slot, None)
        self._live[slot] = False
        self._pos[slot] = 0
        self._tok[slot] = 0
        self._slot_req[slot] = None
        if self.paged:
            self._pager.release_slot(slot)
        self._slots.release(slot)

    def _terminalize(self, req: Request, status: str, why: str,
                     finished: Optional[List[Request]]):
        """Move ``req`` (slot already released) to a terminal status;
        ``finished=None`` buffers it for the next step()'s return."""
        assert status in TERMINAL_STATUSES and not req.finished
        req.status, req.error = status, why
        req.slot = None
        req.t_done = time.time()
        (self._terminal_buf if finished is None else finished).append(req)
        if status == "cancelled":
            self.cancelled += 1

    def _fail_nan(self, slot: int, req: Request, where: str,
                  finished: List[Request]):
        """Non-finite logits: fail this request alone and free its slot;
        the rest of the batch streams on."""
        self.nan_logits += 1
        self._release_slot_state(slot)
        self._terminalize(req, "failed", f"non-finite logits ({where})",
                          finished)

    def cancel(self, req) -> bool:
        """Cancel one request wherever it is — queued, mid-prefill or
        mid-decode. Takes the Request or its ``.id``. True when it was live
        and is now ``cancelled`` (slot + blocks released); the next step()
        returns it."""
        if not isinstance(req, Request):
            rid, req = req, None
            for cand in list(self._queue) \
                    + [st.req for st in self._prefilling.values()] \
                    + [r for r in self._slot_req if r is not None]:
                if cand.id == rid:
                    req = cand
                    break
            if req is None:
                return False
        if req.finished:
            return False
        if self._queue.remove(req):
            self._terminalize(req, "cancelled", "cancelled while queued",
                              None)
            return True
        for slot, st in list(self._prefilling.items()):
            if st.req is req:
                self._release_slot_state(slot)
                self._terminalize(req, "cancelled", "cancelled mid-prefill",
                                  None)
                return True
        for slot in range(self.max_slots):
            if self._slot_req[slot] is req:
                self._release_slot_state(slot)
                self._terminalize(req, "cancelled", "cancelled mid-decode",
                                  None)
                return True
        return False                     # not this engine's request

    def _admit(self, req: Request, slot: int, finished: List[Request]):
        """Row cache: prefill the whole prompt into ``slot``'s row now and
        emit its first token; non-finite logits fail the request alone."""
        tok0, ok = self._prefill_call(slot, req.prompt)
        self.prefill_calls += 1
        if not ok:
            self._fail_nan(slot, req, "prefill", finished)
            return
        self._go_live(slot, req, tok0, chunks=1, finished=finished)

    def _go_live(self, slot: int, req: Request, tok0: int, chunks: int,
                 finished: List[Request]):
        """The prefill of ``req`` in ``slot`` is done: emit its first token
        and join the decode batch (a drafter restarts its state: the token
        history it derives from restarted too)."""
        req.prefill_chunks = chunks
        req.slot, req.status = slot, "running"
        req.t_first_token = time.time()
        req.tokens.append(tok0)
        self.tokens_generated += 1
        self._pos[slot] = len(req.prompt)
        self._tok[slot] = tok0
        self._live[slot] = True
        self._slot_req[slot] = req
        if self.drafter is not None:
            self.drafter.begin_request(req)
        if req._stop_hit():
            self._finish(req, finished)

    def _try_admit(self, req: Request) -> bool:
        """Assign a slot, adopt any shared prompt prefix, and reserve the
        first chunk's blocks. False = the pool cannot host the first chunk
        right now; the request stays at the head of the queue and the
        pager's sharing counters are left as they were."""
        n = len(req.prompt)
        slot = self._slots.alloc()
        ctrs = self._pager.sharing_counters()
        cov = self._pager.share_prefix(slot, req.prompt)
        end = min(cov + self._chunk_len(n), n)
        copies = self._pager.ensure_writable(slot, cov, end)
        if copies is None:
            self._pager.release_slot(slot)
            self._pager.restore_sharing_counters(ctrs)
            self._slots.release(slot)
            return False
        self._slot_seq[slot] = next(self._admit_seq)
        self._prefilling[slot] = _PrefillState(req, cov, copies)
        req.slot, req.status = slot, "prefilling"
        return True

    def _advance_prefill(self, slot: int, finished: List[Request]):
        """Run ONE chunk of ``slot``'s pending prefill; on the final chunk,
        emit the first generated token and promote the slot to the decode
        batch."""
        st = self._prefilling[slot]
        p0 = st.done
        sc = self._chunk_len(st.n)
        end = min(p0 + sc, st.n)
        copies, st.pending_copies = st.pending_copies, []
        more = self._ensure_or_evict(slot, p0, end)
        if more is None or slot not in self._prefilling:
            return                         # this very slot was preempted
        ids = np.zeros((1, sc), np.int64)
        ids[0, :end - p0] = st.prompt[p0:end]
        tok0, ok = self._chunk_call(copies + more, slot, ids, p0, end)
        self.prefill_calls += 1
        st.done = end
        st.chunks += 1
        if not ok:
            # this chunk's cached K/V are garbage: stop prefilling it
            self._fail_nan(slot, st.req, "chunk", finished)
            return
        if end < st.n:
            return                         # more chunks next iteration
        self._pager.register_prompt(slot, st.prompt)
        del self._prefilling[slot]
        self._go_live(slot, st.req, tok0, st.chunks, finished)

    def _youngest_victim(self, requester: int) -> Optional[int]:
        """Pool-pressure victim: the YOUNGEST tenant, the requester
        included — the oldest tenant is never evicted and always
        progresses, which is what makes eviction churn terminate."""
        cands = [s for s in range(self.max_slots)
                 if s == requester or self._live[s]
                 or s in self._prefilling]
        return max(cands, key=lambda s: self._slot_seq[s], default=None)

    def _preempt(self, slot: int):
        """Evict the tenant of ``slot`` back to the FRONT of the queue: its
        blocks free immediately and its compute is redone on re-admission
        (vLLM's recompute-style preemption)."""
        st = self._prefilling.get(slot)
        req = st.req if st is not None else self._slot_req[slot]
        self._release_slot_state(slot)
        req.status, req.slot = "queued", None
        req.tokens = []
        req.t_first_token = None
        req.preemptions += 1
        req.t_enqueue = time.time()
        self._queue.push_front(req)
        self.preemptions += 1

    def _ensure_or_evict(self, slot: int, start: int, end: int):
        """``ensure_writable`` with pool-pressure eviction: preempt the
        youngest tenants until the range fits. Returns the COW copies, or
        None when ``slot`` itself was the youngest and got preempted."""
        while True:
            copies = self._pager.ensure_writable(slot, start, end)
            if copies is not None:
                return copies
            victim = self._youngest_victim(slot)
            self._preempt(victim)
            if victim == slot:
                return None

    def _ensure_decode_targets(self):
        """Make every live slot's write target private and present, and
        return the copy-on-write pairs that takes. A preempted victim's
        pending copies are DROPPED with it: its freed blocks may be
        re-handed to the very slot being ensured."""
        copies_by_slot = {}
        slot = 0
        while slot < self.max_slots:
            if not self._live[slot]:
                slot += 1
                continue
            p = int(self._pos[slot])
            c = self._pager.ensure_writable(slot, p, p + 1)
            if c is None:
                victim = self._youngest_victim(slot)
                self._preempt(victim)
                copies_by_slot.pop(victim, None)
                if victim == slot:     # self-preempted: skip this row
                    slot += 1
                continue               # else retry the same slot
            copies_by_slot[slot] = c
            slot += 1
        return [p for c in copies_by_slot.values() for p in c]

    def _decode(self, finished: List[Request]):
        if self.drafter is not None:
            self._decode_spec(finished)
            return
        copies = self._ensure_decode_targets() if self.paged else []
        if not self._live.any():       # everyone self-preempted
            return
        nxt, ok = self._decode_call(copies)
        for slot in range(self.max_slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            if not ok[slot]:
                self._fail_nan(slot, req, "decode", finished)
                continue
            t = int(nxt[slot])
            req.tokens.append(t)
            self.tokens_generated += 1
            self._pos[slot] += 1
            self._tok[slot] = t
            if req._stop_hit():
                self._finish(req, finished)
        self.decode_steps += 1

    def _decode_spec(self, finished: List[Request]):
        """Speculative decode step: per live slot, draft up to ``vw - 1``
        tokens, verify the carried token and the drafts in ONE ``[1, vw]``
        call, and emit the longest agreeing prefix plus the verifier's
        token after it. Every emitted token is the one sequential greedy
        decode picks, so EOS and ``max_new_tokens`` are re-checked after
        each and may clip the advance.

        Blocks: the guaranteed target position gets the decode step's
        treatment (``ensure_writable``, preempting the youngest under
        pressure); the draft positions get a best-effort reservation that
        never preempts (``reserve_speculative``: speculation shrinks k to
        what the pool can back, it never evicts a tenant), rolled back
        past the accepted cursor after the verify (``rollback_speculative``:
        copy-on-write sources re-referenced, fresh extensions trashed).
        Rejected drafts' K/V die with the rolled-back blocks or sit above
        the cursor, where the next call overwrites them before any read."""
        vw = self._spec_width
        drafter = self.drafter
        stepped = False
        for slot in range(self.max_slots):
            if not self._live[slot]:
                continue
            req = self._slot_req[slot]
            p = int(self._pos[slot])
            copies = self._ensure_or_evict(slot, p, p + 1)
            if copies is None or not self._live[slot]:
                continue                   # self-preempted: skip this slot
            stepped = True
            remaining = req.max_new_tokens - len(req.tokens)
            k_cap = max(0, min(vw - 1, remaining - 1, self.max_len - 1 - p))
            drafts = []
            if k_cap > 0:
                drafts = [int(t) for t in drafter.propose(req, k_cap)]
                drafts = drafts[:k_cap]
            reservation = []
            if drafts:
                cov_end, rcopies, reservation = \
                    self._pager.reserve_speculative(slot, p + 1,
                                                    p + 1 + len(drafts))
                drafts = drafts[:max(0, cov_end - (p + 1))]
                copies = copies + rcopies
            k = len(drafts)
            ids = np.zeros((1, vw), np.int64)
            ids[0, 0] = self._tok[slot]
            ids[0, 1:1 + k] = drafts
            out, ok = self._verify_call(copies, slot, ids, p, p + 1 + k)
            if not ok:
                # release_slot frees the reservation with the slot's blocks
                self._fail_nan(slot, req, "verify", finished)
                continue
            a = 0
            while a < k and int(out[a]) == drafts[a]:
                a += 1
            n_emit = 0
            for t in drafts[:a] + [int(out[a])]:
                req.tokens.append(int(t))
                self.tokens_generated += 1
                n_emit += 1
                if req._stop_hit():
                    break
            self._pos[slot] = p + n_emit
            self._tok[slot] = req.tokens[-1]
            if reservation:
                self._pager.rollback_speculative(slot, p + n_emit,
                                                 reservation)
            req.spec_drafted += k
            req.spec_accepted += a
            self.spec_steps += 1
            self.spec_drafted += k
            self.spec_accepted += a
            self.spec_emitted += n_emit
            drafter.observe(req, a, k)
            if req._stop_hit():
                self._finish(req, finished)
        if stepped:
            self.decode_steps += 1

    def _finish(self, req: Request, finished: List[Request]):
        self._release_slot_state(req.slot)
        req.status, req.t_done = "done", time.time()
        req.slot = None
        finished.append(req)

    # ------------------------------------------------------------- insight

    def check_invariants(self):
        """Assert the pager's block partition (paged) and that host slot
        state agrees with it: every slot is exactly one of free,
        prefilling or decoding, and a free slot holds no block and sits at
        position 0."""
        if self.paged:
            self._pager.check_invariants()
        live = {int(s) for s in np.flatnonzero(self._live)}
        pref = set(self._prefilling)
        assert not (live & pref), "slot both live and prefilling"
        assert self._slots.n_free == self.max_slots - len(live) - len(pref), \
            "slot allocator out of step with slot state"
        for s in range(self.max_slots):
            req = self._slot_req[s]
            if s in live:
                assert req is not None and req.slot == s \
                    and req.status == "running", f"live slot {s} torn"
            elif s in pref:
                st = self._prefilling[s]
                assert req is None and st.req.slot == s \
                    and st.req.status == "prefilling", f"prefill slot {s}"
            else:
                assert req is None and self._pos[s] == 0 \
                    and (not self.paged
                         or (self._pager.tables[s] == TRASH_BLOCK).all()), \
                    f"free slot {s} holds state"

    def kv_util(self) -> float:
        """Live cached tokens / token capacity: the pool's usable blocks
        (paged), or the whole slot grid (the row cache: what paging exists
        to beat)."""
        cached = int(self._pos[self._live].sum()) \
            + sum(st.done for st in self._prefilling.values())
        if self.paged:
            cap = self._pager.usable_blocks * self.block_size
        else:
            cap = self.max_slots * self.max_len
        return cached / cap if cap else 0.0

    def stats(self) -> dict:
        out = {
            "compile_count": self.compile_count,
            "executables": len(self._programs),
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "tokens_generated": self.tokens_generated,
            "live_slots": self.live_count,
            "queue_depth": self.queue_depth,
            "kv_util": round(self.kv_util(), 4),
            "nan_logits": self.nan_logits,
            "cancelled": self.cancelled,
        }
        if self.paged:
            out["paged"] = dict(self._pager.stats().as_dict(),
                                block_size=self.block_size,
                                preemptions=self.preemptions,
                                prefilling=len(self._prefilling))
        if self.drafter is not None:
            out["spec"] = {
                "drafter": self.drafter.name,
                "width": self._spec_width,
                "steps": self.spec_steps,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "emitted": self.spec_emitted,
                "accepted_per_step": round(
                    self.spec_emitted / self.spec_steps, 4)
                if self.spec_steps else 0.0,
                "draft_hit_rate": round(
                    self.spec_accepted / self.spec_drafted, 4)
                if self.spec_drafted else 0.0,
            }
        return out


# generate_via_engine's engine geometry: a constant slot count, and at most
# this many engines kept on a model
ENGINE_SLOTS = 8
ENGINES_KEPT = 4


def generate_via_engine(lm, input_ids, max_new_tokens: int = 32,
                        temperature: float = 1.0, do_sample: bool = False,
                        top_k: int = 0, eos_token_id=None, seed=None,
                        max_length=None):
    """``model.generate(use_engine=True)``: run the batch through a
    ``DecodeEngine`` and give the ``generate()`` output contract (``[B, s0
    + max_new_tokens]`` int64 on the model's device, the prompt first, a
    row that stopped at EOS filled with EOS).

    One engine per key ``(slots, max_len, do_sample, (temperature, top_k),
    chunk)``: ``max_len`` is the horizon rounded up to a power of two from
    16 and the chunk ``min(32, max_len)``, so callers of other horizons
    share an engine and its programs; at most ``ENGINES_KEPT`` engines are
    kept on the model. A reused sampling engine restarts its key stream
    and its slot order from ``seed`` without a rebuild, so its
    ``compile_count`` stays flat. A cached engine whose list of parameters
    and buffers no longer matches the model's (a module was swapped, as
    ``quantize_for_serving`` does) is dropped, and with it the old weights
    it held."""
    head = lm.head_weight
    ids = _as_ids(input_ids, head.device)
    b, s0 = ids.shape
    max_pos = lm.config.max_position_embeddings
    m, seed = _resolve_decode_horizon(s0, max_new_tokens, max_length,
                                      max_pos, seed, do_sample)
    if max_new_tokens == 0:
        return ids
    ml = 16
    while ml < m:
        ml *= 2
    ml = max(min(ml, max_pos), m)
    chunk = min(32, ml)
    leaves = list(lm.parameters()) + list(lm.buffers())
    key = (ENGINE_SLOTS, ml, do_sample,
           (float(temperature), int(top_k)) if do_sample else None, chunk)
    engines = lm.__dict__.setdefault("_serving_engines", {})
    engine = engines.get(key)
    if engine is not None and (len(leaves) != len(engine._leaves) or any(
            a is not c for a, c in zip(leaves, engine._leaves))):
        del engines[key]
        engine = None
    if engine is None:
        if len(engines) >= ENGINES_KEPT:
            engines.pop(next(iter(engines)))
        engine = DecodeEngine(lm, max_slots=ENGINE_SLOTS, max_len=ml,
                              prefill_chunk=chunk, do_sample=do_sample,
                              temperature=temperature, top_k=top_k,
                              seed=seed)
        engines[key] = engine
    elif do_sample:
        engine._reseed(seed)
    reqs = [engine.submit(row, max_new_tokens=max_new_tokens,
                          eos_token_id=eos_token_id)
            for row in ids.cpu().tolist()]
    engine.run()
    eos = -1 if eos_token_id is None else int(eos_token_id)
    out = np.full((b, s0 + max_new_tokens), max(eos, 0), np.int64)
    out[:, :s0] = ids.cpu().numpy()
    for i, req in enumerate(reqs):
        if req.status != "done":        # validated above: cannot fail
            raise RuntimeError(f"engine request failed: {req.error}")
        toks = req.output_tokens
        out[i, s0:s0 + len(toks)] = toks   # an EOS-stopped tail keeps EOS
    return torch.from_numpy(out).to(head.device)
