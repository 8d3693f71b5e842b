"""Decode engine: block-paged KV cache + continuous batching.

Counterpart of ``paddle_tpu/serving/engine.py`` (``DecodeEngine`` with
``paged=True`` and a ``prefill_chunk``), over GPT or LLaMA (``_model_spec``).
The KV pool is per-layer ``[kv_blocks, block_size, n_kv_heads, head_dim]``
K/V tensors plus a
``[max_slots, max_blocks_per_slot]`` block table; which physical block
backs which logical position is table DATA owned by the host-side
``pager.BlockPager`` (free list, refcounts, shared prefix blocks, the
persistent prefix LRU, copy-on-write decisions). Each scheduler iteration:

* admits queued requests into free slots, adopting any shared prompt
  prefix (co-resident tenants or parked LRU blocks);
* advances every in-flight prefill by one ``[1, prefill_chunk]`` chunk;
* runs one ``[max_slots, 1]`` decode step over every slot (a slot that is
  not decoding, free or mid-prefill, sits at position 0 behind an
  all-trash table row, so its writes land in trash block 0).

Copy-on-write block copies the pager reports are applied to the pools at
the start of the next chunk or decode call, before anything reads or
writes them. Pool pressure preempts the youngest tenant back to the head
of the queue (recompute on re-admission), and a slot whose logits go
non-finite fails alone.

The steps are eager PyTorch calls; the JAX package's AOT executables and
its ``compile_count`` sentinel map to CUDA-graph capture in a later PR.
The pools are updated in place.
"""
from __future__ import annotations

import itertools
import time
from contextlib import contextmanager
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..models.gpt import _lm_head_logits, _pick_token
from .pager import TRASH_BLOCK, BlockPager
from .scheduler import (TERMINAL_STATUSES, AdmissionQueue, Request,
                        SlotAllocator)

__all__ = ["DecodeEngine", "Request", "TERMINAL_STATUSES"]


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


class DecodeEngine:
    """Paged serving engine over one ``GPTForCausalLM`` or
    ``LlamaForCausalLM``.

    Knobs:
      max_slots      batch rows of the decode step (concurrent requests)
      max_len        per-slot KV horizon; prompt + new tokens must fit
      block_size     tokens per KV block
      kv_blocks      physical pool size incl. the reserved trash block;
                     default max_slots*ceil(max_len/block_size)+1 — set it
                     SMALLER to oversubscribe (prefix sharing and
                     preemption make that safe)
      prefill_chunk  at most this many prompt tokens run per scheduler
                     iteration, through one ``[1, prefill_chunk]`` call
      max_queue      admission-queue bound; a full queue answers
                     ``rejected_overload`` (None: unbounded)

    The JAX engine's other knobs raise ``NotImplementedError`` naming the
    ROADMAP item that ports them.
    """

    def __init__(self, model, *, max_slots: int = 8, max_len: int = 256,
                 paged: bool = True, block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_buckets=None, max_queue: Optional[int] = 1024,
                 quantize: Optional[str] = None, do_sample: bool = False,
                 hang_s: Optional[float] = None, fault_schedule=None,
                 drafter=None, kv_pool=None):
        if not paged:
            _not_ported("the row cache (paged=False)", "Queue 1, item 7")
        if prefill_chunk is None or prefill_buckets is not None:
            _not_ported("monolithic bucketed prefill (pass prefill_chunk)",
                        "Queue 1, item 7")
        if quantize is not None:
            _not_ported("int8 weight quantization", "Queue 1, item 7")
        if do_sample:
            _not_ported("sampling (do_sample)", "Queue 1, item 7")
        if drafter is not None:
            _not_ported("speculative decoding (drafter)", "Queue 1, item 7")
        if kv_pool is not None:
            _not_ported("the cross-process KV pool", "Queue 1, item 9")
        if hang_s or fault_schedule is not None:
            _not_ported("the guardrail plane (hang_s, fault_schedule)",
                        "Queue 1, item 8")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        cfg = model.config
        if max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_len {max_len} exceeds the model's position horizon "
                f"({cfg.max_position_embeddings})")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        spec = _model_spec(model)
        self.model = model
        self.backbone = spec.backbone
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.block_size = int(min(block_size, self.max_len))
        self._mbs = -(-self.max_len // self.block_size)
        if kv_blocks is None:
            kv_blocks = self.max_slots * self._mbs + 1
        if kv_blocks < self._mbs + 2:
            raise ValueError(
                f"kv_blocks {kv_blocks} cannot back even one full slot "
                f"({self._mbs} blocks + trash)")
        self.kv_blocks = int(kv_blocks)
        if not 1 <= int(prefill_chunk) <= self.max_len:
            raise ValueError(f"prefill_chunk must lie in [1, max_len="
                             f"{self.max_len}], got {prefill_chunk}")
        self.prefill_chunk = int(prefill_chunk)
        head = model.head_weight
        self.device = head.device
        self._pools = [
            tuple(torch.zeros(self.kv_blocks, self.block_size,
                              spec.num_kv_heads, spec.head_dim,
                              dtype=head.dtype, device=self.device)
                  for _ in range(2))
            for _ in range(spec.num_layers)]
        self._pager = BlockPager(self.kv_blocks, self.block_size,
                                 self.max_slots, self._mbs)
        # in-flight chunked prefills: slot -> _PrefillState
        self._prefilling: dict = {}
        self._admit_seq = itertools.count()   # eviction picks the youngest
        self._slot_seq = [0] * self.max_slots
        self.preemptions = 0
        # host-side slot state: cursors / last token per row; dead rows sit
        # at pos 0 with an all-trash table row
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

    # -------------------------------------------------------- device calls

    @contextmanager
    def _serving_mode(self):
        """Every module in eval mode and autograd off for the call, then
        each module's OWN training flag restored: an engine must not flip a
        training model's mode as a side effect."""
        mods = list(self.model.modules())
        saved = [m.training for m in mods]
        for m in mods:
            m.training = False
        try:
            with torch.no_grad():
                yield
        finally:
            for m, flag in zip(mods, saved):
                m.training = flag

    def _to_dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.int64,
                               device=self.device)

    def _apply_cow(self, copies):
        """Apply the pager's pending copy-on-write block copies,
        ``pools[l][dst] = pools[l][src]`` for every layer, before the call
        reads or writes anything."""
        if not copies:
            return
        src = self._to_dev([s for s, _ in copies])
        dst = self._to_dev([d for _, d in copies])
        for pool in itertools.chain.from_iterable(self._pools):
            pool.index_copy_(0, dst, pool.index_select(0, src))

    def _chunk_call(self, copies, slot: int, ids, p0: int, end: int):
        """Run one prefill chunk of ``slot`` at absolute start ``p0``:
        ``ids`` is ``[1, prefill_chunk]`` (padded past ``end``, the
        exclusive end of valid tokens, whose writes go to trash). Returns
        (token picked at the last valid position, finite-logits flag)."""
        with self._serving_mode():
            self._apply_cow(copies)
            row = self._to_dev(self._pager.tables[slot:slot + 1])
            caches = [(pk, pv, row) for pk, pv in self._pools]
            hidden = self.backbone(self._to_dev(ids), kv_caches=caches,
                                   start_pos=p0, write_end=end)
            logits = _lm_head_logits(hidden[:, end - p0 - 1],
                                     self.model.head_weight)
            tok = _pick_token(logits)[0]
            ok = torch.isfinite(logits).all()
            return int(tok), bool(ok)

    def _decode_call(self, copies):
        """One token for every slot: ``[max_slots, 1]`` at each row's own
        cursor. Returns (picked tokens, per-slot finite-logits flags) as
        numpy arrays."""
        with self._serving_mode():
            self._apply_cow(copies)
            # only live rows may write: a slot mid-prefill is not live, sits
            # at position 0 and already owns blocks (perhaps a shared prefix
            # block), so its row reads and writes the trash block instead
            table = self._to_dev(np.where(self._live[:, None],
                                          self._pager.tables, TRASH_BLOCK))
            pos = self._to_dev(self._pos)
            caches = [(pk, pv, table) for pk, pv in self._pools]
            hidden = self.backbone(self._to_dev(self._tok)[:, None],
                                   kv_caches=caches, start_pos=pos)
            logits = _lm_head_logits(hidden[:, -1], self.model.head_weight)
            nxt = _pick_token(logits)
            ok = torch.isfinite(logits).all(dim=-1)
            return nxt.cpu().numpy(), ok.cpu().numpy()

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
        need = self._pager.blocks_for(n + req.max_new_tokens)
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
        elif need > self._pager.usable_blocks:
            self._reject(req, f"request needs {need} KV blocks, pool holds "
                              f"{self._pager.usable_blocks}")
        elif not self._queue.push(req):
            req.status, req.error = "rejected_overload", \
                f"admission queue full ({self._queue.max_queue})"
            req.t_done = time.time()
        return req

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
        free slots, advance every in-flight prefill by at most
        ``prefill_chunk`` tokens, then decode every live slot one token.
        Returns every request that reached a terminal status since the
        last step."""
        finished: List[Request] = list(self._terminal_buf)
        self._terminal_buf.clear()
        while self._queue and self._slots.n_free:
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

    def _try_admit(self, req: Request) -> bool:
        """Assign a slot, adopt any shared prompt prefix, and reserve the
        first chunk's blocks. False = the pool cannot host the first chunk
        right now; the request stays at the head of the queue and the
        pager's sharing counters are left as they were."""
        n = len(req.prompt)
        slot = self._slots.alloc()
        ctrs = self._pager.sharing_counters()
        cov = self._pager.share_prefix(slot, req.prompt)
        end = min(cov + self.prefill_chunk, n)
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
        sc = self.prefill_chunk
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
        req = st.req
        self._pager.register_prompt(slot, st.prompt)
        del self._prefilling[slot]
        req.prefill_chunks = st.chunks
        req.status = "running"
        req.t_first_token = time.time()
        req.tokens.append(tok0)
        self.tokens_generated += 1
        self._pos[slot] = st.n
        self._tok[slot] = tok0
        self._live[slot] = True
        self._slot_req[slot] = req
        if req._stop_hit():
            self._finish(req, finished)

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

    def _decode(self, finished: List[Request]):
        # make every live slot's write target private + present. A
        # preempted victim's pending copies are DROPPED with it — its
        # freed blocks may be re-handed to the very slot being ensured
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
        if not self._live.any():       # everyone self-preempted
            return
        nxt, ok = self._decode_call(
            [p for c in copies_by_slot.values() for p in c])
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

    def _finish(self, req: Request, finished: List[Request]):
        self._release_slot_state(req.slot)
        req.status, req.t_done = "done", time.time()
        req.slot = None
        finished.append(req)

    # ------------------------------------------------------------- insight

    def check_invariants(self):
        """Assert the pager's block partition and that host slot state
        agrees with it: every slot is exactly one of free, prefilling or
        decoding, and a free slot holds no block and sits at position 0."""
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
                    and (self._pager.tables[s] == TRASH_BLOCK).all(), \
                    f"free slot {s} holds state"

    def kv_util(self) -> float:
        """Live cached tokens / pooled token capacity."""
        cached = int(self._pos[self._live].sum()) \
            + sum(st.done for st in self._prefilling.values())
        cap = self._pager.usable_blocks * self.block_size
        return cached / cap if cap else 0.0

    def stats(self) -> dict:
        return {
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "tokens_generated": self.tokens_generated,
            "live_slots": self.live_count,
            "queue_depth": self.queue_depth,
            "kv_util": round(self.kv_util(), 4),
            "nan_logits": self.nan_logits,
            "cancelled": self.cancelled,
            "paged": dict(self._pager.stats().as_dict(),
                          block_size=self.block_size,
                          preemptions=self.preemptions,
                          prefilling=len(self._prefilling)),
        }
