"""Host-side block pager for the paged KV cache (vLLM-style, Kwon et al.).

A copy of ``paddle_tpu/serving/pager.py`` (pure host bookkeeping over
numpy; the port keeps its own copy because importing the JAX package pulls
in jax), the ``fault_schedule`` seam (``guardrails.FaultSchedule``, fired
at the alloc, spec_reserve and adopt sites) included. The port's engine
holds every layer's K and V pool in one tensor; the table is the same.

The device side (engine.py) holds per-layer ``[num_blocks, block_size,
n_kv, hd]`` K/V pools and a fixed-shape ``[max_slots, max_blocks_per_slot]``
int32 block-index table; THIS file owns every allocation decision — which
physical block backs which logical position of which slot — as pure host
bookkeeping over numpy arrays. Admissions, evictions, prefix sharing and
copy-on-write all mutate table *data*, never executable *shapes*, which is
how the engine's zero-steady-state-recompile contract survives paging.

Mechanics:

* **free list** — physical blocks are fungible; block 0 is reserved as the
  TRASH block (dead slots' decode writes and padded chunk-tail writes are
  redirected there by the executables, so the allocator never hands it out).
* **refcounts** — a block may back several slots at once (shared prompt
  prefix). A slot finishing decrements; at zero an UNREGISTERED block
  returns to the free list, while a registered prompt block PARKS in the
  persistent prefix cache (below) so its K/V outlives the tenant.
* **prefix registry** — when a slot's prefill completes, each of its prompt
  blocks is registered under the exact token prefix it covers
  (``tuple(tokens[:k*bs])`` per full block, ``tuple(tokens[:n])`` for the
  partial tail). A later admission walks the chain and adopts the longest
  match, capped at ``n-1`` tokens — the last prompt token is always
  recomputed because the FIRST GENERATED token needs its hidden state,
  which is not cached (only K/V is).
* **persistent prefix cache (LRU)** — registered blocks whose refcount hits
  zero do NOT free: they park in an LRU keyed by their registry hash, so a
  later request with the same prefix re-adopts them (refcount 0 -> 1, zero
  prefill compute — a repeated system prompt prefills once per PROCESS, not
  once per burst). The free list reclaims from the LRU's least-recently-
  used end only on exhaustion — so reclamation always beats preempting a
  live tenant — and a re-adopted block returns to the MRU end when it next
  parks. Cumulative ``prefix_hits``/``prefix_hit_tokens`` count cross-
  request adoptions (distinct from ``shared_hits``, which also counts
  co-resident sharing of live blocks).
* **cross-process pool (adopt/export)** — the prefix cache's host-RAM
  tier (``serving/kvpool.py``). When a registered block parks and
  ``export_enabled`` is set, it queues in ``pending_exports`` for the
  engine to serialize out; a block that leaves the parked state (revival,
  LRU reclaim, cache drop) un-queues — only bytes that stay parked are
  safe to read at the engine's export drain. On the adopt side,
  ``adopt_blocks`` splices pool-fetched blocks into a slot's table as
  freshly allocated, REGISTERED blocks: the prefix-registry key travels
  with the bytes, so the next same-prefix admission hits locally.
* **copy-on-write** — writes only ever land at a slot's cursor, so shared
  FULL blocks are naturally read-only; the one writable shared case is the
  partial tail block (or a fully-shared final block under the n-1 cap).
  ``ensure_writable`` detects refcount > 1 at the write target, moves the
  slot onto a fresh block and reports the (src, dst) pair — the engine
  folds the device-side block copy into the next executable call as data
  arguments (no dedicated copy executable, no extra dispatch). A parked
  block adopted by TWO tenants is ref >= 2 like any live share, so COW
  still copies instead of mutating the cached original.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BlockPager", "PagerStats", "prefix_digest"]

TRASH_BLOCK = 0


def prefix_digest(tokens: Sequence[int]) -> str:
    """Stable cross-process digest of a token prefix. The router and the
    engine door compute this over the SAME tokens (the first
    ``block_size`` of a prompt) to match traffic to the replica whose
    prefix cache already holds those blocks — only digests travel over
    the discovery plane, never token ids."""
    raw = ",".join(str(int(t)) for t in tokens).encode("ascii")
    return hashlib.blake2b(raw, digest_size=8).hexdigest()

# bound on the shadow set share_prefix uses to notice REPEATED prefixes
# independently of the adoption walk (the 0%-hit-rate-with-repeats WARN in
# tools/metrics_summary.py needs a signal the bug it flags cannot also break)
_SEEN_PREFIX_CAP = 4096


class PagerStats:
    """Point-in-time allocator view (engine surfaces it via stats())."""

    __slots__ = ("blocks_total", "blocks_free", "blocks_used",
                 "blocks_shared", "block_refs", "cow_copies", "shared_hits",
                 "shared_tokens", "lru_blocks", "prefix_hits",
                 "prefix_hit_tokens", "prefix_repeats", "pool_hits",
                 "pool_hit_tokens")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class BlockPager:
    """Free-list + refcount + prefix-hash allocator over one block pool.

    ``tables`` is the authoritative host copy of the device block table:
    ``[max_slots, max_blocks_per_slot]`` int32, row zeroed for free slots
    (entry 0 == TRASH_BLOCK, never a real allocation).

    Every physical block is in exactly ONE of three states: on the free
    list (ref 0, unregistered), parked in the prefix-cache LRU (ref 0,
    registered), or owned (ref >= 1, referenced by that many slot-table
    entries). ``check_invariants`` asserts the partition — the randomized
    property test drives it through ~1k-op alloc/share/COW/free/preempt/
    park/adopt sequences.
    """

    def __init__(self, num_blocks: int, block_size: int, max_slots: int,
                 blocks_per_slot: int, persistent_prefixes: bool = True):
        if num_blocks < 2:
            raise ValueError(f"kv_blocks must be >= 2 (block 0 is the trash "
                             f"block), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_slots = int(max_slots)
        self.blocks_per_slot = int(blocks_per_slot)
        self.persistent_prefixes = bool(persistent_prefixes)
        self.tables = np.zeros((max_slots, blocks_per_slot), np.int32)
        # LIFO free list: recently freed blocks are re-handed first
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = np.zeros(num_blocks, np.int32)
        # exact-prefix registry: tuple(prompt_tokens[:k]) -> physical block
        self._registry: Dict[tuple, int] = {}
        self._block_key: Dict[int, tuple] = {}
        # persistent prefix cache: parked block -> registry key, insertion
        # order == recency (left end is the reclamation tail, right is MRU)
        self._lru: "OrderedDict[int, tuple]" = OrderedDict()
        # first-block keys ever registered (bounded): the repeat detector
        self._seen_first: "OrderedDict[tuple, None]" = OrderedDict()
        # per-admission scratch the engine reads right after share_prefix
        self.last_adopt_parked = 0
        self.last_adopt_parked_tokens = 0
        self.last_adopt_pool = 0
        self.last_adopt_pool_tokens = 0
        # cross-process pool export queue: parked block -> registry key,
        # FIFO. Populated by _decref's park branch when the engine enables
        # exports; any transition OUT of the parked state un-queues the
        # block (its device rows are about to be rewritten or are now
        # tenant-owned — only stably parked bytes are safe to serialize).
        self.export_enabled = False
        self.pending_exports: "OrderedDict[int, tuple]" = OrderedDict()
        # PADDLE_SERVE_FAULT chaos seam (serving/guardrails.py): the engine
        # installs its FaultSchedule here; an injected "raise" at the alloc
        # site manifests as deterministic pool exhaustion (the failure the
        # callers actually handle), never as a propagating exception
        self.fault_schedule = None
        # cumulative telemetry (monitor gauges/counters read these)
        self.cow_copies = 0
        self.shared_hits = 0          # admissions that adopted >= 1 block
        self.shared_tokens = 0        # prompt tokens served from shared blocks
        self.prefix_hits = 0          # admissions that adopted >= 1 PARKED block
        self.prefix_hit_tokens = 0    # prompt tokens revived from the LRU
        self.prefix_repeats = 0       # admissions whose first-block key repeated
        self.lru_reclaims = 0         # parked blocks cannibalized on exhaustion
        self.pool_hits = 0            # admissions that spliced >= 1 pool block
        self.pool_hit_tokens = 0      # prompt tokens served from pool blocks

    # ------------------------------------------------------------ accounting

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1          # minus the trash block

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def lru_blocks(self) -> int:
        return len(self._lru)

    @property
    def reclaimable_blocks(self) -> int:
        """Blocks an allocation could obtain without preempting anyone:
        free list + parked prefix-cache blocks (reclaimed tail-first)."""
        return len(self._free) + len(self._lru)

    @property
    def blocks_used(self) -> int:
        return self.usable_blocks - len(self._free) - len(self._lru)

    def prefix_digests(self, top: int = 8) -> List[str]:
        """Digests of the most recently registered FIRST-block prefix keys
        (length == block_size — the granularity a router can match a new
        prompt against before placement). Newest first, at most ``top``.
        Registry insertion order is registration recency, so this is a
        cheap tail walk, not a scan of block contents."""
        if top < 1:
            return []
        bs = self.block_size
        keys = [k for k in self._registry if len(k) == bs]
        return [prefix_digest(k) for k in reversed(keys[-int(top):])]

    def stats(self) -> PagerStats:
        used = self._ref > 0
        return PagerStats(
            blocks_total=self.usable_blocks, blocks_free=self.free_blocks,
            blocks_used=self.blocks_used,
            blocks_shared=int((self._ref > 1).sum()),
            block_refs=int(self._ref[used].sum()),
            cow_copies=self.cow_copies, shared_hits=self.shared_hits,
            shared_tokens=self.shared_tokens, lru_blocks=self.lru_blocks,
            prefix_hits=self.prefix_hits,
            prefix_hit_tokens=self.prefix_hit_tokens,
            prefix_repeats=self.prefix_repeats,
            pool_hits=self.pool_hits,
            pool_hit_tokens=self.pool_hit_tokens)

    def sharing_counters(self) -> tuple:
        """Snapshot of the per-admission sharing/prefix counters — the
        engine takes one before a speculative admission attempt and
        restores it when the pool refuses, so a blocked head-of-line
        request retried every step cannot inflate hit rates. (The LRU
        recency touch of a refused adoption is NOT rolled back: a prefix
        a waiting request keeps reaching for is hot by definition.)"""
        return (self.shared_hits, self.shared_tokens, self.prefix_hits,
                self.prefix_hit_tokens, self.prefix_repeats,
                self.pool_hits, self.pool_hit_tokens)

    def restore_sharing_counters(self, snap: tuple):
        (self.shared_hits, self.shared_tokens, self.prefix_hits,
         self.prefix_hit_tokens, self.prefix_repeats,
         self.pool_hits, self.pool_hit_tokens) = snap

    def check_invariants(self):
        """Assert the three-state partition and refcount/registry health
        (test harness hook; O(blocks + table))."""
        free = set(self._free)
        parked = set(self._lru)
        owned = {b for b in range(1, self.num_blocks) if self._ref[b] > 0}
        assert TRASH_BLOCK not in free and TRASH_BLOCK not in parked
        assert not (free & parked) and not (free & owned) \
            and not (parked & owned), "block in two states at once"
        assert len(free) + len(parked) + len(owned) == self.usable_blocks, \
            "pool blocks leaked or double-counted"
        # refcounts match the number of table references, exactly
        counts = np.bincount(self.tables.ravel(),
                             minlength=self.num_blocks)
        counts[TRASH_BLOCK] = 0
        assert (counts == self._ref).all(), \
            f"refcounts {self._ref.tolist()} != table refs {counts.tolist()}"
        # free blocks carry no registration; parked blocks carry exactly one
        for b in free:
            assert b not in self._block_key, f"free block {b} registered"
        for b, key in self._lru.items():
            assert self._block_key.get(b) == key \
                and self._registry.get(key) == b, f"parked block {b} torn"
        # registry <-> block_key is a bijection over registered blocks
        assert len(self._registry) == len(self._block_key)
        for key, b in self._registry.items():
            assert self._block_key.get(b) == key
        assert TRASH_BLOCK not in self._block_key
        # export queue holds only stably parked blocks, under their keys
        for b, key in self.pending_exports.items():
            assert b in parked and self._lru.get(b) == key, \
                f"pending export {b} not parked (or key torn)"

    # ------------------------------------------------------------ allocation

    def _alloc_block(self) -> Optional[int]:
        if self.fault_schedule is not None:
            from .guardrails import InjectedFault
            try:
                self.fault_schedule.fire("alloc")
            except InjectedFault:
                return None        # scripted exhaustion: callers evict/defer
        if self._free:
            blk = self._free.pop()
        elif self._lru:
            # exhaustion: cannibalize the LEAST-recently-used parked prefix
            # block — reclamation always beats preempting a live tenant
            blk, key = self._lru.popitem(last=False)
            self._unregister(blk)
            self.pending_exports.pop(blk, None)
            self.lru_reclaims += 1
        else:
            return None
        self._ref[blk] = 1
        return blk

    def _unregister(self, blk: int):
        key = self._block_key.pop(blk, None)
        if key is not None and self._registry.get(key) == blk:
            del self._registry[key]

    def _decref(self, blk: int):
        assert blk != TRASH_BLOCK and self._ref[blk] > 0
        self._ref[blk] -= 1
        if self._ref[blk] == 0:
            key = self._block_key.get(blk)
            if key is not None and self.persistent_prefixes \
                    and self._registry.get(key) == blk:
                # park instead of free: the prefix cache holds the K/V for
                # the next same-prefix request; MRU end (freshest survives
                # reclamation longest)
                self._lru[blk] = key
                self._lru.move_to_end(blk)
                if self.export_enabled:
                    self.pending_exports[blk] = key
                    self.pending_exports.move_to_end(blk)
            else:
                self._unregister(blk)
                self._free.append(blk)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` cached positions."""
        return -(-int(n_tokens) // self.block_size)

    def blocks_needed(self, slot: int, start_pos: int, end_pos: int) -> int:
        """How many FRESH blocks a write of [start_pos, end_pos) would
        allocate for ``slot`` (COW targets count too — a copy needs a new
        block)."""
        need = 0
        for lidx in range(start_pos // self.block_size,
                          self.blocks_for(end_pos)):
            blk = int(self.tables[slot, lidx])
            if blk == TRASH_BLOCK or self._ref[blk] > 1:
                need += 1
        return need

    def ensure_writable(self, slot: int, start_pos: int, end_pos: int
                        ) -> Optional[List[Tuple[int, int]]]:
        """Make every block covering positions [start_pos, end_pos) of
        ``slot`` privately owned and present: allocate missing blocks,
        copy-on-write shared ones. Returns the (src, dst) device copies the
        caller must fold into its next executable call, or None when the
        pool cannot satisfy the request EVEN after reclaiming parked
        prefix-cache blocks (caller evicts or defers — the table is left
        exactly as it was)."""
        copies: List[Tuple[int, int]] = []
        taken: List[Tuple[int, Optional[int]]] = []   # (lidx, old) rollback
        for lidx in range(start_pos // self.block_size,
                          self.blocks_for(end_pos)):
            blk = int(self.tables[slot, lidx])
            if blk != TRASH_BLOCK and self._ref[blk] == 1:
                continue                              # already private
            fresh = self._alloc_block()
            if fresh is None:
                # roll back this call's allocations; the table must not be
                # half-mutated when the caller goes off to evict
                for l2, old in reversed(taken):
                    self._decref(int(self.tables[slot, l2]))
                    if old is not None:
                        if self._ref[old] == 0:     # parked mid-call: revive
                            self._lru.pop(old, None)
                            self.pending_exports.pop(old, None)
                        self._ref[old] += 1
                        self.tables[slot, l2] = old
                    else:
                        self.tables[slot, l2] = TRASH_BLOCK
                return None
            if blk != TRASH_BLOCK:                    # shared -> COW
                copies.append((blk, fresh))
                self.cow_copies += 1
                self._decref(blk)
                taken.append((lidx, blk))
            else:
                taken.append((lidx, None))
            self.tables[slot, lidx] = fresh
        return copies

    # ------------------------------------------------- speculative reserve

    def reserve_speculative(self, slot: int, start_pos: int, end_pos: int
                            ) -> Tuple[int, List[Tuple[int, int]],
                                       List[Tuple[int, Optional[int]]]]:
        """Best-effort private backing for the speculative write range
        [start_pos, end_pos) of ``slot`` — where draft tokens' K/V lands
        until the verifier accepts them. Same per-block walk as
        ``ensure_writable`` (allocate missing, COW shared) with two
        deliberate differences: it NEVER preempts — pool pressure must not
        evict a live tenant for guesses, so the walk simply stops at the
        first block the pool cannot supply — and instead of all-or-nothing
        it reports how far it got.

        Returns ``(covered_end, copies, reservation)``: every position
        below ``covered_end`` is now privately writable (the caller clips
        its drafts to that), ``copies`` are (src, dst) COW pairs to fold
        into the verify dispatch, and ``reservation`` is the exact
        rollback script — (lidx, previous_block) per table entry this call
        replaced, in take order — for ``rollback_speculative``. Resolve
        the reservation (rollback or commit) before the slot's next pager
        operation; the engine does so synchronously right after the verify
        returns. An injected "spec_reserve" fault (PADDLE_SERVE_FAULT)
        reserves nothing: the engine degrades to a plain one-token verify,
        never an error."""
        if self.fault_schedule is not None:
            from .guardrails import InjectedFault
            try:
                self.fault_schedule.fire("spec_reserve")
            except InjectedFault:
                return start_pos, [], []
        copies: List[Tuple[int, int]] = []
        reservation: List[Tuple[int, Optional[int]]] = []
        covered = start_pos
        for lidx in range(start_pos // self.block_size,
                          self.blocks_for(end_pos)):
            blk = int(self.tables[slot, lidx])
            if blk != TRASH_BLOCK and self._ref[blk] == 1:
                covered = min((lidx + 1) * self.block_size, end_pos)
                continue                              # already private
            fresh = self._alloc_block()
            if fresh is None:
                break         # partial coverage: the caller shrinks k
            if blk != TRASH_BLOCK:                    # shared -> COW
                copies.append((blk, fresh))
                self.cow_copies += 1
                self._decref(blk)
                reservation.append((lidx, blk))
            else:
                reservation.append((lidx, None))
            self.tables[slot, lidx] = fresh
            covered = min((lidx + 1) * self.block_size, end_pos)
        return covered, copies, reservation

    def rollback_speculative(self, slot: int, keep_end: int,
                             reservation: List[Tuple[int, Optional[int]]]):
        """Resolve a ``reserve_speculative`` reservation after the verify:
        every reserved entry whose block starts at or past ``keep_end``
        (the post-accept cursor) covered ONLY rejected positions — free
        the speculative block and restore what the table held before
        (re-reference the COW source, reviving it from the LRU if it
        parked meanwhile; trash for a fresh extension). Entries covering
        any accepted position commit by doing nothing: the accepted
        tokens' K/V already lives in them and the table already points at
        them. Rejected drafts' writes die with the freed blocks — or, on
        a committed block, sit above the cursor where the next dispatch
        overwrites them before anything reads."""
        for lidx, old in reversed(reservation):
            if lidx * self.block_size < keep_end:
                continue              # covers accepted positions: committed
            self._decref(int(self.tables[slot, lidx]))
            if old is not None:
                if self._ref[old] == 0:      # parked mid-flight: revive
                    self._lru.pop(old, None)
                    self.pending_exports.pop(old, None)
                self._ref[old] += 1
                self.tables[slot, lidx] = old
            else:
                self.tables[slot, lidx] = TRASH_BLOCK

    # -------------------------------------------------------- prefix sharing

    def share_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """Adopt the longest registered prefix of ``tokens`` into ``slot``'s
        table (increments refcounts, revives parked blocks) and return how
        many prompt positions are now served from shared blocks. Capped at
        ``len(tokens) - 1``: the final prompt token is always recomputed
        (its hidden state feeds the first generated token and only K/V is
        cached). ``last_adopt_parked``/``last_adopt_parked_tokens`` report
        this call's LRU revivals (the engine reads them for telemetry)."""
        toks = tuple(int(t) for t in tokens)
        n = len(toks)
        bs = self.block_size
        first_key = toks[:bs] if n > bs else toks
        if first_key in self._seen_first:
            self.prefix_repeats += 1
        chain: List[Tuple[int, int]] = []   # (block, coverage after adopting)
        cov = 0
        i = 1
        while i * bs < n:                 # strictly < n: keep >= 1 to process
            blk = self._registry.get(toks[:i * bs])
            if blk is None:
                break
            chain.append((blk, i * bs))
            cov = i * bs
            i += 1
        # exact-prompt tail block (partial, or the final full block of an
        # aligned prompt): adopt it too — the n-1 cap below forces at least
        # the last token through the chunk executable, whose first write
        # copy-on-writes this block
        if cov < n - 1 and len(chain) == (n - 1) // bs:
            blk = self._registry.get(toks)
            if blk is not None and blk not in (b for b, _ in chain):
                chain.append((blk, n - 1))
                cov = n - 1
        cov = min(cov, n - 1)
        self.last_adopt_parked = 0
        self.last_adopt_parked_tokens = 0
        self.last_adopt_pool = 0
        self.last_adopt_pool_tokens = 0
        prev_cov = 0
        for lidx, (blk, cov_after) in enumerate(chain):
            if self._ref[blk] == 0:       # parked: revive from the LRU
                self._lru.pop(blk, None)
                self.pending_exports.pop(blk, None)
                self.last_adopt_parked += 1
                self.last_adopt_parked_tokens += \
                    min(cov_after, cov) - prev_cov
            self._ref[blk] += 1
            self.tables[slot, lidx] = blk
            prev_cov = min(cov_after, cov)
        if chain:
            self.shared_hits += 1
            self.shared_tokens += cov
        if self.last_adopt_parked:
            self.prefix_hits += 1
            self.prefix_hit_tokens += self.last_adopt_parked_tokens
        return cov

    def adopt_blocks(self, slot: int, start_pos: int,
                     keys: Sequence[tuple]) -> List[int]:
        """Splice pool-fetched blocks into ``slot``'s table: one freshly
        allocated block per key, entered into the prefix registry under
        that key — the registry entry transfers with the bytes, so the
        NEXT same-prefix admission adopts locally via ``share_prefix``.

        ``keys`` must be consecutive FULL-block prefix keys extending the
        slot's coverage from ``start_pos`` (a block boundary):
        ``len(keys[j]) == start_pos + (j+1) * block_size``. Returns the
        physical block ids in key order — the caller MUST fill their
        device rows (data-not-shape ``device_put``) before any dispatch
        reads them. Best-effort prefix semantics: the walk stops at the
        first key the pool cannot place (allocation failure, key already
        registered locally, or an injected ``adopt`` fault, which splices
        nothing) and whatever was spliced stands — the caller prefills
        the remainder (the partial-fetch fallback). Refcounts, the LRU
        and ``check_invariants`` hold at every exit."""
        if self.fault_schedule is not None:
            from .guardrails import InjectedFault
            try:
                self.fault_schedule.fire("adopt")
            except InjectedFault:
                return []
        bs = self.block_size
        assert start_pos % bs == 0, "adopt must start on a block boundary"
        blocks: List[int] = []
        for j, key in enumerate(keys):
            key = tuple(int(t) for t in key)
            assert len(key) == start_pos + (j + 1) * bs, \
                "adopt keys must be consecutive full-block prefixes"
            if key in self._registry:
                break        # a local copy exists: share_prefix's job
            blk = self._alloc_block()
            if blk is None:
                break        # pool pressure: prefill the rest instead
            lidx = start_pos // bs + j
            assert int(self.tables[slot, lidx]) == TRASH_BLOCK, \
                "adopt target already mapped"
            self.tables[slot, lidx] = blk
            self._registry[key] = blk
            self._block_key[blk] = key
            blocks.append(blk)
        if blocks:
            ntok = len(blocks) * bs
            self.last_adopt_pool = len(blocks)
            self.last_adopt_pool_tokens = ntok
            self.pool_hits += 1
            self.pool_hit_tokens += ntok
            # a pool splice IS a cross-request prefix adoption — it counts
            # in the same ledgers the LRU revival path feeds, so hit-rate
            # telemetry does not depend on WHICH tier served the bytes
            self.shared_hits += 1
            self.shared_tokens += ntok
            self.prefix_hits += 1
            self.prefix_hit_tokens += ntok
        return blocks

    def register_prompt(self, slot: int, tokens: Sequence[int]):
        """Publish ``slot``'s freshly prefilled prompt blocks for future
        sharing. Called when the prefill COMPLETES — a half-written block
        must never be adoptable. First registration wins; a block carries
        at most one key."""
        toks = tuple(int(t) for t in tokens)
        n = len(toks)
        bs = self.block_size
        first_key = toks[:bs] if n > bs else toks
        self._seen_first[first_key] = None
        self._seen_first.move_to_end(first_key)
        while len(self._seen_first) > _SEEN_PREFIX_CAP:
            self._seen_first.popitem(last=False)
        bounds = [k * bs for k in range(1, n // bs + 1)]
        if n % bs:
            bounds.append(n)
        for b in bounds:
            blk = int(self.tables[slot, (b - 1) // bs])
            if blk == TRASH_BLOCK or blk in self._block_key:
                continue
            key = toks[:b]
            if key in self._registry:
                continue
            self._registry[key] = blk
            self._block_key[blk] = key

    # --------------------------------------------------------------- release

    def release_slot(self, slot: int):
        """Return every block ``slot`` references (finish or eviction);
        shared blocks survive while other slots still hold them, registered
        blocks park in the prefix-cache LRU at refcount zero."""
        for lidx in range(self.blocks_per_slot):
            blk = int(self.tables[slot, lidx])
            if blk != TRASH_BLOCK:
                self._decref(blk)
        self.tables[slot, :] = TRASH_BLOCK

    def drop_prefix_cache(self) -> int:
        """Flush every parked block back to the free list (operator hook:
        weight swap / tokenizer change invalidates cached K/V). Returns how
        many blocks were released. Pending pool exports die with the cache
        (their bytes are invalid for the new weights); the ENGINE wrapper
        additionally bumps the pool generation so already-exported entries
        can never splice back in."""
        n = len(self._lru)
        self.pending_exports.clear()
        while self._lru:
            blk, _ = self._lru.popitem(last=False)
            self._unregister(blk)
            self._free.append(blk)
        return n
