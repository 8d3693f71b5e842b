"""Cross-process prefix-cache tier: a host-RAM KV block pool.

A copy of ``paddle_tpu/serving/kvpool.py`` (stdlib only), over the port's
own ``distributed/launch/master.KVClient``: the keys, the envelope and the
meta schema are the JAX package's, so a block either package exported
adopts in the other.

The router lands same-prefix traffic where its blocks are parked, but
the pager's prefix LRU dies with its process — a cold or restarted engine
re-prefills every shared system prompt from scratch. This module is the
tier underneath: a per-host shared pool of exported KV blocks, keyed by
the SAME prefix-registry digests the discovery plane already ships
(``pager.prefix_digest``), served over the launch KV master
(``PADDLE_SERVE_MASTER`` -> ``PADDLE_CKPT_MASTER`` fallback) with an
in-process :class:`LocalPool` fallback so everything runs single-process.

Flow (engine.py wires both ends):

* **export** — when a refcount-0 registered block parks in the pager LRU,
  the engine drains it here: the block's rows of every layer (one gather
  of the engine's KV tensor) -> host -> ``reshard.snapshot.encode_block``
  (raw C-order bytes, bfloat16-safe) -> ``put(digest, payload, meta)``. Only FULL blocks export: a partial tail
  is COW'd by its adopter anyway, so only whole-block K/V is worth moving.
* **fetch/adopt** — on a local registry miss, admission falls through to
  ``get(digest)``; decoded bytes splice into the block table via
  ``BlockPager.adopt_blocks`` and an in-place copy into the block's rows
  of the KV tensor, whose address the captured programs keep (nothing is
  rebuilt).

Versioning: every entry carries the pool **generation**. A weight swap
(``DecodeEngine.drop_prefix_cache``) bumps the generation, which atomically
invalidates every outstanding entry — fetches key on the current
generation, so stale-generation blocks can never splice into a new model's
cache. On the KV master, superseded-generation entries become unreferenced
garbage (the master is in-memory and job-scoped; a generation bump is rare
— weight swap — so we accept the orphans rather than a delete sweep).

Meta schema (JSON, validated by the engine before adoption)::

    {"shape": [L, 2, bs, n_kv, hd],   # stacked per-layer K/V rows
     "dtype": "bfloat16",
     "gen": 3,                         # pool generation at export
     "tokens": 128,                    # prefix length the key covers
     "geom": [L, bs, n_kv, hd]}        # engine geometry fingerprint

A geometry or dtype mismatch is a MISS, never an error: a pool shared by
heterogeneous engines degrades to per-process caching, it does not crash.
"""
from __future__ import annotations

import base64
import json
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

__all__ = ["LocalPool", "KVPool", "resolve_kv_pool"]

# LocalPool capacity bound: entries are whole KV blocks (potentially MBs);
# an unbounded in-process pool would dwarf the device pool it mirrors.
_LOCAL_POOL_CAP = 256


class LocalPool:
    """In-process pool: the single-process fallback and the test double.

    Same API as :class:`KVPool`; entries live in a bounded LRU dict keyed
    by digest. ``bump_generation`` clears the pool — the in-process analog
    of stale-generation entries becoming unreachable on the master."""

    def __init__(self, capacity: int = _LOCAL_POOL_CAP):
        self._cap = int(capacity)
        self._gen = 0
        self._entries: "OrderedDict[str, Tuple[bytes, dict]]" = OrderedDict()
        self._lock = threading.Lock()
        self.counters = {"puts": 0, "put_errors": 0, "gets": 0,
                         "hits": 0, "misses": 0, "gen_bumps": 0}

    def generation(self) -> int:
        return self._gen

    def bump_generation(self) -> int:
        with self._lock:
            self._gen += 1
            self._entries.clear()
            self.counters["gen_bumps"] += 1
            return self._gen

    def put(self, digest: str, payload: bytes, meta: Dict[str, Any]) -> bool:
        with self._lock:
            self._entries[digest] = (bytes(payload), dict(meta))
            self._entries.move_to_end(digest)
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)
            self.counters["puts"] += 1
            return True

    def get(self, digest: str) -> Optional[Tuple[bytes, Dict[str, Any]]]:
        with self._lock:
            self.counters["gets"] += 1
            ent = self._entries.get(digest)
            if ent is None:
                self.counters["misses"] += 1
                return None
            self._entries.move_to_end(digest)
            self.counters["hits"] += 1
            return ent

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        return {"kind": "local", "gen": self._gen,
                "entries": len(self._entries), **self.counters}


class KVPool:
    """Pool over the launch KV master (``distributed/launch/master.py``).

    The master transports strings (its prefix GET JSON-decodes values), so
    payloads ride base64 inside a JSON envelope. Keys::

        /{job}/kvpool/gen                   current generation (int string)
        /{job}/kvpool/blk/{gen}/{digest}    one exported block

    Fetches build the key from the CURRENT generation, so a bump
    invalidates every older entry without touching it. A master outage
    degrades to miss/False — admission falls back to plain prefill, never
    an error (the same contract as a chaos-injected fetch fault)."""

    def __init__(self, client, job: str = "serve"):
        self._client = client
        self._job = str(job)
        self.counters = {"puts": 0, "put_errors": 0, "gets": 0,
                         "hits": 0, "misses": 0, "gen_bumps": 0}

    def _gen_key(self) -> str:
        return f"/{self._job}/kvpool/gen"

    def _blk_key(self, gen: int, digest: str) -> str:
        return f"/{self._job}/kvpool/blk/{int(gen)}/{digest}"

    def generation(self) -> int:
        raw = self._client.get(self._gen_key())
        try:
            return int(raw) if raw is not None else 0
        except ValueError:
            return 0

    def bump_generation(self) -> int:
        gen = self.generation() + 1
        self._client.put(self._gen_key(), str(gen))
        self.counters["gen_bumps"] += 1
        return gen

    def put(self, digest: str, payload: bytes, meta: Dict[str, Any]) -> bool:
        envelope = json.dumps(
            {"meta": dict(meta),
             "data": base64.b64encode(bytes(payload)).decode("ascii")})
        ok = self._client.put(self._blk_key(self.generation(), digest),
                              envelope)
        self.counters["puts" if ok else "put_errors"] += 1
        return bool(ok)

    def get(self, digest: str) -> Optional[Tuple[bytes, Dict[str, Any]]]:
        self.counters["gets"] += 1
        raw = self._client.get(self._blk_key(self.generation(), digest))
        if raw is None:
            self.counters["misses"] += 1
            return None
        try:
            env = json.loads(raw)
            payload = base64.b64decode(env["data"])
            meta = dict(env["meta"])
        except (ValueError, KeyError, TypeError):
            # a torn or mis-encoded entry is a miss, not a crash
            self.counters["misses"] += 1
            return None
        self.counters["hits"] += 1
        return payload, meta

    def stats(self) -> Dict[str, Any]:
        return {"kind": "master", "gen": self.generation(), **self.counters}


def resolve_kv_pool(job: str = "serve", timeout: float = 2.0):
    """Pool for this host: a :class:`KVPool` over ``PADDLE_SERVE_MASTER``
    (falling back to ``PADDLE_CKPT_MASTER`` — serving fleets reuse the
    checkpoint master when no dedicated one is up), else a process-local
    :class:`LocalPool`. The short timeout bounds how long one slow master
    can stall an admission's pool fallthrough."""
    ep = os.environ.get("PADDLE_SERVE_MASTER") \
        or os.environ.get("PADDLE_CKPT_MASTER")
    if ep:
        from ..distributed.launch.master import KVClient
        return KVPool(KVClient(ep, timeout=timeout), job=job)
    return LocalPool()
