"""Bounded, evicting caches for device-resident valset tables.

The port's copy of the JAX package's ops/table_cache.py (that module
imports no JAX, but the port imports nothing of the JAX package). The
cache stack of ops/ed25519_cached.py routes through it:

  * capacities are enforced with real LRU eviction, counted per cache
    kind;
  * ``resident_bytes`` is maintained incrementally (O(1) per
    insert/evict): the table tensors' ``nbytes`` on the device plus the
    host copies of keys and powers, so epoch churn must hold it flat;
  * a warmer can mark the keys it pre-built and the first lookup after a
    valset rotation attributes its hit honestly (``warmed_hits``).

The sharded-table cache (``SHARDS``) holds one table a slot for each
(valset, mesh) a sharded flush looked up (ops/ed25519_cached
``sharded_table_for_pubs_info``).

Thread-safety: callers synchronize on :data:`LOCK` (ed25519_cached
routes every cache touch through it).

LIVE-epoch safety: eviction is strictly LRU and every cache hit
refreshes recency, so the table a steady flush stream is using is by
construction the most-recently-used entry, and every capacity is at
least 2, so a warm insert can never evict the live table out from under
an in-flight flush. (A flush that already holds a table
reference keeps the device tensors alive regardless: eviction drops the
cache's reference, it never frees memory a flight still uses.)
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Iterator, Optional

# the ONE lock for the whole table-cache stack (ed25519_cached aliases
# it as _TABLE_LOCK); RLock so a near-miss scan that consults a second
# cache under the same lock never self-deadlocks
LOCK = threading.RLock()

# steady-state observability + the hot path's regression guard: a
# healthy consensus stream should be ~all hits. The shard_* kinds count
# the per-mesh sharded-table cache; the evictions_* kinds
# count entries each bounded cache dropped under churn pressure;
# warmed_hits counts lookups answered by a table a warmer pre-built (the
# first commit after a rotation, when the warmer won).
STATS = {"hits": 0, "misses": 0, "key_memo_hits": 0,
         "valset_hits": 0, "valset_misses": 0,
         "shard_hits": 0, "shard_misses": 0,
         "template_hits": 0, "template_misses": 0,
         "evictions_tables": 0, "evictions_shard": 0,
         "evictions_valset_memo": 0, "evictions_key_memo": 0,
         "evictions_templates": 0,
         "warmed_hits": 0, "incremental_patches": 0}


def default_size(value) -> int:
    """Best-effort byte size of a cached table: the device tensors'
    nbytes plus the host-side pubkey/power copies. Duck-typed so tests
    can size fake tables through a bare ``nbytes`` attribute (a sharded
    table has one: the sum over its slots)."""
    n = getattr(value, "nbytes", None)
    if isinstance(n, (int, float)):
        return int(n)
    total = 0
    for attr in ("tab", "ok", "power5", "pub_raw"):
        a = getattr(value, attr, None)
        nb = getattr(a, "nbytes", None)
        if isinstance(nb, (int, float)):
            total += int(nb)
    ph = getattr(value, "pubs_host", None)
    if ph:
        total += sum(len(p) for p in ph)
    pw = getattr(value, "powers_host", None)
    nb = getattr(pw, "nbytes", None)
    if isinstance(nb, (int, float)):
        total += int(nb)
    return total


class BoundedLRU:
    """An LRU mapping with a capacity (at least 2), per-kind eviction
    accounting in :data:`STATS`, and incrementally-maintained resident
    bytes. NOT internally locked — callers hold :data:`LOCK` (the
    ed25519_cached contract)."""

    __slots__ = ("kind", "capacity", "_od", "_size_fn", "_bytes")

    def __init__(self, kind: str, capacity: int,
                 size_fn: Optional[Callable] = None):
        self.kind = kind
        self.capacity = max(2, int(capacity))
        self._od: "OrderedDict" = OrderedDict()
        self._size_fn = size_fn
        self._bytes = 0

    def __len__(self) -> int:
        return len(self._od)

    def __contains__(self, key) -> bool:
        return key in self._od

    def get(self, key):
        """Value for key (refreshing recency) or None."""
        v = self._od.get(key)
        if v is not None:
            self._od.move_to_end(key)
        return v

    def peek(self, key):
        """Value for key WITHOUT refreshing recency (scans)."""
        return self._od.get(key)

    def put(self, key, value) -> None:
        old = self._od.get(key)
        if old is not None and self._size_fn is not None:
            self._bytes -= self._size_fn(old)
        self._od[key] = value
        self._od.move_to_end(key)
        if self._size_fn is not None:
            self._bytes += self._size_fn(value)
        self._trim()

    def pop(self, key) -> None:
        v = self._od.pop(key, None)
        if v is not None and self._size_fn is not None:
            self._bytes -= self._size_fn(v)

    def values(self) -> Iterator:
        return self._od.values()

    def clear(self) -> None:
        self._od.clear()
        self._bytes = 0

    def resident_bytes(self) -> int:
        return self._bytes

    def set_capacity(self, capacity: int) -> None:
        """Shrink takes effect immediately (evictions are counted)."""
        self.capacity = max(2, int(capacity))
        self._trim()

    def _trim(self) -> None:
        while len(self._od) > self.capacity:
            _, v = self._od.popitem(last=False)
            if self._size_fn is not None:
                self._bytes -= self._size_fn(v)
            STATS["evictions_" + self.kind] += 1


# -- the cache instances ---------------------------------------------------
# LRU of built tables keyed by the pubkey-list content digest
# (order-sensitive: the validator INDEX is the gather key). Commit
# verification presents the same valset in the same order every block,
# so this hits ~always; epoch churn inserts one new table per epoch
# and the OLDEST retired epoch evicts.
TABLES = BoundedLRU("tables", 8, size_fn=default_size)
# (content key, mesh key) -> ShardedValsetTable: a node serves one live
# valset per mesh in the steady state (two with the flight deck's
# halves); churn evicts.
SHARDS = BoundedLRU("shard", 4, size_fn=default_size)
# id(pubs tuple) -> (pubs, powers, content key): the identity memo over
# the O(valset) content digest. Entries pin the tuples themselves —
# bounded so retired QuorumGroup valset tuples (10k pubkeys each) stop
# accumulating across epochs.
KEY_MEMO = BoundedLRU("key_memo", 16)
# id(ValidatorSet) -> (set, validators list, table): pins whole
# ValidatorSet objects (10k Validator dataclasses per epoch) — the
# biggest host-side churn leak surface, bounded here.
VALSET_MEMO = BoundedLRU("valset_memo", 8)
# stamp-site content key -> device-resident encoded template (device-side
# sign-bytes stamping). One entry per template family the delta path
# flushes against (a few hundred bytes each, next to the valset window
# tables it rides with). Same live-entry safety as the
# tables: capacity >= 2, every hit refreshes recency, and a plan that
# holds an entry keeps its device buffers alive even across an evict —
# the live template is never freed mid-flush.
TEMPLATES = BoundedLRU("templates", 8, size_fn=default_size)

_CACHES = {"tables": TABLES, "shard_tables": SHARDS,
           "key_memo": KEY_MEMO, "valset_memo": VALSET_MEMO,
           "templates": TEMPLATES}


def set_capacities(tables: Optional[int] = None,
                   shard_tables: Optional[int] = None,
                   key_memo: Optional[int] = None,
                   valset_memo: Optional[int] = None,
                   templates: Optional[int] = None) -> None:
    """Configure cache capacities ([crypto] table_cache_* knobs).
    Each is clamped to >= 2 (capacity 1 would let a next-epoch warm
    insert evict the LIVE epoch's table mid-flush)."""
    with LOCK:
        if tables is not None:
            TABLES.set_capacity(tables)
        if shard_tables is not None:
            SHARDS.set_capacity(shard_tables)
        if key_memo is not None:
            KEY_MEMO.set_capacity(key_memo)
        if valset_memo is not None:
            VALSET_MEMO.set_capacity(valset_memo)
        if templates is not None:
            TEMPLATES.set_capacity(templates)


def capacities() -> dict:
    with LOCK:
        return {name: c.capacity for name, c in _CACHES.items()}


def stats() -> dict:
    with LOCK:
        return dict(STATS)


def snapshot_values(kind: str) -> list:
    """The entries of one cache, snapshotted under :data:`LOCK`
    WITHOUT refreshing recency — the device observatory's residency
    sampler (libs/deviceledger) walks these to attribute per-device
    bytes/slots; a scrape must never perturb eviction order."""
    with LOCK:
        return list(_CACHES[kind]._od.values())


def resident_bytes() -> int:
    """Host+device bytes pinned by the TABLE caches (the memo caches
    pin only references whose owners are sized elsewhere)."""
    with LOCK:
        return TABLES.resident_bytes() + SHARDS.resident_bytes()


# -- warmer attribution ----------------------------------------------------
# Content keys a warmer pre-built, awaiting their first
# lookup: the first post-rotation hit on one consumes it and counts a
# warmed_hit — the honest signal that the warmer (not steady-state
# reuse) saved the cold build. Bounded: a warmer that outruns lookups
# must not grow without bound.
_WARMED: "OrderedDict" = OrderedDict()
_WARMED_MAX = 16


def note_warmed(key: bytes) -> None:
    with LOCK:
        _WARMED[key] = True
        _WARMED.move_to_end(key)
        while len(_WARMED) > _WARMED_MAX:
            _WARMED.popitem(last=False)


def consume_warmed(key: bytes) -> bool:
    """True (once) when `key` was pre-built by the warmer; counts the
    warmed_hit. Callers hold :data:`LOCK` via their own cache path or
    call this bare — the RLock makes both safe."""
    with LOCK:
        if _WARMED.pop(key, None) is not None:
            STATS["warmed_hits"] += 1
            return True
        return False


def reset_for_tests() -> None:
    """Clear every cache, stat, and warm mark (test isolation only)."""
    with LOCK:
        for c in _CACHES.values():
            c.clear()
        _WARMED.clear()
        for k in STATS:
            STATS[k] = 0
