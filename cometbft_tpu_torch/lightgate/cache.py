"""Verified-pair LRU for the light-client gateway.

A gateway serving thousands of light clients sees the same sync shapes
over and over: popular (trusted, target) header pairs — wallet fleets
pinned to the same release snapshot all jumping to the same tip. Once
one of them has paid for the skipping verification, the pair
(trusted_hash, target_hash) is a proven fact; repeat syncs over it are
pure cache hits that never touch the verify plane.

Entries carry the TARGET header's expiry on the gateway's trusting
period: a hit whose target has aged past the trusting period is
useless as a client's new trust root and must not be served — it is
dropped and counted (`expired`), and the request falls through to a
fresh verification. This is what keeps the LRU honest against
`Client.prune_expired`: the trusted store and the cache expire on the
same clock, so a pruned store can never be shadowed by a stale cache.

Thread-safe: one lock around the OrderedDict; `stats()` is scrape-safe
(one lock acquire, plain ints — /metrics samples it on every scrape).

The port's copy of the JAX package's lightgate/cache.py (host code).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class CacheEntry:
    """One verified (trusted, target) fact."""

    target_height: int
    target_hash: bytes
    expires_ns: int     # target header time + trusting period, in ns
    verify_steps: int   # bisection steps the original verification paid


class VerifiedLRU:
    """Bounded LRU of verified (trusted_hash, target_hash) pairs."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, int(capacity))
        self._od: "OrderedDict[Tuple[bytes, bytes], CacheEntry]" = \
            OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expired = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def get(self, key: Tuple[bytes, bytes],
            now_ns: Optional[int] = None) -> Optional[CacheEntry]:
        """Hit moves the pair to the MRU end; an entry whose target has
        expired (>= now_ns) is dropped and reported as a miss."""
        with self._lock:
            ent = self._od.get(key)
            if ent is None:
                self.misses += 1
                return None
            if now_ns is not None and now_ns >= ent.expires_ns:
                del self._od[key]
                self.expired += 1
                self.misses += 1
                return None
            self._od.move_to_end(key)
            self.hits += 1
            return ent

    def put(self, key: Tuple[bytes, bytes], entry: CacheEntry) -> None:
        with self._lock:
            self._od[key] = entry
            self._od.move_to_end(key)
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
                self.evictions += 1

    def prune_expired(self, now_ns: int) -> int:
        """Drop every entry whose target is past the trusting period
        (the cache-side half of Client.prune_expired)."""
        with self._lock:
            dead = [k for k, e in self._od.items()
                    if now_ns >= e.expires_ns]
            for k in dead:
                del self._od[k]
            self.expired += len(dead)
            return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._od.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._od),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "expired": self.expired,
            }
