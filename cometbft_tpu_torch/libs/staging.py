"""Double-buffered host staging for device uploads.

The port's copy of the JAX package's libs/staging.py. A streaming
dispatcher packs chunk k+1 while the device still works on chunk k; this
pool keeps `slots` persistent numpy arrays per (name, shape, dtype) and
rotates them, so packing reuses memory instead of allocating per chunk.

Depth must track the pipeline: a consumer keeping K chunks in flight
needs K + 1 slots so a pack never lands in a buffer a flight still reads
from. The rotation is strictly round-robin per key, not free-slot-aware.

The arrays are ordinary pageable host memory. `tensor.to(device)` from
pageable memory has read the host buffer when it returns, so a slot may
be handed out again as soon as its upload call returned; a pool of pinned
buffers copied with `non_blocking=True` would instead have to wait for
each copy's CUDA event before reusing the slot. Device-resident caches
(valset tables, templates) are never staged through the pool.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Tuple

import numpy as np

# every live pool, weakly held: the device observatory's residency
# sampler (libs/deviceledger) attributes ALL host staging bytes —
# the global crypto.batch pool, plane-private pools, blocksync's —
# without each owner having to register anywhere
_POOLS: "weakref.WeakSet" = weakref.WeakSet()


def live_pools() -> List["StagingPool"]:
    """Snapshot of every StagingPool still alive in this process."""
    return list(_POOLS)


class StagingPool:
    """Rotating preallocated host arrays, `slots` deep per shape."""

    def __init__(self, slots: int = 2):
        self.slots = max(1, int(slots))
        self._lock = threading.Lock()
        self._bufs: Dict[tuple, list] = {}
        self._next: Dict[tuple, int] = {}
        self.hits = 0
        self.misses = 0
        _POOLS.add(self)

    def get(self, name: str, shape: Tuple[int, ...], dtype,
            zero: bool = True) -> np.ndarray:
        """The next staging buffer for (name, shape, dtype); zeroed by
        default. Callers must be done writing a buffer before asking
        for `slots` more of the same key (the rotation contract)."""
        key = (name, tuple(int(s) for s in shape), np.dtype(dtype).str)
        with self._lock:
            bufs = self._bufs.get(key)
            if bufs is None:
                bufs = self._bufs[key] = []
            if len(bufs) < self.slots:
                buf = np.zeros(key[1], dtype)
                bufs.append(buf)
                self._next[key] = len(bufs) % self.slots
                self.misses += 1
                return buf
            i = self._next[key]
            self._next[key] = (i + 1) % self.slots
            buf = bufs[i]
            self.hits += 1
        if zero:
            buf.fill(0)
        return buf

    def nbytes(self) -> int:
        with self._lock:
            return sum(b.nbytes for bufs in self._bufs.values()
                       for b in bufs)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "shapes": len(self._bufs),
                "resident_bytes": sum(
                    b.nbytes for bufs in self._bufs.values() for b in bufs
                ),
            }

    def clear(self) -> None:
        with self._lock:
            self._bufs.clear()
            self._next.clear()
