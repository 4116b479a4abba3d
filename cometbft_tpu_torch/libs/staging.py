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
from typing import Dict, Tuple

import numpy as np


class StagingPool:
    """Rotating preallocated host arrays, `slots` deep per shape."""

    def __init__(self, slots: int = 2):
        self.slots = max(1, int(slots))
        self._lock = threading.Lock()
        self._bufs: Dict[tuple, list] = {}
        self._next: Dict[tuple, int] = {}

    def get(self, name: str, shape: Tuple[int, ...], dtype) -> np.ndarray:
        """The next zeroed staging buffer for (name, shape, dtype). Callers
        must be done with a buffer before asking for `slots` more of the
        same key (the rotation contract)."""
        key = (name, tuple(int(s) for s in shape), np.dtype(dtype).str)
        with self._lock:
            bufs = self._bufs.get(key)
            if bufs is None:
                bufs = self._bufs[key] = []
            if len(bufs) < self.slots:
                buf = np.zeros(key[1], dtype)
                bufs.append(buf)
                self._next[key] = len(bufs) % self.slots
                return buf
            i = self._next[key]
            self._next[key] = (i + 1) % self.slots
            buf = bufs[i]
        buf.fill(0)
        return buf
