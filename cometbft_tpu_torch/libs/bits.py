"""BitArray: thread-safe bitset for vote bookkeeping and gossip.

Reference: libs/bits/bit_array.go:16-31 (uint64-word bitset),
SetIndex/GetIndex (:62,:44), Or/And/Not/Sub, PickRandom (:244) — used by
the consensus gossip to choose what a peer lacks.

The port's copy of the JAX package's libs/bits.py.
"""
from __future__ import annotations

import random
import threading
from typing import List, Optional


class BitArray:
    def __init__(self, bits: int):
        self.bits = bits
        self._words = [0] * ((bits + 63) // 64)
        self._lock = threading.Lock()

    def set_index(self, i: int, v: bool) -> bool:
        if i < 0 or i >= self.bits:
            return False
        with self._lock:
            if v:
                self._words[i // 64] |= 1 << (i % 64)
            else:
                self._words[i // 64] &= ~(1 << (i % 64))
            return True

    def get_index(self, i: int) -> bool:
        if i < 0 or i >= self.bits:
            return False
        with self._lock:
            return bool(self._words[i // 64] >> (i % 64) & 1)

    def copy(self) -> "BitArray":
        b = BitArray(self.bits)
        with self._lock:
            b._words = list(self._words)
        return b

    def or_(self, other: "BitArray") -> "BitArray":
        out = BitArray(max(self.bits, other.bits))
        for i in range(len(out._words)):
            a = self._words[i] if i < len(self._words) else 0
            b = other._words[i] if i < len(other._words) else 0
            out._words[i] = a | b
        return out

    def and_(self, other: "BitArray") -> "BitArray":
        out = BitArray(min(self.bits, other.bits))
        for i in range(len(out._words)):
            out._words[i] = self._words[i] & other._words[i]
        return out

    def not_(self) -> "BitArray":
        out = BitArray(self.bits)
        with self._lock:
            for i, w in enumerate(self._words):
                out._words[i] = ~w & ((1 << 64) - 1)
        out._mask_tail()
        return out

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (bit_array.go Sub)."""
        out = BitArray(self.bits)
        for i in range(len(out._words)):
            b = other._words[i] if i < len(other._words) else 0
            out._words[i] = self._words[i] & ~b
        out._mask_tail()
        return out

    def _mask_tail(self) -> None:
        rem = self.bits % 64
        if rem and self._words:
            self._words[-1] &= (1 << rem) - 1

    def is_empty(self) -> bool:
        with self._lock:
            return all(w == 0 for w in self._words)

    def pick_random(self) -> Optional[int]:
        """A uniformly random set bit (bit_array.go:244), or None."""
        with self._lock:
            on = [
                i for i in range(self.bits)
                if self._words[i // 64] >> (i % 64) & 1
            ]
        return random.choice(on) if on else None

    def true_indices(self) -> List[int]:
        with self._lock:
            return [
                i for i in range(self.bits)
                if self._words[i // 64] >> (i % 64) & 1
            ]

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitArray)
            and self.bits == other.bits
            and self._words == other._words
        )

    def __repr__(self) -> str:
        return "BitArray{" + "".join(
            "x" if self.get_index(i) else "_" for i in range(self.bits)
        ) + "}"
