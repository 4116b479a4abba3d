"""RFC 6962 merkle tree (crypto/merkle/tree.go HashFromByteSlices, leaf and
inner prefixes, getSplitPoint; crypto/merkle/proof.go Proof,
ProofsFromByteSlices, Verify): the hash behind `ValidatorSet.hash`,
`Header.hash` and the part-set roots.

The 0x00/0x01 domain separation and the largest-power-of-two-less-than
split rule are consensus-critical.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

_LEAF_PREFIX = b"\x00"
_INNER_PREFIX = b"\x01"


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def empty_hash() -> bytes:
    """Hash of an empty input set: SHA256("")."""
    return _sha256(b"")


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(_LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(_INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (tree.go getSplitPoint)."""
    assert n > 1
    return 1 << (n.bit_length() - 1 if n & (n - 1) else n.bit_length() - 2)


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return empty_hash()
    if n == 1:
        return leaf_hash(items[0])
    k = _split_point(n)
    return inner_hash(
        hash_from_byte_slices(items[:k]), hash_from_byte_slices(items[k:])
    )


@dataclass
class Proof:
    """Merkle inclusion proof (crypto/merkle/proof.go:21-27)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: List[bytes] = field(default_factory=list)

    def compute_root(self) -> bytes:
        h = self.leaf_hash
        idx, total = self.index, self.total
        path = []
        while total > 1:
            k = _split_point(total)
            if idx < k:
                path.append((False, None))  # sibling is the right subtree
                total = k
            else:
                path.append((True, None))
                idx -= k
                total -= k
        # walk back up pairing with aunts (deepest aunt first)
        for (right_side, _), aunt in zip(reversed(path), self.aunts):
            h = inner_hash(aunt, h) if right_side else inner_hash(h, aunt)
        return h

    def verify(self, root: bytes, leaf: bytes) -> bool:
        if self.total <= 0 or self.index < 0 or self.index >= self.total:
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        if len(self.aunts) != _depth(self.total, self.index):
            return False
        return self.compute_root() == root


def _depth(total: int, index: int) -> int:
    d = 0
    while total > 1:
        k = _split_point(total)
        if index < k:
            total = k
        else:
            index -= k
            total -= k
        d += 1
    return d


def proofs_from_byte_slices(items: Sequence[bytes]):
    """Returns (root, [Proof per item]) — proof.go ProofsFromByteSlices."""
    proofs: List[Optional[Proof]] = [None] * max(len(items), 0)

    def build(lo: int, hi: int) -> bytes:
        n = hi - lo
        if n == 0:
            return empty_hash()
        if n == 1:
            lh = leaf_hash(items[lo])
            proofs[lo] = Proof(len(items), lo, lh, [])
            return lh
        k = _split_point(n)
        left = build(lo, lo + k)
        right = build(lo + k, hi)
        for i in range(lo, lo + k):
            proofs[i].aunts.append(right)
        for i in range(lo + k, hi):
            proofs[i].aunts.append(left)
        return inner_hash(left, right)

    root = build(0, len(items))
    # recursion unwinds deepest-join first, so aunts are already
    # deepest-first — the order computeHashFromAunts consumes
    # (proof.go innerHashes[len-1] = top-level sibling)
    return root, proofs
