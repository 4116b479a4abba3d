"""RFC 6962 merkle root (crypto/merkle/tree.go HashFromByteSlices, leaf and
inner prefixes, getSplitPoint): the hash behind `ValidatorSet.hash`.

The 0x00/0x01 domain separation and the largest-power-of-two-less-than
split rule are consensus-critical. Proofs come with the slices that need
them.
"""
from __future__ import annotations

import hashlib
from typing import Sequence

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
