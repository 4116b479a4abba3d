"""tmhash: SHA-256 and the 20-byte truncated variant.

Reference: crypto/tmhash/hash.go (Sum, SumTruncated, TruncatedSize=20).
Addresses are SumTruncated(pubkey) — crypto/crypto.go:18-20.
"""
import hashlib

SIZE = 32
TRUNCATED_SIZE = 20


def sum(b: bytes) -> bytes:  # noqa: A001 - mirrors reference name
    return hashlib.sha256(b).digest()


def sum_truncated(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()[:TRUNCATED_SIZE]
