"""Symmetric AEAD: XChaCha20-Poly1305.

Reference: crypto/xchacha20poly1305/xchachapoly.go (24-byte-nonce AEAD
used for key-file sealing). The construction is standard (draft-irtf-
cfrg-xchacha): HChaCha20(key, nonce[:16]) derives a subkey, then
ChaCha20-Poly1305 runs with nonce (4 zero bytes || nonce[16:24]).
HChaCha20 is implemented here (the `cryptography` library ships only
the 12-byte-nonce IETF ChaCha20-Poly1305); test vectors from the CFRG
draft pin the construction.
"""
from __future__ import annotations

import os
import struct

try:
    from cryptography.hazmat.primitives.ciphers.aead import (
        ChaCha20Poly1305,
    )
except ImportError:  # pure-Python RFC 8439 fallback
    from cometbft_tpu_torch.crypto.aead_ref import ChaCha20Poly1305

KEY_SIZE = 32
NONCE_SIZE = 24
TAG_SIZE = 16

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_MASK = 0xFFFFFFFF


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK


def _quarter(s, a, b, c, d) -> None:
    s[a] = (s[a] + s[b]) & _MASK
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _MASK
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & _MASK
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _MASK
    s[b] = _rotl(s[b] ^ s[c], 7)


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """HChaCha20 subkey derivation (draft-irtf-cfrg-xchacha §2.2)."""
    if len(key) != 32 or len(nonce16) != 16:
        raise ValueError("hchacha20: key must be 32B, nonce 16B")
    s = list(_SIGMA) + list(struct.unpack("<8L", key)) + \
        list(struct.unpack("<4L", nonce16))
    for _ in range(10):
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    return struct.pack("<4L", *s[0:4]) + struct.pack("<4L", *s[12:16])


class XChaCha20Poly1305:
    """AEAD with a 24-byte nonce (xchachapoly.go New)."""

    def __init__(self, key: bytes):
        if len(key) != KEY_SIZE:
            raise ValueError("xchacha20poly1305: bad key length")
        self._key = key

    def _inner(self, nonce: bytes) -> tuple:
        if len(nonce) != NONCE_SIZE:
            raise ValueError("xchacha20poly1305: bad nonce length")
        subkey = hchacha20(self._key, nonce[:16])
        return ChaCha20Poly1305(subkey), b"\x00" * 4 + nonce[16:]

    def seal(self, nonce: bytes, plaintext: bytes,
             aad: bytes = b"") -> bytes:
        aead, n12 = self._inner(nonce)
        return aead.encrypt(n12, plaintext, aad or None)

    def open(self, nonce: bytes, ciphertext: bytes,
             aad: bytes = b"") -> bytes:
        """Raises cryptography.exceptions.InvalidTag on tamper."""
        aead, n12 = self._inner(nonce)
        return aead.decrypt(n12, ciphertext, aad or None)


def seal_with_random_nonce(key: bytes, plaintext: bytes,
                           aad: bytes = b"") -> bytes:
    """nonce || ciphertext convenience (key-file sealing shape)."""
    nonce = os.urandom(NONCE_SIZE)
    return nonce + XChaCha20Poly1305(key).seal(nonce, plaintext, aad)


def open_sealed(key: bytes, sealed: bytes, aad: bytes = b"") -> bytes:
    if len(sealed) < NONCE_SIZE + TAG_SIZE:
        raise ValueError("sealed blob too short")
    return XChaCha20Poly1305(key).open(
        sealed[:NONCE_SIZE], sealed[NONCE_SIZE:], aad
    )
