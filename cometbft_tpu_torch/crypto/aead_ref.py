"""Pure-Python AEAD + handshake primitives: the no-OpenSSL fallback.

RFC 8439 ChaCha20-Poly1305, RFC 7748 X25519, and RFC 5869 HKDF-SHA256,
API-compatible with the slices of `cryptography` that SecretConnection
and the symmetric sealer use. These exist so the p2p stack and key
handling degrade to interpreted speed — not to an ImportError — when
OpenSSL bindings are absent (the container-hardening rule: gate every
optional dependency). Correctness is pinned by RFC test vectors in
tests/test_symmetric.py / test_p2p.py interop, and the construction is
standard; throughput is good enough for handshakes and test meshes,
while production nodes should ship the `cryptography` wheel.
"""
from __future__ import annotations

import hashlib
import hmac
import struct


class InvalidTag(Exception):
    """Raised on AEAD authentication failure (cryptography.exceptions
    .InvalidTag stand-in — callers catch either via aead InvalidTag)."""


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


_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _chacha20_block(key32: tuple, counter: int, nonce12: bytes) -> bytes:
    s = list(_SIGMA) + list(key32) + [counter] + \
        list(struct.unpack("<3L", nonce12))
    w = s[:]
    for _ in range(10):
        _quarter(w, 0, 4, 8, 12)
        _quarter(w, 1, 5, 9, 13)
        _quarter(w, 2, 6, 10, 14)
        _quarter(w, 3, 7, 11, 15)
        _quarter(w, 0, 5, 10, 15)
        _quarter(w, 1, 6, 11, 12)
        _quarter(w, 2, 7, 8, 13)
        _quarter(w, 3, 4, 9, 14)
    return struct.pack("<16L", *((a + b) & _MASK for a, b in zip(w, s)))


def _chacha20_xor(key: bytes, counter: int, nonce12: bytes,
                  data: bytes) -> bytes:
    """Keystream XOR over all blocks at once via bigint-SIMD: each of
    the 16 state words is ONE Python int holding a 32-bit lane per
    block in 64-bit slots, so every add/xor/rotate of the double-round
    is a single C-level bigint op across all blocks. The 32 bits of
    padding absorb addition carries (masked each add); rotations can't
    cross lanes because r <= 16 and the downshift lands neighbors in
    the masked padding. ~10x the per-block scalar loop on CPython —
    this is every p2p frame's cost when OpenSSL is absent."""
    n = len(data)
    if n == 0:
        return b""
    nblk = -(-n // 64)
    rep = sum(1 << (64 * i) for i in range(nblk))
    mask = 0xFFFFFFFF * rep
    key32 = struct.unpack("<8L", key)
    non3 = struct.unpack("<3L", nonce12)
    s = ([v * rep for v in _SIGMA] + [v * rep for v in key32]
         + [sum((counter + i) << (64 * i) for i in range(nblk))]
         + [v * rep for v in non3])
    w = list(s)

    def qr(a, b, c, d):
        w[a] = (w[a] + w[b]) & mask
        x = w[d] ^ w[a]
        w[d] = ((x << 16) | (x >> 16)) & mask
        w[c] = (w[c] + w[d]) & mask
        x = w[b] ^ w[c]
        w[b] = ((x << 12) | (x >> 20)) & mask
        w[a] = (w[a] + w[b]) & mask
        x = w[d] ^ w[a]
        w[d] = ((x << 8) | (x >> 24)) & mask
        w[c] = (w[c] + w[d]) & mask
        x = w[b] ^ w[c]
        w[b] = ((x << 7) | (x >> 25)) & mask

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    import numpy as _np

    # lane j of word i -> keystream word i of block j: each word-int's
    # 64-bit little-endian slots carry the value in their low 4 bytes
    words = _np.stack([
        _np.frombuffer(
            ((w[i] + s[i]) & mask).to_bytes(8 * nblk, "little"), "<u8"
        ).astype(_np.uint32)
        for i in range(16)
    ])  # (16, nblk)
    stream = words.T.astype("<u4").tobytes()[:n]
    return bytes(
        _np.bitwise_xor(
            _np.frombuffer(data, _np.uint8),
            _np.frombuffer(stream, _np.uint8),
        ).tobytes()
    )


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    """RFC 8439 §2.5 one-shot MAC."""
    r = int.from_bytes(key32[:16], "little") \
        & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        blk = msg[i:i + 16]
        n = int.from_bytes(blk + b"\x01", "little")
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b"\x00" * (-len(b) % 16)


class ChaCha20Poly1305:
    """RFC 8439 AEAD; drop-in for cryptography's class of the same
    name (encrypt/decrypt(nonce, data, aad))."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("chacha20poly1305: key must be 32 bytes")
        self._key = bytes(key)

    def _tag(self, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
        otk = _chacha20_block(
            struct.unpack("<8L", self._key), 0, nonce
        )[:32]
        mac_data = (aad + _pad16(aad) + ct + _pad16(ct)
                    + struct.pack("<QQ", len(aad), len(ct)))
        return _poly1305(otk, mac_data)

    def encrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        if len(nonce) != 12:
            raise ValueError("chacha20poly1305: nonce must be 12 bytes")
        aad = aad or b""
        ct = _chacha20_xor(self._key, 1, nonce, data)
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes, aad) -> bytes:
        if len(nonce) != 12:
            raise ValueError("chacha20poly1305: nonce must be 12 bytes")
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than the tag")
        aad = aad or b""
        ct, tag = data[:-16], data[-16:]
        if not hmac.compare_digest(self._tag(nonce, ct, aad), tag):
            raise InvalidTag("poly1305 tag mismatch")
        return _chacha20_xor(self._key, 1, nonce, ct)


# -- X25519 (RFC 7748) -----------------------------------------------------

_P = 2 ** 255 - 19
_A24 = 121665


def _x25519_scalarmult(k: bytes, u: bytes) -> bytes:
    kn = int.from_bytes(k, "little")
    kn &= ~(7 << 0) & ((1 << 256) - 1)
    kn &= ~(128 << 248)
    kn |= 64 << 248
    un = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x1, x2, z2, x3, z3 = un, 1, 0, un, 1
    swap = 0
    for t in reversed(range(255)):
        kt = (kn >> t) & 1
        swap ^= kt
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = x1 * z3 * z3 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return (x2 * pow(z2, _P - 2, _P) % _P).to_bytes(32, "little")


_X25519_BASE = (9).to_bytes(32, "little")


class X25519PrivateKey:
    """Mirror of cryptography's class: generate/exchange/public_key."""

    def __init__(self, seed: bytes):
        self._seed = seed

    @staticmethod
    def generate() -> "X25519PrivateKey":
        import os as _os

        return X25519PrivateKey(_os.urandom(32))

    def public_key(self) -> "X25519PublicKey":
        return X25519PublicKey(
            _x25519_scalarmult(self._seed, _X25519_BASE)
        )

    def exchange(self, peer: "X25519PublicKey") -> bytes:
        out = _x25519_scalarmult(self._seed, peer._raw)
        if out == b"\x00" * 32:
            raise ValueError("x25519: low-order peer point")
        return out


class X25519PublicKey:
    def __init__(self, raw: bytes):
        self._raw = raw

    @staticmethod
    def from_public_bytes(raw: bytes) -> "X25519PublicKey":
        if len(raw) != 32:
            raise ValueError("x25519 pubkey must be 32 bytes")
        return X25519PublicKey(raw)

    def public_bytes_raw(self) -> bytes:
        return self._raw


def hkdf_sha256(ikm: bytes, salt: bytes, info: bytes,
                length: int) -> bytes:
    """RFC 5869 extract-and-expand."""
    prk = hmac.new(salt or b"\x00" * 32, ikm, hashlib.sha256).digest()
    okm = b""
    t = b""
    i = 1
    while len(okm) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]
