"""Pure-Python ed25519: RFC 8032 keys and signing, ZIP-215 verification.

A frozen copy of cometbft_tpu_torch/crypto/ed25519_ref.py at commit
11dbd9c1db08fa78cfd421f2794b4ad265f950b7 (the curve arithmetic, the point
decoding and `verify`), kept here so that the reference shares no code
with the program it judges. [S]B goes through a fixed-base comb, which
gives the same point as the copied double-and-add and makes a verify
about twice as fast.

Verification is ZIP-215, the option set CometBFT pins for consensus
(crypto/ed25519/ed25519.go: cofactored equation, non-canonical point
encodings accepted, S < L required).
"""
from __future__ import annotations

import hashlib
from typing import Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
IDENT = (0, 1, 1, 0)


def _sqrt_ratio(u: int, v: int) -> Tuple[bool, int]:
    """(ok, sqrt(u/v)) in GF(p); ok is False when u/v is not a square."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    if check == u % P:
        return True, r
    if check == (P - u) % P:
        return True, r * SQRT_M1 % P
    return False, 0


_BY = 4 * pow(5, P - 2, P) % P
_ok, _BX = _sqrt_ratio(_BY * _BY - 1, D * _BY * _BY + 1)
if _BX % 2:
    _BX = P - _BX
BASE = (_BX, _BY, 1, _BX * _BY % P)  # extended coordinates (X, Y, Z, T)


def pt_add(p, q):
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * T1 * T2 % P * D % P
    Dv = 2 * Z1 * Z2 % P
    E, F, G, H = (B - A) % P, (Dv - C) % P, (Dv + C) % P, (B + A) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_double(p):
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = (A + B) % P
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = (A - B) % P
    F = (C + G) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_neg(p):
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def pt_mul(k: int, p):
    q = IDENT
    while k > 0:
        if k & 1:
            q = pt_add(q, p)
        p = pt_double(p)
        k >>= 1
    return q


def pt_equal(p, q) -> bool:
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def pt_compress(p) -> bytes:
    X, Y, Z, _ = p
    zi = pow(Z, P - 2, P)
    x, y = X * zi % P, Y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def pt_decompress(s: bytes):
    """ZIP-215 decoding: y >= p and the x = 0, sign = 1 encoding are
    accepted. Returns the point or None."""
    if len(s) != 32:
        return None
    n = int.from_bytes(s, "little")
    sign = n >> 255
    y = (n & ((1 << 255) - 1)) % P
    ok, x = _sqrt_ratio((y * y - 1) % P, (D * y * y + 1) % P)
    if not ok:
        return None
    if x != 0 and (x & 1) != sign:
        x = P - x
    return (x, y, 1, x * y % P)


_COMB = []


def _base_mul(k: int):
    """[k]B for 0 <= k < 2^256 by a radix-16 fixed-base comb."""
    if not _COMB:
        step = BASE
        for _ in range(64):
            row = [IDENT]
            for _ in range(15):
                row.append(pt_add(row[-1], step))
            _COMB.append(row)
            step = pt_double(pt_double(pt_double(pt_double(step))))
    q = IDENT
    for w in range(64):
        q = pt_add(q, _COMB[w][(k >> (4 * w)) & 15])
    return q


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    return a | (1 << 254)


def public_key(seed: bytes) -> bytes:
    """RFC 8032 public key of a 32-byte seed."""
    return pt_compress(_base_mul(_clamp(hashlib.sha512(seed).digest())))


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 Ed25519 signature (deterministic nonce)."""
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    pub = pt_compress(_base_mul(a))
    r = int.from_bytes(hashlib.sha512(h[32:] + msg).digest(), "little") % L
    rb = pt_compress(_base_mul(r))
    k = int.from_bytes(hashlib.sha512(rb + pub + msg).digest(), "little") % L
    return rb + int.to_bytes((r + k * a) % L, 32, "little")


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215: accept iff [8][S]B == [8]R + [8][h]A, S < L, and both
    encodings decode."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    A = pt_decompress(pub)
    R = pt_decompress(sig[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    h = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(),
                       "little") % L
    diff = pt_add(pt_add(_base_mul(s), pt_neg(pt_mul(h, A))), pt_neg(R))
    return pt_equal(pt_double(pt_double(pt_double(diff))), IDENT)
