"""Pure-Python secp256k1 ECDSA oracle and fixture signer.

The port's copy of the JAX package's crypto/secp256k1_ref.py. Semantics
mirror the reference's secp256k1 component (crypto/secp256k1/secp256k1.go):
- 33-byte compressed pubkeys (0x02/0x03 prefix),
- 64-byte r||s big-endian signatures,
- VerifySignature rejects malleable (high-S) signatures
  (secp256k1.go:204-208),
- address = RIPEMD160(SHA256(compressed pubkey)) (secp256k1.go:131).

The JAX package signs through OpenSSL when `cryptography` is installed; this
copy is pure Python everywhere (RFC 6979 deterministic k, low-S), so a host
without `cryptography` signs and verifies the same way. `pt_add`/`pt_mul`
are the affine oracle; signing, key derivation and `verify_py` run the same
group law in Jacobian coordinates with a fixed-base comb for G, which gives
the same points about 20x faster. RIPEMD-160 comes from hashlib when its
OpenSSL provides it, else from the pure-Python `ripemd160` below.
"""
from __future__ import annotations

import hashlib
import hmac as _hmac
import struct
from typing import Optional, Tuple

# Curve parameters: y^2 = x^3 + 7 over F_p, group order N.
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
B = 7
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

HALF_N = N // 2


# -- affine group ops (None = point at infinity): the oracle ----------------


def pt_add(a: Optional[Tuple[int, int]], b: Optional[Tuple[int, int]]):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def pt_mul(k: int, p: Optional[Tuple[int, int]]):
    acc = None
    while k:
        if k & 1:
            acc = pt_add(acc, p)
        p = pt_add(p, p)
        k >>= 1
    return acc


# -- Jacobian group ops (X, Y, Z), x = X/Z^2, y = Y/Z^3; None = infinity -----


def _jdouble(p):
    if p is None:
        return None
    X, Y, Z = p
    if Y == 0:
        return None
    A = X * X % P
    Bv = Y * Y % P
    C = Bv * Bv % P
    D = 2 * ((X + Bv) * (X + Bv) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    return X3, (E * (D - X3) - 8 * C) % P, 2 * Y * Z % P


def _jadd_affine(p, q):
    """Jacobian p + affine q (either may be None)."""
    if q is None:
        return p
    if p is None:
        return q[0], q[1], 1
    X1, Y1, Z1 = p
    x2, y2 = q
    z1z1 = Z1 * Z1 % P
    H = (x2 * z1z1 - X1) % P
    r = (y2 * Z1 * z1z1 - Y1) % P
    if H == 0:
        return _jdouble(p) if r == 0 else None
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    X3 = (r * r - HHH - 2 * V) % P
    return X3, (r * (V - X3) - Y1 * HHH) % P, Z1 * H % P


def _to_affine(p):
    if p is None:
        return None
    X, Y, Z = p
    zi = pow(Z, P - 2, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


_COMB16 = None


def _base_mul(k: int):
    """[k]G (affine, None for infinity) by a radix-16 fixed-base comb: 64
    mixed additions over a table of [d * 16^w]G built once a process.
    Same point as pt_mul(k % N, (GX, GY))."""
    global _COMB16
    if _COMB16 is None:
        rows, g_w = [], (GX, GY)
        for _ in range(64):
            row, acc = [None], None
            for _ in range(15):
                acc = pt_add(acc, g_w)
                row.append(acc)
            rows.append(row)
            for _ in range(4):
                g_w = pt_add(g_w, g_w)
        _COMB16 = rows
    k %= N
    acc = None
    for w in range(64):
        acc = _jadd_affine(acc, _COMB16[w][(k >> (4 * w)) & 15])
    return _to_affine(acc)


def _mul(k: int, q):
    """[k]Q for an affine point Q by Jacobian double-and-add, top bit
    first. Same point as pt_mul(k, q)."""
    acc = None
    for i in range(k.bit_length() - 1, -1, -1):
        acc = _jdouble(acc)
        if (k >> i) & 1:
            acc = _jadd_affine(acc, q)
    return _to_affine(acc)


# -- encoding --------------------------------------------------------------


def compress(x: int, y: int) -> bytes:
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def decompress(pub: bytes) -> Optional[Tuple[int, int]]:
    """33-byte compressed key -> (x, y), or None if invalid/not on curve."""
    if len(pub) != 33 or pub[0] not in (2, 3):
        return None
    x = int.from_bytes(pub[1:], "big")
    if x >= P:
        return None
    yy = (pow(x, 3, P) + B) % P
    y = pow(yy, (P + 1) // 4, P)  # p ≡ 3 (mod 4)
    if y * y % P != yy:
        return None
    if (y & 1) != (pub[0] & 1):
        y = P - y
    return x, y


def pubkey_from_secret(d: int) -> bytes:
    """Compressed pubkey of the secret scalar d."""
    return compress(*_base_mul(d))


# -- RIPEMD-160 (ISO/IEC 10118-3), for hosts whose OpenSSL lacks it ---------

_RL = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]
_RR = [
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]
_SL = [
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]
_SR = [
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]
_KL = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_KR = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]
_M32 = 0xFFFFFFFF


def _f(j: int, x: int, y: int, z: int) -> int:
    if j == 0:
        return x ^ y ^ z
    if j == 1:
        return (x & y) | (~x & z)
    if j == 2:
        return (x | ~y & _M32) ^ z
    if j == 3:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z & _M32)


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def ripemd160(data: bytes) -> bytes:
    """Pure-Python RIPEMD-160 digest."""
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    msg = bytes(data) + b"\x80"
    msg += b"\x00" * ((56 - len(msg)) % 64)
    msg += struct.pack("<Q", 8 * len(data))
    for off in range(0, len(msg), 64):
        X = struct.unpack("<16I", msg[off:off + 64])
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            r = j // 16
            t = (_rol((al + _f(r, bl, cl, dl) + X[_RL[j]] + _KL[r]) & _M32,
                      _SL[j]) + el) & _M32
            al, el, dl, cl, bl = el, dl, _rol(cl, 10), bl, t
            t = (_rol((ar + _f(4 - r, br, cr, dr) + X[_RR[j]] + _KR[r])
                      & _M32, _SR[j]) + er) & _M32
            ar, er, dr, cr, br = er, dr, _rol(cr, 10), br, t
        h = [(h[1] + cl + dr) & _M32, (h[2] + dl + er) & _M32,
             (h[3] + el + ar) & _M32, (h[4] + al + br) & _M32,
             (h[0] + bl + cr) & _M32]
    return struct.pack("<5I", *h)


def ripemd160_source() -> str:
    """'hashlib' when this host's OpenSSL provides RIPEMD-160, else
    'python'."""
    try:
        hashlib.new("ripemd160")
        return "hashlib"
    except ValueError:
        return "python"


def address(pub: bytes) -> bytes:
    """RIPEMD160(SHA256(compressed pubkey)) (secp256k1.go:131)."""
    digest = hashlib.sha256(pub).digest()
    if ripemd160_source() == "hashlib":
        return hashlib.new("ripemd160", digest).digest()
    return ripemd160(digest)


# -- sign / verify ---------------------------------------------------------


def _rfc6979_k(d: int, z: int) -> int:
    """RFC 6979 deterministic nonce (SHA-256)."""
    x = d.to_bytes(32, "big")
    h1 = (z % N).to_bytes(32, "big")
    V = b"\x01" * 32
    K = b"\x00" * 32
    K = _hmac.new(K, V + b"\x00" + x + h1, hashlib.sha256).digest()
    V = _hmac.new(K, V, hashlib.sha256).digest()
    K = _hmac.new(K, V + b"\x01" + x + h1, hashlib.sha256).digest()
    V = _hmac.new(K, V, hashlib.sha256).digest()
    while True:
        V = _hmac.new(K, V, hashlib.sha256).digest()
        k = int.from_bytes(V, "big")
        if 1 <= k < N:
            return k
        K = _hmac.new(K, V + b"\x00", hashlib.sha256).digest()
        V = _hmac.new(K, V, hashlib.sha256).digest()


def sign(d: int, msg: bytes) -> bytes:
    """ECDSA-SHA256 with an RFC 6979 nonce, low-S normalized, 64-byte
    r||s big-endian."""
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    while True:
        k = _rfc6979_k(d, z)
        pt = _base_mul(k)
        if pt is None:
            continue
        r = pt[0] % N
        if r == 0:
            continue
        s = (z + r * d) * pow(k, N - 2, N) % N
        if s == 0:
            continue
        if s > HALF_N:
            s = N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def sign_many(d: int, msgs):
    """(pubkey, [sign(d, m) for m in msgs]) for one secret scalar."""
    return pubkey_from_secret(d), [sign(d, m) for m in msgs]


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ECDSA verify with the reference's malleability rule: s > N/2 is
    rejected outright (secp256k1.go:204-208); only 33-byte compressed keys
    (secp256k1.go:33 PubKeySize)."""
    if len(pub) != 33 or pub[0] not in (2, 3):
        return False
    return verify_py(pub, msg, sig)


def verify_py(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """Pure-Python ECDSA verify (differential-test oracle)."""
    if len(sig) != 64:
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (1 <= r < N and 1 <= s <= HALF_N):
        return False
    q = decompress(pub)
    if q is None:
        return False
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    w = pow(s, N - 2, N)
    u1 = z * w % N
    u2 = r * w % N
    pt = pt_add(_base_mul(u1), _mul(u2, q))
    if pt is None:
        return False
    return pt[0] % N == r
