"""Pure-Python ed25519: RFC 8032 signing + ZIP-215 verification semantics.

The host-side reference implementation of the curve, kept byte for byte
with the JAX package's oracle. It is:

1. The differential-test oracle for the batched CUDA verifier
   (`cometbft_tpu_torch.ops.ed25519_fused`).
2. The single-signature path (`PubKey.verify_signature`, the
   validation loop below the batch threshold), mirroring the reference's
   crypto/ed25519/ed25519.go:181 ``PubKey.VerifySignature``.
3. The signer of test and benchmark fixtures. `sign` is variable-time
   Python bigint arithmetic: fine for fixtures, leaky for a long-term
   validator key.

Verification semantics are ZIP-215 (cofactored equation, non-canonical point
encodings accepted), exactly matching the verification options the reference
pins for consensus compatibility (crypto/ed25519/ed25519.go:40-42:
cofactorless=false, canonical A/R not required, S < L required). Getting
these edge cases identical on the host and the GPU is consensus-critical: a
divergence forks the chain.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

# --- field / curve constants -------------------------------------------------

P = 2**255 - 19  # base field prime
L = 2**252 + 27742317777372353535851937790883648493  # group order
D = (-121665 * pow(121666, P - 2, P)) % P  # edwards d
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)

# Base point
_By = 4 * pow(5, P - 2, P) % P


def _sqrt_ratio(u: int, v: int) -> Tuple[bool, int]:
    """Return (ok, sqrt(u/v)) in GF(p); ok=False if u/v is not a square."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    if check == u % P:
        return True, r
    if check == (P - u) % P:
        return True, r * SQRT_M1 % P
    return False, 0


_ok, _Bx = _sqrt_ratio(_By * _By - 1, D * _By * _By + 1)
assert _ok
if _Bx % 2 != 0:
    _Bx = P - _Bx
BASE = (_Bx, _By)
BASE_EXT = (_Bx, _By, 1, _Bx * _By % P)  # extended coords, the one authoritative copy

# --- extended-coordinate point arithmetic ------------------------------------
# Points are (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z.

IDENT = (0, 1, 1, 0)


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


def pt_is_small_order(p) -> bool:
    return pt_equal(pt_double(pt_double(pt_double(p))), IDENT)


# --- encoding ----------------------------------------------------------------


def pt_compress(p) -> bytes:
    X, Y, Z, _ = p
    zi = pow(Z, P - 2, P)
    x, y = X * zi % P, Y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def pt_decompress(s: bytes, zip215: bool = True):
    """Decode a 32-byte point encoding. Returns (point|None, was_canonical).

    ZIP-215 mode accepts non-canonical y (y >= p) and the x=0/sign=1
    encodings; strict RFC 8032 mode rejects both.
    """
    if len(s) != 32:
        return None, False
    n = int.from_bytes(s, "little")
    sign = n >> 255
    y = n & ((1 << 255) - 1)
    y_canonical = y < P
    if not zip215 and not y_canonical:
        return None, False
    y %= P
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    ok, x = _sqrt_ratio(u, v)
    if not ok:
        return None, y_canonical
    canonical = y_canonical and not (x == 0 and sign == 1)
    if x == 0 and sign == 1:
        if not zip215:
            return None, canonical
        # ZIP-215: -0 == 0; accept and use x = 0.
    elif (x & 1) != sign:
        x = P - x
    return (x, y, 1, x * y % P), canonical


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


# --- keys / sign / verify ----------------------------------------------------


def pubkey_from_seed(seed: bytes) -> bytes:
    assert len(seed) == 32
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    return pt_compress(pt_mul(a, BASE_EXT))


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 Ed25519 signature (deterministic nonce)."""
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    prefix = h[32:]
    A = pubkey_from_seed(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    Rb = pt_compress(pt_mul(r, BASE_EXT))
    k = int.from_bytes(hashlib.sha512(Rb + A + msg).digest(), "little") % L
    s = (r + k * a) % L
    return Rb + int.to_bytes(s, 32, "little")


def challenge_scalar(sig_r: bytes, pubkey: bytes, msg: bytes) -> int:
    """h = SHA512(R || A || M) mod L — the per-signature challenge.

    The wire bytes of R and A are hashed as received (even when they are
    non-canonical encodings), which is why the device kernel takes this value
    precomputed on host rather than re-deriving it from decoded points.
    """
    return int.from_bytes(hashlib.sha512(sig_r + pubkey + msg).digest(), "little") % L


def verify(pubkey: bytes, msg: bytes, sig: bytes, zip215: bool = True) -> bool:
    """ZIP-215 (default) or strict-RFC8032 ed25519 verification.

    ZIP-215 accepts iff [8][S]B == [8]R + [8][h]A with S < L and both point
    encodings decodable (canonicity not required). Mirrors the exact option
    set the reference uses (crypto/ed25519/ed25519.go:40-42).
    """
    if len(sig) != 64 or len(pubkey) != 32:
        return False
    A, _ = pt_decompress(pubkey, zip215=zip215)
    if A is None:
        return False
    Rb, sb = sig[:32], sig[32:]
    R, _ = pt_decompress(Rb, zip215=zip215)
    if R is None:
        return False
    s = int.from_bytes(sb, "little")
    if s >= L:
        return False  # malleability check: required in both modes
    # (strict mode: non-canonical encodings were already rejected inside
    # pt_decompress, so no further canonicity check is needed here)
    h = challenge_scalar(Rb, pubkey, msg)
    # [S]B - [h]A - R, then multiply by 8 and compare with identity.
    sB = pt_mul(s, BASE_EXT)
    hA = pt_mul(h, A)
    diff = pt_add(pt_add(sB, pt_neg(hA)), pt_neg(R))
    if zip215:
        return pt_is_small_order(diff)
    return pt_equal(diff, IDENT)


# --- batch signing for fixtures ----------------------------------------------

_COMB16 = None


def _base_mul(k: int):
    """[k]B by a radix-16 fixed-base comb: 64 point adds, no doublings
    (table of [d * 16^w]B built once a process). Same result as
    pt_mul(k, BASE_EXT)."""
    global _COMB16
    if _COMB16 is None:
        rows = []
        step = BASE_EXT
        for _ in range(64):
            row = [IDENT]
            for _ in range(15):
                row.append(pt_add(row[-1], step))
            rows.append(row)
            step = pt_double(pt_double(pt_double(pt_double(step))))
        _COMB16 = rows
    q = IDENT
    for w in range(64):
        q = pt_add(q, _COMB16[w][(k >> (4 * w)) & 15])
    return q


def sign_many(seed: bytes, msgs) -> Tuple[bytes, list]:
    """(pubkey, [RFC 8032 signature of each msg]) for one seed: the key is
    derived once and every [k]B goes through the fixed-base comb. Byte-equal
    to pubkey_from_seed(seed) and [sign(seed, m) for m in msgs]."""
    h = hashlib.sha512(seed).digest()
    a = _clamp(h)
    prefix = h[32:]
    A = pt_compress(_base_mul(a % L))
    sigs = []
    for msg in msgs:
        r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
        Rb = pt_compress(_base_mul(r))
        k = int.from_bytes(hashlib.sha512(Rb + A + msg).digest(), "little") % L
        sigs.append(Rb + int.to_bytes((r + k * a) % L, 32, "little"))
    return A, sigs
