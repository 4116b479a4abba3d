"""ristretto255 host reference (RFC 9496) over edwards25519 bigints.

The prime-order group sr25519/schnorrkel signs in. Decode/encode/equality
here are the oracle the CUDA kernel (ops/sr25519_kernel.py) is
differential-tested against (a copy of the JAX package's
crypto/ristretto_ref.py). Reference seam: the voi `sr25519` package
the Go code imports (crypto/sr25519/pubkey.go:50) — CometBFT itself has
no ristretto code in-tree.
"""
from __future__ import annotations

from typing import Optional, Tuple

from cometbft_tpu_torch.crypto import ed25519_ref as ed

P = ed.P
D = ed.D
SQRT_M1 = ed.SQRT_M1


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if x & 1 else x


def sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """RFC 9496 SQRT_RATIO_M1: (was_square, sqrt(u/v) or sqrt(i*u/v))."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u = u % P
    correct = check == u
    flipped = check == (P - u) % P
    flipped_i = check == (P - u) * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    return (correct or flipped), _abs(r)


# 1/sqrt(a - d) with a = -1 (needed by ENCODE's rotation branch)
_ok, INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (-1 - D) % P)
assert _ok


def decode(b: bytes) -> Optional[tuple]:
    """32 bytes -> extended point (X, Y, Z, T) or None if invalid.

    Enforces canonical little-endian s < p, s non-negative, and the
    square/parity conditions of RFC 9496 §4.3.1.
    """
    if len(b) != 32:
        return None
    s = int.from_bytes(b, "little")
    if s >= P or s & 1:
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2s = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2s) % P
    was_square, invsqrt = sqrt_ratio_m1(1, v * u2s % P)
    if not was_square:
        return None
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def encode(pt: tuple) -> bytes:
    """Extended point -> canonical 32-byte encoding (RFC 9496 §4.3.2)."""
    X, Y, Z, T = pt
    u1 = (Z + Y) * (Z - Y) % P
    u2 = X * Y % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * T % P
    ix = X * SQRT_M1 % P
    iy = Y * SQRT_M1 % P
    if _is_negative(T * z_inv % P):
        x, y = iy, ix
        den_inv = den1 * INVSQRT_A_MINUS_D % P
    else:
        x, y = X, Y
        den_inv = den2
    if _is_negative(x * z_inv % P):
        y = (P - y) % P
    s = _abs(den_inv * ((Z - y) % P) % P)
    return s.to_bytes(32, "little")


def equals(p: tuple, q: tuple) -> bool:
    """Coset equality: X1Y2 == Y1X2 or Y1Y2 == X1X2 (RFC 9496 §4.5)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    return (X1 * Y2 - Y1 * X2) % P == 0 or (Y1 * Y2 - X1 * X2) % P == 0


def is_identity(p: tuple) -> bool:
    return equals(p, (0, 1, 1, 0))
