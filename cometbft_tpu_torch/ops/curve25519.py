"""edwards25519 point arithmetic: the host comb table (numpy) and the plain
torch point ops the CUDA verify kernel is held against.

Points are 4-tuples (X, Y, Z, T) of (..., NLIMBS) int64 limb tensors in
extended twisted Edwards coordinates (x = X/Z, y = Y/Z, T = XY/Z) on
-x^2 + y^2 = 1 + d x^2 y^2. The unified a = -1 formulas are complete, so
one branch-free circuit covers every signature, small-order points
included. Counterpart of the JAX package's ops/curve25519.py and the
limbs-first point helpers of ops/ed25519_pallas.py.
"""
from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.ops import field as fe

D2 = (2 * ref.D) % ref.P


def _limbs32(v: int) -> np.ndarray:
    return fe.int_to_limbs(v % ref.P).astype(np.int32)


def from_affine_int(x: int, y: int) -> np.ndarray:
    """Host: a (4, NLIMBS) int32 point from affine Python ints."""
    return np.stack([_limbs32(x), _limbs32(y), _limbs32(1),
                     _limbs32(x * y % ref.P)])


_BASE_TABLE8 = None


def base_table8_np() -> np.ndarray:
    """(32, 256, 4, NLIMBS) int32 width-8 comb table: entry [w][d] =
    [d * 256^w]B, normalized to Z = 1. Built incrementally (entry[d] =
    entry[d-1] + step): 8k host point adds, about 1.5 s once a process."""
    global _BASE_TABLE8
    if _BASE_TABLE8 is None:
        rows = []
        for w in range(32):
            step = ref.pt_mul(pow(256, w, ref.L), ref.BASE_EXT)
            acc = (0, 1, 1, 0)
            row = []
            for _ in range(256):
                zi = pow(acc[2], ref.P - 2, ref.P)
                x, y = acc[0] * zi % ref.P, acc[1] * zi % ref.P
                row.append(from_affine_int(x, y))
                acc = ref.pt_add(acc, step)
            rows.append(np.stack(row))
        _BASE_TABLE8 = np.stack(rows)
    return _BASE_TABLE8


# --------------------------------------------------------------------------
# plain torch point ops
# --------------------------------------------------------------------------


def identity(batch: int, device):
    zero = torch.zeros((batch, fe.NLIMBS), dtype=torch.int64, device=device)
    one = zero + fe.const(1, device)
    return (zero, one, one, zero)


def add(p, q):
    """Unified extended addition, add-2008-hwcd-3 for a = -1 (9M)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = fe.mul(fe.sub(Y1, X1), fe.sub(Y2, X2))
    B = fe.mul(fe.add(Y1, X1), fe.add(Y2, X2))
    C = fe.mul(fe.mul(T1, T2), fe.const(D2, T1.device))
    Dv = fe.mul_small(fe.mul(Z1, Z2), 2)
    E = fe.sub(B, A)
    Fv = fe.sub(Dv, C)
    G = fe.add(Dv, C)
    H = fe.add(B, A)
    return (fe.mul(E, Fv), fe.mul(G, H), fe.mul(Fv, G), fe.mul(E, H))


def double(p):
    """Extended doubling, dbl-2008-hwcd (4M + 4S); T of the input unused."""
    X1, Y1, Z1 = p[0], p[1], p[2]
    A = fe.square(X1)
    B = fe.square(Y1)
    C = fe.mul_small(fe.square(Z1), 2)
    H = fe.add(A, B)
    E = fe.sub(H, fe.square(fe.add(X1, Y1)))
    G = fe.sub(A, B)
    Fv = fe.add(C, G)
    return (fe.mul(E, Fv), fe.mul(G, H), fe.mul(Fv, G), fe.mul(E, H))


def neg(p):
    X, Y, Z, T = p
    return (-X, Y, Z, -T)


def is_identity(p):
    """Projective identity check: X == 0 and Y == Z (mod p)."""
    X, Y, Z, _ = p
    return fe.is_zero(X) & fe.eq(Y, Z)


def decompress(y, sign):
    """ZIP-215 decompression of (..., NLIMBS) y limbs (the low 255 bits of
    the encoding, NOT reduced) and (...,) sign bits -> (point, ok).

    On ok = False the point is garbage and the caller must mask. Mirrors
    ed25519_ref.pt_decompress(zip215=True): for x = 0 with the sign bit set
    the flip gives -0 = 0, ZIP-215's accept-(-0) rule.
    """
    dev = y.device
    one = fe.const(1, dev)
    yy = fe.square(y)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(yy, fe.const(ref.D, dev)), one)
    v3 = fe.mul(fe.square(v), v)
    v7 = fe.mul(fe.square(v3), v)
    r = fe.mul(fe.mul(u, v3), fe.pow_p58(fe.mul(u, v7)))
    check = fe.mul(v, fe.square(r))
    is_pos = fe.eq(check, u)
    is_neg = fe.is_zero(check + u)
    ok = is_pos | is_neg
    r = torch.where(is_neg.unsqueeze(-1),
                    fe.mul(r, fe.const(ref.SQRT_M1, dev)), r)
    flip = fe.parity(r) != sign
    x = torch.where(flip.unsqueeze(-1), -r, r)
    z = torch.zeros_like(y) + one
    return (x, y, z, fe.mul(x, y)), ok


def scalar_mul_windowed(digits, p):
    """[k]P per element, k as (B, 64) base-16 digits (digit w has weight
    16^w): a 16-entry table [d]P, then 63 windows of 4 doublings and one
    table add (Horner, top digit first)."""
    B = digits.shape[0]
    entries = [identity(B, digits.device)]
    for _ in range(15):
        entries.append(add(entries[-1], p))
    tbl = [torch.stack([e[c] for e in entries]) for c in range(4)]
    cols = torch.arange(B, device=digits.device)

    def lookup(d):
        return tuple(t[d, cols] for t in tbl)

    acc = lookup(digits[:, 63])
    for w in range(62, -1, -1):
        acc = double(double(double(double(acc))))
        acc = add(acc, lookup(digits[:, w]))
    return acc


def base_scalar_mul(bytes_, table):
    """[s]B for the fixed base, s as (B, 32) byte digits: a width-8 comb
    over the (32, 256, 4, NLIMBS) `table`, 32 adds and no doublings."""
    B = bytes_.shape[0]
    acc = identity(B, bytes_.device)
    for w in range(32):
        ent = table[w, bytes_[:, w]]  # (B, 4, NLIMBS)
        acc = add(acc, tuple(ent[:, c] for c in range(4)))
    return acc
