"""secp256k1 point arithmetic: the host comb table (numpy) and the plain
torch point ops the CUDA ECDSA kernel is held against.

Points are 3-tuples (X, Y, Z) of (..., NLIMBS) int64 limb tensors in
homogeneous projective coordinates, x = X/Z, y = Y/Z on y^2 = x^3 + 7;
the identity is (0 : 1 : 0). Addition and doubling use the
Renes-Costello-Batina complete formulas for a = 0 (eprint 2015/1060,
algorithms 7 and 9, b3 = 21): no exceptional cases, so one branch-free
circuit covers every signature. Counterpart of the JAX package's
ops/secp256k1.py and the point helpers of ops/ecdsa_pallas.py.
"""
from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.crypto import secp256k1_ref as ref
from cometbft_tpu_torch.ops.field import FSECP, NLIMBS

F = FSECP
B3 = 3 * ref.B  # 21: the only curve constant in the complete formulas


def from_affine_int(x: int, y: int) -> np.ndarray:
    """Host: a (3, NLIMBS) int32 point from affine Python ints."""
    return np.stack([F.from_int(x), F.from_int(y), F.from_int(1)])


_BASE_TABLE8 = None


def base_table8_np() -> np.ndarray:
    """(32, 256, 3, NLIMBS) int32 width-8 comb table: entry [w][d] =
    [d * 256^w]G with Z = 1, and (0, 1, 0) at d = 0 (the complete formulas
    absorb it). Built incrementally, 8k affine host additions, about
    0.2 s once a process; limb for limb the JAX package's
    ecdsa_pallas.base_table8_np()."""
    global _BASE_TABLE8
    if _BASE_TABLE8 is None:
        inf = np.stack([F.from_int(0), F.from_int(1), F.from_int(0)])
        rows = []
        g_w = (ref.GX, ref.GY)  # [256^w]G
        for _ in range(32):
            row, acc = [inf], None
            for _ in range(255):
                acc = ref.pt_add(acc, g_w)
                row.append(from_affine_int(acc[0], acc[1]))
            rows.append(np.stack(row))
            for _ in range(8):
                g_w = ref.pt_add(g_w, g_w)
        _BASE_TABLE8 = np.stack(rows)
    return _BASE_TABLE8


# --------------------------------------------------------------------------
# plain torch point ops
# --------------------------------------------------------------------------


def identity(batch: int, device):
    zero = torch.zeros((batch, NLIMBS), dtype=torch.int64, device=device)
    return (zero, zero + F.const(1, device), zero)


def add(p, q):
    """Complete addition, algorithm 7 (12M)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t2 = F.mul(Z1, Z2)
    t3 = F.sub(F.mul(F.add(X1, Y1), F.add(X2, Y2)), F.add(t0, t1))
    t4 = F.sub(F.mul(F.add(Y1, Z1), F.add(Y2, Z2)), F.add(t1, t2))
    Y3 = F.sub(F.mul(F.add(X1, Z1), F.add(X2, Z2)), F.add(t0, t2))
    t0 = F.mul_small(t0, 3)
    t2 = F.mul_small(t2, B3)
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    Y3 = F.mul_small(Y3, B3)
    return (F.sub(F.mul(t3, t1), F.mul(t4, Y3)),
            F.add(F.mul(t1, Z3), F.mul(Y3, t0)),
            F.add(F.mul(Z3, t4), F.mul(t0, t3)))


def double(p):
    """Complete doubling, algorithm 9 (6M + 2S)."""
    X, Y, Z = p
    t0 = F.square(Y)
    Z3 = F.mul_small(t0, 8)
    t1 = F.mul(Y, Z)
    t2 = F.mul_small(F.square(Z), B3)
    X3 = F.mul(t2, Z3)
    Y3 = F.add(t0, t2)
    Z3 = F.mul(t1, Z3)
    t2 = F.mul_small(t2, 3)
    t0 = F.sub(t0, t2)
    return (F.mul_small(F.mul(F.mul(X, Y), t0), 2),
            F.add(X3, F.mul(t0, Y3)), Z3)


def decompress(x, parity):
    """Compressed-key decompression of (..., NLIMBS) x limbs (the host
    prechecks x < p) and (...,) parity bits (the 0x02/0x03 prefix's low
    bit) -> (point, ok); the point is garbage where ok is False."""
    dev = x.device
    yy = F.add(F.mul(F.square(x), x), F.const(ref.B, dev))
    y = F.pow_sqrt(yy)  # p = 3 (mod 4)
    ok = F.eq(F.square(y), yy)
    flip = F.parity(y) != parity
    y = torch.where(flip.unsqueeze(-1), -y, y)
    return (x, y, torch.zeros_like(x) + F.const(1, dev)), ok


def scalar_mul_windowed(digits, p):
    """[k]P per element, k as (B, 64) base-16 digits (digit w has weight
    16^w): a 16-entry table [d]P, then 63 windows of 4 doublings and one
    table add (Horner, top digit first)."""
    B = digits.shape[0]
    entries = [identity(B, digits.device)]
    for _ in range(15):
        entries.append(add(entries[-1], p))
    tbl = [torch.stack([e[c] for e in entries]) for c in range(3)]
    cols = torch.arange(B, device=digits.device)

    def lookup(d):
        return tuple(t[d, cols] for t in tbl)

    acc = lookup(digits[:, 63])
    for w in range(62, -1, -1):
        acc = double(double(double(double(acc))))
        acc = add(acc, lookup(digits[:, w]))
    return acc


def base_scalar_mul(bytes_, table):
    """[k]G for the fixed base, k as (B, 32) byte digits: a width-8 comb
    over the (32, 256, 3, NLIMBS) `table`, 32 adds and no doublings."""
    acc = identity(bytes_.shape[0], bytes_.device)
    for w in range(32):
        ent = table[w, bytes_[:, w]]  # (B, 3, NLIMBS)
        acc = add(acc, tuple(ent[:, c] for c in range(3)))
    return acc
