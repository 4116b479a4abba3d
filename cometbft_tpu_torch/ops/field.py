"""GF(2^255 - 19) in 13-bit x 20 limbs: host packing on numpy, and the
plain field ops on torch integer tensors.

The limb layout is the JAX package's (ops/field.py): limb i holds bits
[13 i, 13 i + 13) of the value. The packed-row ABI ships field elements in
it, so `from_bytes_le` is byte for byte the JAX package's.

The torch ops are the plain versions the CUDA kernel is held against. They
run on int64 tensors of shape (..., NLIMBS) on any device, so there is
headroom to spare: inputs keep |limb| < 2^15, a schoolbook column is
< 20 * 2^30 and its fold through 2^260 = 608 (mod p) stays < 2^45.
Every op returns limbs with |limb| < 2^14 (`carry`). Canonical form
(`canonical`) is only needed for equality and parity.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LIMB_BITS = 13
NLIMBS = 20
MASK = (1 << LIMB_BITS) - 1
P = 2**255 - 19
FOLD260 = (1 << (LIMB_BITS * NLIMBS)) % P  # 608: weight of limb 20
_TOP_SHIFT = 255 - LIMB_BITS * (NLIMBS - 1)  # 8: bit 255 inside limb 19


def int_to_limbs(v: int, n: int = NLIMBS) -> np.ndarray:
    """Nonnegative int -> (n,) int64 13-bit limbs (the top limb keeps any
    bits past 13 n)."""
    out = [(v >> (LIMB_BITS * i)) & MASK for i in range(n - 1)]
    out.append(v >> (LIMB_BITS * (n - 1)))
    return np.asarray(out, np.int64)


def limbs_to_int(limbs):
    """Host: recompose (possibly signed or wide) limbs into Python ints;
    a Python int for 1-D input, an object ndarray otherwise."""
    obj = np.asarray(limbs).astype(object)
    out = 0
    for i in range(obj.shape[-1]):
        out = out + (obj[..., i] << (LIMB_BITS * i))
    return out


def from_bytes_le(b: np.ndarray, nbits: int = 256) -> np.ndarray:
    """(..., 32) uint8 little-endian -> (..., NLIMBS) int32 limbs.

    Keeps only the low `nbits` bits and does NOT reduce mod p (ZIP-215
    accepts y >= p). Each limb reads a 3-byte window.
    """
    b = np.ascontiguousarray(b, dtype=np.uint8)
    nbytes = b.shape[-1]
    masked = b
    if nbits < 8 * nbytes:
        masked = b.copy()
        full, rem = divmod(nbits, 8)
        if rem:
            masked[..., full] &= (1 << rem) - 1
            full += 1
        masked[..., full:] = 0
    pad = [(0, 0)] * (b.ndim - 1) + [(0, 3)]
    w = np.pad(masked, pad).astype(np.int32)
    out = np.empty(b.shape[:-1] + (NLIMBS,), np.int32)
    for i in range(NLIMBS):
        j, r = divmod(LIMB_BITS * i, 8)
        if j >= nbytes:
            out[..., i] = 0
            continue
        win = w[..., j] | (w[..., j + 1] << 8) | (w[..., j + 2] << 16)
        out[..., i] = (win >> r) & MASK
    return out


# --------------------------------------------------------------------------
# plain torch ops on (..., NLIMBS) int64 tensors
# --------------------------------------------------------------------------

_CONSTS: dict = {}


def _const(name: str, make, device) -> torch.Tensor:
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(make(), dtype=torch.int64, device=device)
        _CONSTS[key] = t
    return t


def const(v: int, device) -> torch.Tensor:
    """(NLIMBS,) limbs of v mod p on `device` (cached)."""
    return _const(f"c{v % P}", lambda: int_to_limbs(v % P), device)


def _carry_weights(device) -> torch.Tensor:
    # a carry out of limb 19 has weight 2^260 = 608 (mod p) at limb 0
    return _const("cw", lambda: [FOLD260] + [1] * (NLIMBS - 1), device)


def carry(x: torch.Tensor, passes: int = 4) -> torch.Tensor:
    """Parallel carry passes: |limb| < 2^45 in, |limb| < 2^14 out.

    Each pass moves every limb's bits above 13 one limb up (floor shift, so
    negative limbs work) and folds the top limb's carry into limb 0 times
    608. Four passes bound the result (see the module docstring)."""
    w = _carry_weights(x.device)
    for _ in range(passes):
        c = x >> LIMB_BITS
        x = (x & MASK) + torch.roll(c, 1, dims=-1) * w
    return x


def add(a, b):
    return carry(a + b, 2)


def sub(a, b):
    return carry(a - b, 2)


def mul_small(a, k: int):
    return carry(a * k, 3)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product: the (.., 20, 20) outer product is skewed into 39
    columns (pad each row to 40 and re-read the flat buffer with stride
    39), the columns >= 20 fold through 608, then `carry`."""
    a, b = torch.broadcast_tensors(a, b)
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)  # (..., 20, 20)
    lead = prod.shape[:-2]
    flat = F.pad(prod, (0, NLIMBS)).reshape(lead + (2 * NLIMBS * NLIMBS,))
    wide = flat[..., : NLIMBS * (2 * NLIMBS - 1)].reshape(
        lead + (NLIMBS, 2 * NLIMBS - 1)
    ).sum(-2)  # (..., 39)
    low = wide[..., :NLIMBS]
    high = F.pad(wide[..., NLIMBS:], (0, 1))  # 19 columns, limb 19 empty
    return carry(low + FOLD260 * high)


def square(a):
    return mul(a, a)


def sq_n(a, n: int):
    for _ in range(n):
        a = mul(a, a)
    return a


def pow_p58(z):
    """z^((p - 5) / 8) = z^(2^252 - 3), the ref10 addition chain."""
    z2 = square(z)
    z9 = mul(z, sq_n(z2, 2))
    z11 = mul(z2, z9)
    z_5_0 = mul(z9, square(z11))
    z_10_0 = mul(sq_n(z_5_0, 5), z_5_0)
    z_20_0 = mul(sq_n(z_10_0, 10), z_10_0)
    z_40_0 = mul(sq_n(z_20_0, 20), z_20_0)
    z_50_0 = mul(sq_n(z_40_0, 10), z_10_0)
    z_100_0 = mul(sq_n(z_50_0, 50), z_50_0)
    z_200_0 = mul(sq_n(z_100_0, 100), z_100_0)
    z_250_0 = mul(sq_n(z_200_0, 50), z_50_0)
    return mul(sq_n(z_250_0, 2), z)


def invert(z):
    """z^(p - 2), the ref10 inversion chain (0 maps to 0)."""
    z2 = square(z)
    z9 = mul(z, sq_n(z2, 2))
    z11 = mul(z2, z9)
    z_5_0 = mul(z9, square(z11))
    z_10_0 = mul(sq_n(z_5_0, 5), z_5_0)
    z_20_0 = mul(sq_n(z_10_0, 10), z_10_0)
    z_40_0 = mul(sq_n(z_20_0, 20), z_20_0)
    z_50_0 = mul(sq_n(z_40_0, 10), z_10_0)
    z_100_0 = mul(sq_n(z_50_0, 50), z_50_0)
    z_200_0 = mul(sq_n(z_100_0, 100), z_100_0)
    z_250_0 = mul(sq_n(z_200_0, 50), z_50_0)
    return mul(sq_n(z_250_0, 5), z11)


def _ripple(x: torch.Tensor) -> torch.Tensor:
    """Sequential signed carry; the top limb keeps the overflow."""
    cols = list(x.unbind(-1))
    for i in range(NLIMBS - 1):
        c = cols[i] >> LIMB_BITS
        cols[i] = cols[i] & MASK
        cols[i + 1] = cols[i + 1] + c
    return torch.stack(cols, dim=-1)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """The representative in [0, p), limbs in [0, 2^13). Input: |limb| <
    2^15 (any op's output), so |value| < 2^263 and 256 p lifts it above 0."""
    x = x + _const("bias", lambda: int_to_limbs(256 * P), x.device)
    for _ in range(2):
        x = _ripple(x)
        hi = x[..., -1:] >> _TOP_SHIFT  # multiples of 2^255 = 19 (mod p)
        x = torch.cat(
            [x[..., :1] + 19 * hi, x[..., 1:-1],
             x[..., -1:] - (hi << _TOP_SHIFT)], dim=-1,
        )
    x = _ripple(x)  # 0 <= value < 2 p
    t = _ripple(x - _const("p", lambda: int_to_limbs(P), x.device))
    return torch.where((t[..., -1:] < 0), x, t)


def is_zero(x):
    return (canonical(x) == 0).all(-1)


def eq(a, b):
    return is_zero(a - b)


def parity(x):
    return canonical(x)[..., 0] & 1


# --------------------------------------------------------------------------
# GF(2^256 - 2^32 - 977), the secp256k1 base field, on the same limbs
# --------------------------------------------------------------------------


class SecpField:
    """Plain torch arithmetic mod p = 2^256 - 2^32 - 977 on (..., NLIMBS)
    int64 13-bit limbs, the plain side of the ECDSA kernel, plus the host
    packing helpers of the JAX package's `FSECP` (`from_int`,
    `from_bytes_le`), so packed rows are byte for byte the JAX package's.

    Reduction folds weight 2^260 = 2^36 + 0x3D10 (mod p), which in 13-bit
    limbs is (7440, 1, 1024) at limbs 0-2. Every op returns limbs with
    |limb| < 2^14 (`carry`); `mul` accepts |limb| < 2^15, so a sum or
    difference of two results may enter it uncarried. Canonical form is
    only needed for equality and parity."""

    P = 2**256 - 2**32 - 977
    FOLD = ((0, 7440), (1, 1), (2, 1024))  # 2^260 mod p, by limb
    _TOP_SHIFT = 256 - LIMB_BITS * (NLIMBS - 1)  # 9: bit 256 in limb 19

    def from_int(self, v: int) -> np.ndarray:
        """(NLIMBS,) int32 limbs of v mod p."""
        return int_to_limbs(v % self.P).astype(np.int32)

    @staticmethod
    def from_bytes_le(b: np.ndarray, nbits: int = 256) -> np.ndarray:
        """(..., 32) uint8 little-endian -> (..., NLIMBS) int32 limbs of
        the low `nbits` bits, not reduced."""
        return from_bytes_le(b, nbits)

    def const(self, v: int, device) -> torch.Tensor:
        return _const(f"s{v % self.P}", lambda: int_to_limbs(v % self.P),
                      device)

    def _fold_vec(self, device) -> torch.Tensor:
        return _const("sfold", lambda: [7440, 1, 1024] + [0] * (NLIMBS - 3),
                      device)

    def carry(self, x: torch.Tensor, passes: int = 3) -> torch.Tensor:
        """Parallel carry passes over 20 limbs, the carry out of limb 19
        folded through 2^260: |limb| < 2^27 in, |limb| < 2^14 out."""
        fold = self._fold_vec(x.device)
        for _ in range(passes):
            c = x >> LIMB_BITS
            x = ((x & MASK) + F.pad(c[..., :-1], (1, 0))
                 + c[..., -1:] * fold)
        return x

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Columns (..., W >= 20), |col| < 2^40 -> 20 carried limbs: two
        parallel carry passes (width + 2), then the columns >= 20 folded
        through 2^260, until 20 columns are left."""
        while x.shape[-1] > NLIMBS:
            for _ in range(2):
                c = x >> LIMB_BITS
                x = F.pad(x & MASK, (0, 1)) + F.pad(c, (1, 0))
            low, high = x[..., :NLIMBS], x[..., NLIMBS:]
            nh = high.shape[-1]
            buf = F.pad(low, (0, max(NLIMBS, 2 + nh) - NLIMBS))
            for off, m in self.FOLD:
                buf = buf + F.pad(high * m, (off, buf.shape[-1] - off - nh))
            x = buf
        return self.carry(x)

    def add(self, a, b):
        return self.carry(a + b, 2)

    def sub(self, a, b):
        return self.carry(a - b, 2)

    def mul_small(self, a, k: int):
        return self.carry(a * k, 3)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Schoolbook product skewed into 39 columns (as the ed25519 `mul`),
        then `_reduce`."""
        a, b = torch.broadcast_tensors(a, b)
        prod = a.unsqueeze(-1) * b.unsqueeze(-2)  # (..., 20, 20)
        lead = prod.shape[:-2]
        flat = F.pad(prod, (0, NLIMBS)).reshape(
            lead + (2 * NLIMBS * NLIMBS,))
        wide = flat[..., : NLIMBS * (2 * NLIMBS - 1)].reshape(
            lead + (NLIMBS, 2 * NLIMBS - 1)).sum(-2)  # (..., 39)
        return self._reduce(wide)

    def square(self, a):
        return self.mul(a, a)

    def sq_n(self, a, n: int):
        for _ in range(n):
            a = self.mul(a, a)
        return a

    def pow_sqrt(self, a):
        """a^((p + 1) / 4), the chain of csrc/secp256k1_core.cuh
        `fe_pow_sqrt` (blocks of 223, 22 and 2 ones)."""
        x2 = self.mul(self.square(a), a)
        x3 = self.mul(self.square(x2), a)
        x6 = self.mul(self.sq_n(x3, 3), x3)
        x9 = self.mul(self.sq_n(x6, 3), x3)
        x11 = self.mul(self.sq_n(x9, 2), x2)
        x22 = self.mul(self.sq_n(x11, 11), x11)
        x44 = self.mul(self.sq_n(x22, 22), x22)
        x88 = self.mul(self.sq_n(x44, 44), x44)
        x176 = self.mul(self.sq_n(x88, 88), x88)
        x220 = self.mul(self.sq_n(x176, 44), x44)
        x223 = self.mul(self.sq_n(x220, 3), x3)
        t = self.mul(self.sq_n(x223, 23), x22)
        t = self.mul(self.sq_n(t, 6), x2)
        return self.sq_n(t, 2)

    def canonical(self, x: torch.Tensor) -> torch.Tensor:
        """The representative in [0, p), limbs in [0, 2^13). Input: |limb|
        < 2^15, so |value| < 2^263 and 256 p lifts it above 0; two rounds
        fold the bits >= 2^256 through 2^256 = 2^32 + 977 (limb 0 gets
        977, limb 2 gets 64), then one conditional subtraction of p."""
        dev = x.device
        x = x + _const("sbias", lambda: int_to_limbs(256 * self.P), dev)
        top = _const("stop", lambda: [977, 0, 64] + [0] * (NLIMBS - 3), dev)
        for _ in range(2):
            x = _ripple(x)
            hi = x[..., -1:] >> self._TOP_SHIFT
            x = x - F.pad(hi << self._TOP_SHIFT, (NLIMBS - 1, 0)) + hi * top
        x = _ripple(x)  # 0 <= value < 2^256 < 2 p
        t = _ripple(x - _const("sp", lambda: int_to_limbs(self.P), dev))
        return torch.where((t[..., -1:] < 0), x, t)

    def is_zero(self, x):
        return (self.canonical(x) == 0).all(-1)

    def eq(self, a, b):
        return self.is_zero(a - b)

    def parity(self, x):
        return self.canonical(x)[..., 0] & 1


FSECP = SecpField()
