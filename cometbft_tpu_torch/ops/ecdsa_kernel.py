"""Host staging for batched secp256k1 ECDSA verification, and the plain
verify core.

Counterpart of the JAX package's ops/ecdsa_kernel.py. Per signature (r, s)
over msg with compressed pubkey Q:
  host:   z = SHA256(msg); w = s^-1 mod N; u1 = z w; u2 = r w (Python ints)
  device: R = [u1]G + [u2]Q; valid iff R != inf and x(R) = r (mod N)
The x = r (mod N) check is projective: since N < p there are at most two
candidates, r and r + N, so validity is X == r Z or X == (r + N) Z (the
second only when r + N < p), with no inversion.

`pack_batch` is the JAX package's host pack, so a `PackedEcdsaBatch` is
byte-identical across the two packages; `verify_core` is the plain PyTorch
verify (the CUDA kernel of ops/ecdsa_fused.py is held against it), and
`verify_batch`, the JAX module's entry, packs a batch and launches that
kernel (`ecdsa_verify`) on the card, or its plain version for
device="cpu". The reference has no secp256k1 batch verifier
(crypto/batch/batch.go:12-21);
its single verify is btcec's with high-S rejection
(crypto/secp256k1/secp256k1.go:192-220), whose semantics the precheck and
the device pass reproduce.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from cometbft_tpu_torch.crypto import secp256k1_ref as ref
from cometbft_tpu_torch.ops import secp256k1 as curve
from cometbft_tpu_torch.ops.ed25519_kernel import bucket_size, nibbles
from cometbft_tpu_torch.ops.field import FSECP

F = FSECP


class PackedEcdsaBatch(NamedTuple):
    n: int
    padded: int
    qx: np.ndarray        # (B, NLIMBS) pubkey x
    qparity: np.ndarray   # (B,) prefix low bit
    u1dig: np.ndarray     # (B, 64) base-16 digits of u1
    u2dig: np.ndarray     # (B, 64)
    xr1: np.ndarray       # (B, NLIMBS) candidate x = r
    xr2: np.ndarray       # (B, NLIMBS) candidate x = r + N (or r again)
    precheck: np.ndarray  # (B,) host-side validity screen


def pack_batch(
    pubkeys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    pad_to: Optional[int] = None,
) -> PackedEcdsaBatch:
    """Stage (pubkey33, msg, sig64) triples into device-ready arrays.

    Malformed rows (bad lengths or prefix, x >= p, r or s out of range,
    high S) get precheck=False and zeroed payloads."""
    n = len(pubkeys)
    assert len(msgs) == n and len(sigs) == n
    padded = pad_to if pad_to is not None else bucket_size(max(n, 1))
    assert padded >= n

    x_raw = np.zeros((padded, 32), np.uint8)
    parity = np.zeros((padded,), np.int32)
    u1b = np.zeros((padded, 32), np.uint8)
    u2b = np.zeros((padded, 32), np.uint8)
    xr1 = np.zeros((padded, 32), np.uint8)
    xr2 = np.zeros((padded, 32), np.uint8)
    precheck = np.zeros((padded,), np.bool_)

    from_b, to_b = int.from_bytes, int.to_bytes
    N_, P_, HALF = ref.N, ref.P, ref.HALF_N
    sha256 = hashlib.sha256
    # row screen, then the modular work over the rows that pass
    ok_idx, xs, rs, ss, zs = [], [], [], [], []
    for i, (pk, msg, sig) in enumerate(zip(pubkeys, msgs, sigs)):
        if len(pk) != 33 or pk[0] not in (2, 3) or len(sig) != 64:
            continue
        x = from_b(pk[1:], "big")
        r = from_b(sig[:32], "big")
        s = from_b(sig[32:], "big")
        if x >= P_ or not (1 <= r < N_ and 1 <= s <= HALF):
            continue
        ok_idx.append(i)
        xs.append(x)
        rs.append(r)
        ss.append(s)
        zs.append(from_b(sha256(msg).digest(), "big"))
        parity[i] = pk[0] & 1
        precheck[i] = True
    if ok_idx:
        # batched modular inverse (Montgomery's trick): one pow and 3 m
        # multiplications instead of m pows
        m = len(ok_idx)
        pref = [1] * (m + 1)
        for j in range(m):
            pref[j + 1] = pref[j] * ss[j] % N_
        inv_all = pow(pref[m], N_ - 2, N_)
        ws = [0] * m
        for j in range(m - 1, -1, -1):
            ws[j] = pref[j] * inv_all % N_
            inv_all = inv_all * ss[j] % N_
        xb, u1l, u2l, r1l, r2l = [], [], [], [], []
        for j in range(m):
            w = ws[j]
            r = rs[j]
            xb.append(to_b(xs[j], 32, "little"))
            u1l.append(to_b(zs[j] * w % N_, 32, "little"))
            u2l.append(to_b(r * w % N_, 32, "little"))
            r1l.append(to_b(r, 32, "little"))
            r2l.append(to_b(r + N_ if r + N_ < P_ else r, 32, "little"))
        rows = np.asarray(ok_idx)
        x_raw[rows] = np.frombuffer(b"".join(xb), np.uint8).reshape(m, 32)
        u1b[rows] = np.frombuffer(b"".join(u1l), np.uint8).reshape(m, 32)
        u2b[rows] = np.frombuffer(b"".join(u2l), np.uint8).reshape(m, 32)
        xr1[rows] = np.frombuffer(b"".join(r1l), np.uint8).reshape(m, 32)
        xr2[rows] = np.frombuffer(b"".join(r2l), np.uint8).reshape(m, 32)

    return PackedEcdsaBatch(
        n, padded,
        F.from_bytes_le(x_raw), parity,
        nibbles(u1b), nibbles(u2b),
        F.from_bytes_le(xr1), F.from_bytes_le(xr2),
        precheck,
    )


def verify_core(qx, qparity, u1dig, u2dig, xr1, xr2, precheck, table):
    """(B,)-batched ECDSA check on torch tensors (the fields of a
    PackedEcdsaBatch) and the (32, 256, 3, NLIMBS) comb table of G
    (`secp256k1.base_table8_np`). Returns (B,) bool validity."""
    qx, xr1, xr2 = (t.to(torch.int64) for t in (qx, xr1, xr2))
    u1dig = u1dig.to(torch.int64)
    u1 = u1dig[:, 0::2] + 16 * u1dig[:, 1::2]  # byte digits of u1
    Q, ok_q = curve.decompress(qx, qparity.to(torch.int64))
    X, _, Z = curve.add(curve.base_scalar_mul(u1, table),
                        curve.scalar_mul_windowed(u2dig.to(torch.int64), Q))
    not_inf = ~F.is_zero(Z)
    match = F.eq(X, F.mul(xr1, Z)) | F.eq(X, F.mul(xr2, Z))
    return ok_q & not_inf & match & (precheck != 0)


def verify_batch(pubkeys, msgs, sigs, device=None) -> np.ndarray:
    """Verify a batch of (pubkey33, msg, sig64) triples; (n,) bool numpy
    validity. `pack_batch` pads the rows to their bucket, then one
    `ecdsa_verify` launch on `device` (None: the card, which raises
    DeviceError without one; "cpu": the plain version)."""
    from cometbft_tpu_torch.ops import ecdsa_fused

    return ecdsa_fused.verify_batch(pubkeys, msgs, sigs, device=device)
