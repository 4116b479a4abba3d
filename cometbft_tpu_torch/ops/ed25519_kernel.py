"""Host staging for batched ed25519 verification, and the plain voting-power
tally.

Counterpart of the JAX package's ops/ed25519_kernel.py. The host side
(SHA-512 challenge h = H(R||A||M) mod L, digit splits, the S < L
precheck, 13-bit limbs) is the same numpy + hashlib pipeline, so a
`PackedBatch` is byte-identical across the two packages. The curve work
runs in ops/ed25519_fused.py.

Voting powers ride as 5 x 13-bit limbs so the tally stays int32 on the
device: power < 2^63 and MaxTotalVotingPower = MaxInt64/8
(types/validator_set.go:25) keep every per-limb partial sum below 2^30 for
batches up to 2^17 signatures.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.ops.field import from_bytes_le

POWER_LIMBS = 5
POWER_LIMB_BITS = 13
POWER_MASK = (1 << POWER_LIMB_BITS) - 1
# tally needs ceil(64/13) + headroom for carries
TALLY_LIMBS = 6

BUCKETS = (64, 256, 1024, 4096, 16384, 32768, 65536)


def bucket_size(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds max bucket {BUCKETS[-1]}")


# --------------------------------------------------------------------------
# Host-side packing
# --------------------------------------------------------------------------


def nibbles(b: np.ndarray) -> np.ndarray:
    """(..., 32) uint8 -> (..., 64) int32 base-16 digits, little-endian."""
    lo = (b & 0xF).astype(np.int32)
    hi = (b >> 4).astype(np.int32)
    return np.stack([lo, hi], axis=-1).reshape(b.shape[:-1] + (64,))


_L_WORDS = np.frombuffer(int.to_bytes(ref.L, 32, "little"), np.uint8).view(
    "<u8"
)


def below_words(b: np.ndarray, mod_words: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 LE -> (B,) bool value < modulus, vectorized as a
    lexicographic compare over four little-endian uint64 words."""
    w = np.ascontiguousarray(b).view("<u8")  # (B, 4)
    lt = np.zeros(b.shape[0], np.bool_)
    decided = np.zeros(b.shape[0], np.bool_)
    for i in range(3, -1, -1):
        mw = mod_words[i]
        lt |= ~decided & (w[:, i] < mw)
        decided |= w[:, i] != mw
    return lt


def s_below_l(s_bytes: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 LE -> (B,) bool S < L, the malleability precheck of
    crypto/ed25519/ed25519.go:189."""
    return below_words(s_bytes, _L_WORDS)


def power_limbs(powers: np.ndarray) -> np.ndarray:
    """(B,) int64 voting powers -> (B, POWER_LIMBS) int32 13-bit limbs."""
    p = np.asarray(powers, dtype=np.int64)
    out = np.empty(p.shape + (POWER_LIMBS,), dtype=np.int32)
    for i in range(POWER_LIMBS):
        out[..., i] = (p >> (POWER_LIMB_BITS * i)) & POWER_MASK
    return out


def threshold_limbs(v: int, n_commits: int = 1) -> np.ndarray:
    """Quorum threshold int -> (n_commits, TALLY_LIMBS) int32 limbs."""
    out = np.zeros((n_commits, TALLY_LIMBS), np.int32)
    for i in range(TALLY_LIMBS):
        out[:, i] = (v >> (POWER_LIMB_BITS * i)) & POWER_MASK
    return out


def tally_to_int(t):
    """(.., TALLY_LIMBS) int limbs -> Python int / object array."""
    t = np.asarray(t).astype(object)
    out = 0
    for i in range(t.shape[-1]):
        out = out + (t[..., i] << (POWER_LIMB_BITS * i))
    return out


class PackedBatch(NamedTuple):
    """Device-ready arrays for one verification batch (padded to a bucket)."""

    n: int
    padded: int
    ay: np.ndarray
    asign: np.ndarray
    ry: np.ndarray
    rsign: np.ndarray
    sdig: np.ndarray
    hdig: np.ndarray
    precheck: np.ndarray


def pack_batch(
    pubkeys: Sequence[bytes],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    pad_to: Optional[int] = None,
) -> PackedBatch:
    """Stage (pubkey, msg, sig) triples into device-ready arrays.

    Malformed rows (bad lengths, S >= L) get precheck=False and zeroed
    payloads: they verify invalid without poisoning the batch. The batch is
    padded to `pad_to` (default: its bucket), padding rows precheck=False.
    """
    n = len(pubkeys)
    assert len(msgs) == n and len(sigs) == n
    padded = pad_to if pad_to is not None else bucket_size(max(n, 1))
    assert padded >= n

    lenok = [len(p) == 32 and len(s) == 64 for p, s in zip(pubkeys, sigs)]
    a_raw = np.zeros((padded, 32), np.uint8)
    r_raw = np.zeros((padded, 32), np.uint8)
    s_raw = np.zeros((padded, 32), np.uint8)
    sha512 = hashlib.sha512
    if all(lenok):
        # one join + frombuffer per array
        a_raw[:n] = np.frombuffer(b"".join(pubkeys), np.uint8).reshape(n, 32)
        sig_cat = np.frombuffer(b"".join(sigs), np.uint8).reshape(n, 64)
        r_raw[:n] = sig_cat[:, :32]
        s_raw[:n] = sig_cat[:, 32:]
        digests = [
            sha512(sig[:32] + pk + msg).digest()
            for pk, msg, sig in zip(pubkeys, msgs, sigs)
        ]
        lenok_np = np.ones(n, np.bool_)
    else:
        digests = [b"\x00" * 64] * n
        for i, (pk, msg, sig) in enumerate(zip(pubkeys, msgs, sigs)):
            if not lenok[i]:
                continue
            a_raw[i] = np.frombuffer(pk, np.uint8)
            r_raw[i] = np.frombuffer(sig[:32], np.uint8)
            s_raw[i] = np.frombuffer(sig[32:], np.uint8)
            digests[i] = sha512(sig[:32] + pk + msg).digest()
        lenok_np = np.asarray(lenok, np.bool_)

    # h = digest mod L: a C bigint per row, one vectorized nibble split
    h_bytes = np.zeros((padded, 32), np.uint8)
    if n:
        from_b, to_b = int.from_bytes, int.to_bytes
        h_bytes[:n] = np.frombuffer(
            b"".join(
                to_b(from_b(d, "little") % ref.L, 32, "little")
                for d in digests
            ),
            np.uint8,
        ).reshape(n, 32)

    precheck = np.zeros((padded,), np.bool_)
    precheck[:n] = lenok_np & s_below_l(s_raw[:n])
    sdig = nibbles(s_raw)
    hdig = nibbles(h_bytes)
    asign = (a_raw[:, 31] >> 7).astype(np.int32)
    rsign = (r_raw[:, 31] >> 7).astype(np.int32)
    ay = from_bytes_le(a_raw, nbits=255)
    ry = from_bytes_le(r_raw, nbits=255)
    return PackedBatch(n, padded, ay, asign, ry, rsign, sdig, hdig, precheck)


# --------------------------------------------------------------------------
# Plain tally and quorum (the CUDA tally_quorum kernel is held against these)
# --------------------------------------------------------------------------


def tally_core(valid, power5, counted, commit_ids, n_commits: int):
    """Per-commit sum of power over valid, counted signatures, in canonical
    13-bit limbs: (B,) bool, (B, 5) int, (B,) bool, (B,) int ->
    (n_commits, TALLY_LIMBS) int32. Integer sums, so the result is exact
    in any order (types/validation.go:217-231, all signatures counted)."""
    mask = (valid & counted).to(torch.int64)
    contrib = power5.to(torch.int64) * mask[:, None]  # (B, 5)
    onehot = (commit_ids.to(torch.int64)[:, None]
              == torch.arange(n_commits, device=contrib.device)[None, :])
    t = (onehot.to(torch.int64)[:, :, None] * contrib[:, None, :]).sum(0)
    t = torch.nn.functional.pad(t, (0, TALLY_LIMBS - POWER_LIMBS))
    cols = list(t.unbind(-1))
    for i in range(TALLY_LIMBS - 1):
        c = cols[i] >> POWER_LIMB_BITS
        cols[i] = cols[i] - (c << POWER_LIMB_BITS)
        cols[i + 1] = cols[i + 1] + c
    return torch.stack(cols, -1).to(torch.int32)


def quorum_core(tally, threshold):
    """tally > threshold on canonical multi-limb numbers, top limb down."""
    gt = torch.zeros(tally.shape[:-1], dtype=torch.bool, device=tally.device)
    eq = torch.ones_like(gt)
    for i in range(TALLY_LIMBS - 1, -1, -1):
        gt = gt | (eq & (tally[..., i] > threshold[..., i]))
        eq = eq & (tally[..., i] == threshold[..., i])
    return gt
