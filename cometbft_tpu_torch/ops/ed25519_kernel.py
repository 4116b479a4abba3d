"""Host staging for batched ed25519 verification, the plain voting-power
tally, and the mesh's reduce (`carry_quorum`, csrc/tally_quorum.cu
`cbt_carry_quorum`, with its plain version `carry_quorum_plain`).

Counterpart of the JAX package's ops/ed25519_kernel.py. The host side
(SHA-512 challenge h = H(R||A||M) mod L, digit splits, the S < L
precheck, 13-bit limbs) runs in one call of the native host packer
(native.ed25519_pack), as the reference's does; the numpy + hashlib
pipeline stays as its plain version (`native=False`) and screens rows of
bad lengths. A `PackedBatch` is byte-identical across the two packages and
the two routes. The curve work runs in ops/ed25519_fused.py, and the
JAX module's entries over it are here: `verify_batch`, `verify_kernel`
and `verify_tally_kernel` launch the CUDA `ed25519_verify` (and
`tally_quorum`) on the card, or run their plain versions for
device="cpu".

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

from cometbft_tpu_torch import native as _native
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


def scalar_digits(v: int) -> np.ndarray:
    """256-bit int -> 64 base-16 digits, little-endian."""
    return nibbles(np.frombuffer(int.to_bytes(v, 32, "little"), np.uint8))


def nibbles(b: np.ndarray) -> np.ndarray:
    """(..., 32) uint8 -> (..., 64) int32 base-16 digits, little-endian.

    Batched scalar_digits: one numpy pass for the whole batch."""
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
    """(B,) int64 voting powers -> (B, POWER_LIMBS) int32 13-bit limbs.

    Raises ValueError on a negative power: a power in [0, 2^63) has five
    limbs in [0, 2^13), the tally kernels' precondition."""
    p = np.asarray(powers, dtype=np.int64)
    if p.size and int(p.min()) < 0:
        raise ValueError("voting powers must be non-negative")
    out = np.empty(p.shape + (POWER_LIMBS,), dtype=np.int32)
    for i in range(POWER_LIMBS):
        out[..., i] = (p >> (POWER_LIMB_BITS * i)) & POWER_MASK
    return out


def check_power_limbs(power5) -> np.ndarray:
    """power5 as a (B, POWER_LIMBS) int32 array, after checking the tally
    kernels' precondition: every limb in [0, 2^13). The kernels do not
    check it; a larger limb would spill into its neighbour in the packed
    rows and could overflow the int32 limb sums."""
    p = np.asarray(power5)
    if p.ndim != 2 or p.shape[1] != POWER_LIMBS:
        raise ValueError(f"power limbs have shape {p.shape}")
    if p.size and (int(p.min()) < 0 or int(p.max()) > POWER_MASK):
        raise ValueError("a power limb is outside [0, 2^13)")
    return p.astype(np.int32)


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
    native: bool = True,
) -> PackedBatch:
    """Stage (pubkey, msg, sig) triples into device-ready arrays.

    Malformed rows (bad lengths, S >= L) get precheck=False and zeroed
    payloads: they verify invalid without poisoning the batch. The batch is
    padded to `pad_to` (default: its bucket), padding rows precheck=False.
    When every row has a 32-byte key and a 64-byte signature, one native
    call packs the batch; `native=False` runs the numpy plain version.
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
        pub_cat, sig_cat_b = b"".join(pubkeys), b"".join(sigs)
        if native:
            return PackedBatch(n, padded, *_native.ed25519_pack(
                pub_cat, sig_cat_b, msgs, padded))
        # one join + frombuffer per array
        a_raw[:n] = np.frombuffer(pub_cat, np.uint8).reshape(n, 32)
        sig_cat = np.frombuffer(sig_cat_b, np.uint8).reshape(n, 64)
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


# --------------------------------------------------------------------------
# carry_quorum: the cross-slot reduce of a sharded step (parallel/mesh.py)
# --------------------------------------------------------------------------


def carry_quorum_plain(partials, threshold):
    """Plain PyTorch version of the reduce kernel: (n_dev, C, TALLY_LIMBS)
    partial tallies + (C, TALLY_LIMBS) thresholds -> ((C, TALLY_LIMBS)
    int32 canonical tally, (C,) bool quorum): the sum over slots (the JAX
    package's psum), the limb re-carry (its `mesh._carry_tally`) and
    `quorum_core`."""
    t = partials.to(torch.int64).sum(0)
    cols = list(t.unbind(-1))
    for i in range(TALLY_LIMBS - 1):
        c = cols[i] >> POWER_LIMB_BITS
        cols[i] = cols[i] - (c << POWER_LIMB_BITS)
        cols[i + 1] = cols[i + 1] + c
    tally = torch.stack(cols, -1).to(torch.int32)
    return tally, quorum_core(tally, threshold.to(torch.int32))


def carry_quorum(partials: torch.Tensor, threshold: torch.Tensor):
    """Sum of a mesh's (n_dev, C, TALLY_LIMBS) int32 partial tallies,
    re-carried to canonical limbs, and the quorum bit (tally >
    threshold) against the (C, TALLY_LIMBS) int32 thresholds -> ((C, 6)
    int32 tally, (C,) bool quorum). CUDA tensors launch
    csrc/tally_quorum.cu `cbt_carry_quorum` on the current stream; CPU
    tensors run `carry_quorum_plain`.

    Precondition, not checked here: the partials are canonical tallies of
    the tally kernels, so every limb sum stays far below 2^31. The kernel's
    int32 sums wrap as the JAX psum's do, the plain version's int64 sums
    do not."""
    if partials.dtype != torch.int32 or partials.dim() != 3 \
            or partials.shape[2] != TALLY_LIMBS \
            or not partials.is_contiguous():
        raise ValueError(f"partials must be contiguous (n_dev, C, "
                         f"{TALLY_LIMBS}) int32, got {partials.dtype} "
                         f"{tuple(partials.shape)}")
    n_dev, C = partials.shape[0], partials.shape[1]
    if threshold.dtype != torch.int32 \
            or tuple(threshold.shape) != (C, TALLY_LIMBS) \
            or not threshold.is_contiguous():
        raise ValueError(f"threshold must be contiguous ({C}, "
                         f"{TALLY_LIMBS}) int32, got {threshold.dtype} "
                         f"{tuple(threshold.shape)}")
    if n_dev < 1:
        raise ValueError("no partial tally to reduce")
    dev = partials.device
    if dev.type == "cpu" and threshold.device == dev:
        return carry_quorum_plain(partials, threshold)
    if dev.type != "cuda" or threshold.device != dev:
        raise ValueError(f"no carry_quorum kernel for partials on {dev} and "
                         f"thresholds on {threshold.device}")
    from cometbft_tpu_torch.ops import _build

    fn = _build.kernel_lib("tally_quorum.cu").cbt_carry_quorum
    tally = torch.empty((C, TALLY_LIMBS), dtype=torch.int32, device=dev)
    quorum = torch.empty((C,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(partials.data_ptr(), n_dev, C, threshold.data_ptr(),
                 tally.data_ptr(), quorum.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"carry_quorum launch failed: cudaError {err}")
    carry_quorum.launches += 1
    return tally, quorum


carry_quorum.launches = 0


# --------------------------------------------------------------------------
# entry points (the JAX module's, over ops/ed25519_fused.py's kernels)
# --------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _packed(ay, asign, ry, rsign, sdig, hdig, precheck) -> PackedBatch:
    f = [_host(x) for x in (ay, asign, ry, rsign, sdig, hdig, precheck)]
    B = f[0].shape[0]
    return PackedBatch(B, B, *f)


def verify_kernel(ay, asign, ry, rsign, sdig, hdig, precheck, device=None):
    """Verification only (no tally), the plain BatchVerifier.Verify path:
    a PackedBatch's fields (numpy arrays or tensors) -> (B,) bool tensor
    on `device`. One `ed25519_verify` launch on the card (None, which
    raises DeviceError without one), its plain version for "cpu"."""
    from cometbft_tpu_torch.ops import ed25519_fused as kf

    pb = _packed(ay, asign, ry, rsign, sdig, hdig, precheck)
    return kf.verify_rows(kf.pack_rows(pb), device)


def verify_tally_kernel(ay, asign, ry, rsign, sdig, hdig, precheck, power5,
                        counted, commit_ids, threshold, n_commits: int,
                        device=None):
    """Batched ZIP-215 verify + per-commit quorum tally over a
    PackedBatch's fields, (B, 5) power limbs, (B,) counted flags and
    commit ids, and (n_commits, TALLY_LIMBS) thresholds -> (valid (B,)
    bool, tally (n_commits, TALLY_LIMBS) int32, quorum (n_commits,) bool)
    tensors on `device`: one upload, `ed25519_verify` then `tally_quorum`
    on the card, their plain versions for "cpu"."""
    from cometbft_tpu_torch.ops import ed25519_fused as kf

    pb = _packed(ay, asign, ry, rsign, sdig, hdig, precheck)
    rows = kf.pack_rows(pb, _host(power5), _host(counted),
                        _host(commit_ids), _host(threshold))
    return kf.verify_tally_rows(rows, n_commits, device)


def verify_batch(pubkeys, msgs, sigs, device=None) -> np.ndarray:
    """Verify a batch; (n,) bool numpy validity (the per-signature valid
    slice of crypto/ed25519/ed25519.go:236 Verify(), which the blame path
    of types/validation.go:243 needs). `pack_batch` pads the rows to
    their bucket, then one `ed25519_verify` launch on `device`."""
    from cometbft_tpu_torch.ops import ed25519_fused

    return ed25519_fused.verify_batch(pubkeys, msgs, sigs, device=device)
