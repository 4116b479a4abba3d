"""Fused batched ed25519 ZIP-215 verification and voting-power tally over
one packed int32 array, on the hand-written Hopper kernels.

Counterpart of the JAX package's ops/ed25519_pallas.py. The packed-row ABI
(`C_*`, `pack_rows`) is byte for byte the JAX package's, so one host
array feeds both. Two kernels run the step:

  ed25519_verify  csrc/ed25519_verify.cu, one verdict per column;
  tally_quorum    csrc/tally_quorum.cu, per-commit power tally + quorum.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain PyTorch version beside it (`*_plain`) for CPU tensors; nothing falls
back silently. `launches` on each wrapper counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.crypto import batch as cbatch
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.device import resolve
from cometbft_tpu_torch.ops import curve25519 as curve
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import field as fe
from cometbft_tpu_torch.ops.field import NLIMBS

B_TILE = 128

# Compact packed-row layout (the JAX package's ABI). Limbs are packed two
# per word, scalar digits byte/nibble-packed, flags bit-packed.
C_AY = 0        # 10 rows: pubkey y limb pairs, word = l[i] | l[i+10] << 13
C_RY = 10       # 10 rows: sig R y limb pairs
C_S8 = 20       # 8 rows: byte digits of s (comb), digit d at row d%8
C_H4 = 28       # 8 rows: nibble digits of h, digit d at row d%8
C_FLAGS = 36    # asign | rsign<<1 | precheck<<2 | counted<<3
C_KROWS = 37    # rows the verify kernel reads
C_POW = 37      # 3 rows: p0|p1<<13, p2|p3<<13, p4
C_CID = 40      # commit id per signature row
C_THRESH = 41   # flattened (n_commits, TALLY_LIMBS) thresholds
_M13 = (1 << 13) - 1


# --------------------------------------------------------------------------
# host packing
# --------------------------------------------------------------------------


def pack_rows(pb, power5=None, counted=None, commit_ids=None,
              thresh=None) -> np.ndarray:
    """Pack a PackedBatch (+ optional tally metadata) into one compact
    (R, B) int32 array: 41 rows of 4 B per signature, then the threshold
    rows. One host-to-device copy per batch."""
    B = pb.ay.shape[0]
    if thresh is None:
        thresh = np.zeros((1, ek.TALLY_LIMBS), np.int32)
    tvals = np.asarray(thresh, np.int32).reshape(-1)
    t_rows = max(1, -(-tvals.size // B))
    rows = np.zeros((C_THRESH + t_rows, B), np.int32)
    ay = np.asarray(pb.ay, np.int32)
    ry = np.asarray(pb.ry, np.int32)
    rows[C_AY:C_AY + 10] = (ay[:, :10] | (ay[:, 10:] << 13)).T
    rows[C_RY:C_RY + 10] = (ry[:, :10] | (ry[:, 10:] << 13)).T
    s8 = (pb.sdig[:, 0::2] + 16 * pb.sdig[:, 1::2]).astype(np.int32)
    acc = np.zeros((B, 8), np.int32)
    for k in range(4):
        acc |= s8[:, 8 * k:8 * k + 8] << (8 * k)
    rows[C_S8:C_S8 + 8] = acc.T
    acc = np.zeros((B, 8), np.int32)
    h4 = np.asarray(pb.hdig, np.int32)
    for k in range(8):
        acc |= h4[:, 8 * k:8 * k + 8] << (4 * k)
    rows[C_H4:C_H4 + 8] = acc.T
    flags = (pb.asign.astype(np.int32)
             | (pb.rsign.astype(np.int32) << 1)
             | (pb.precheck.astype(np.int32) << 2))
    if counted is not None:
        flags = flags | (np.asarray(counted, np.int32) << 3)
    rows[C_FLAGS] = flags
    if power5 is not None:
        p = ek.check_power_limbs(power5)
        rows[C_POW] = p[:, 0] | (p[:, 1] << 13)
        rows[C_POW + 1] = p[:, 2] | (p[:, 3] << 13)
        rows[C_POW + 2] = p[:, 4]
    if commit_ids is not None:
        rows[C_CID] = np.asarray(commit_ids, np.int32)
    flat = rows[C_THRESH:].reshape(-1)
    flat[: tvals.size] = tvals
    return rows


def pack_rows_torch(B: int, device, pb=None, power5=None, counted=None,
                    commit_ids=None, t_rows: int = 1) -> torch.Tensor:
    """`pack_rows` on tensors, built on `device`: the (C_THRESH + t_rows, B)
    int32 rows of `pb` (a tuple of the PackedBatch arrays ay, asign, ry,
    rsign, sdig, hdig, precheck as tensors; None leaves the curve rows and
    their flags zero) and the tally columns, with zero threshold rows. The
    sharded steps (parallel/mesh.py) pack each slot's slice with it on the
    slot's device. Power limbs are not checked (`pack_rows` checks them on
    the host)."""
    i32 = torch.int32
    rows = torch.zeros((C_THRESH + t_rows, B), dtype=i32, device=device)
    flags = torch.zeros((B,), dtype=i32, device=device)
    if pb is not None:
        ay, asign, ry, rsign, sdig, hdig, precheck = (
            x.to(device=device, dtype=i32) for x in pb)
        rows[C_AY:C_AY + 10] = (ay[:, :10] | (ay[:, 10:] << 13)).T
        rows[C_RY:C_RY + 10] = (ry[:, :10] | (ry[:, 10:] << 13)).T
        s8 = sdig[:, 0::2] + 16 * sdig[:, 1::2]
        acc = torch.zeros((B, 8), dtype=i32, device=device)
        for k in range(4):
            acc |= s8[:, 8 * k:8 * k + 8] << (8 * k)
        rows[C_S8:C_S8 + 8] = acc.T
        acc = torch.zeros((B, 8), dtype=i32, device=device)
        for k in range(8):
            acc |= hdig[:, 8 * k:8 * k + 8] << (4 * k)
        rows[C_H4:C_H4 + 8] = acc.T
        flags |= asign | (rsign << 1) | (precheck << 2)
    if counted is not None:
        flags |= counted.to(device=device, dtype=i32) << 3
    rows[C_FLAGS] = flags
    if power5 is not None:
        p = power5.to(device=device, dtype=i32)
        rows[C_POW] = p[:, 0] | (p[:, 1] << 13)
        rows[C_POW + 1] = p[:, 2] | (p[:, 3] << 13)
        rows[C_POW + 2] = p[:, 4]
    if commit_ids is not None:
        rows[C_CID] = commit_ids.to(device=device, dtype=i32)
    return rows


def pad_to_tile(n: int) -> int:
    """Bucket size for the packed path: >= B_TILE and a multiple of it."""
    return max(ek.bucket_size(max(n, 1)), B_TILE)


# --------------------------------------------------------------------------
# base comb tables
# --------------------------------------------------------------------------

# radix-2^25.5 limb boundaries of the kernel's field elements
_E = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230, 255)


def _limbs25(v: int):
    return [(v >> _E[i]) & ((1 << (_E[i + 1] - _E[i])) - 1)
            for i in range(10)]


def niels_from_points13(points) -> np.ndarray:
    """(N, 4, NLIMBS) extended points with Z = 1 in 13-bit limbs (any int
    dtype) -> (N, 3, 10) int32 affine niels entries (y+x, y-x, 2dxy) in the
    kernel's canonical radix-2^25.5 limbs."""
    pts = np.asarray(points).astype(np.int64)
    if pts.ndim != 3 or pts.shape[1:] != (4, NLIMBS):
        raise ValueError(f"points have shape {pts.shape}")
    xs = fe.limbs_to_int(pts[:, 0])
    ys = fe.limbs_to_int(pts[:, 1])
    zs = fe.limbs_to_int(pts[:, 2])
    p = ref.P
    out = np.empty((pts.shape[0], 3, 10), np.int32)
    for i, (x, y, z) in enumerate(zip(xs, ys, zs)):
        if int(z) % p != 1:
            raise ValueError(f"entry {i} is not normalized to Z = 1")
        x, y = int(x) % p, int(y) % p
        out[i, 0] = _limbs25((y + x) % p)
        out[i, 1] = _limbs25((y - x) % p)
        out[i, 2] = _limbs25(2 * ref.D * x * y % p)
    return out


_TABLES: dict = {}


def niels_table_np() -> np.ndarray:
    """(8192, 3, 10) int32 kernel comb table, [d * 256^w]B at w * 256 + d,
    built from the port's own curve25519.base_table8_np."""
    t = _TABLES.get("niels_np")
    if t is None:
        t = niels_from_points13(curve.base_table8_np().reshape(32 * 256, 4,
                                                               NLIMBS))
        _TABLES["niels_np"] = t
    return t


def base_table(device) -> torch.Tensor:
    """The kernel's comb table, resident on `device` (uploaded once)."""
    key = ("niels", str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(niels_table_np()).to(device)
        _TABLES[key] = t
    return t


def base_points(device) -> torch.Tensor:
    """(32, 256, 4, NLIMBS) int64 comb table of the plain version."""
    key = ("points", str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(curve.base_table8_np().astype(np.int64)).to(
            device)
        _TABLES[key] = t
    return t


# --------------------------------------------------------------------------
# ed25519_verify: kernel wrapper and plain version
# --------------------------------------------------------------------------


# Field multiplications and squarings of one column that runs to its end in
# csrc/ed25519_core.cuh `verify_column` (two decompressions of 8M + 4S and
# a 251S + 11M power chain each, 15 table conversions and 14 adds, 63 x
# (13M + 16S) of doublings, 64 + 1 cached adds of 8M, 32 niels adds of 7M,
# 1M + 9M + 12S for -R and the cofactor). A decompression that takes the
# sqrt(-1) branch adds one multiplication. Each multiplication is 100 limb
# products, each squaring 55.
VERIFY_FE_MULS = 1738
VERIFY_FE_SQUARES = 1530


def verify_products_per_signature() -> int:
    """32 x 32 -> 64 bit limb products of one verified signature."""
    return VERIFY_FE_MULS * 100 + VERIFY_FE_SQUARES * 55


def _check_rows(rows: torch.Tensor, min_rows: int) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise ValueError(f"rows must be 2-D int32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if rows.shape[0] < min_rows:
        raise ValueError(f"rows has {rows.shape[0]} rows, needs {min_rows}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def ed25519_verify_plain(rows: torch.Tensor, points: torch.Tensor):
    """Plain PyTorch version of the verify kernel: (>= C_KROWS, B) int32
    rows + the (32, 256, 4, NLIMBS) comb table -> (B,) int32 verdicts."""
    r = rows[:C_KROWS].to(torch.int64)

    def limbs(row0):
        w = r[row0:row0 + 10]
        return torch.cat([w & _M13, (w >> 13) & _M13]).T.contiguous()

    # unpacking masks after the (arithmetic) shift: the top digit of a
    # word sets its sign bit
    s8 = torch.cat([(r[C_S8:C_S8 + 8] >> (8 * k)) & 255
                    for k in range(4)]).T.contiguous()  # (B, 32)
    h4 = torch.cat([(r[C_H4:C_H4 + 8] >> (4 * k)) & 15
                    for k in range(8)]).T.contiguous()  # (B, 64)
    flags = r[C_FLAGS]
    A, ok_a = curve.decompress(limbs(C_AY), flags & 1)
    R, ok_r = curve.decompress(limbs(C_RY), (flags >> 1) & 1)
    h_neg_a = curve.scalar_mul_windowed(h4, curve.neg(A))
    sB = curve.base_scalar_mul(s8, points)
    W = curve.add(curve.add(sB, h_neg_a), curve.neg(R))
    W8 = curve.double(curve.double(curve.double(W)))
    valid = curve.is_identity(W8) & ok_a & ok_r & (((flags >> 2) & 1) != 0)
    return valid.to(torch.int32)


def ed25519_verify(rows: torch.Tensor) -> torch.Tensor:
    """(>= C_KROWS, B) int32 packed rows -> (B,) int32 verdicts (1 valid).

    CUDA tensors launch csrc/ed25519_verify.cu with the niels comb table
    (`base_table`); CPU tensors run `ed25519_verify_plain` with the plain
    table (`base_points`)."""
    _check_rows(rows, C_KROWS)
    dev = rows.device
    if dev.type == "cpu":
        return ed25519_verify_plain(rows, base_points(dev))
    if dev.type != "cuda":
        raise ValueError(f"no ed25519_verify kernel for device {dev}")
    from cometbft_tpu_torch.ops import _build

    fn = _build.kernel_lib("ed25519_verify.cu").cbt_ed25519_verify
    table = base_table(dev)
    B = rows.shape[1]
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rows.data_ptr(), B, table.data_ptr(), out.data_ptr(),
                 stream)
    _raise_on(err, "ed25519_verify")
    ed25519_verify.launches += 1
    return out


ed25519_verify.launches = 0


# --------------------------------------------------------------------------
# tally_quorum: kernel wrapper and plain version
# --------------------------------------------------------------------------


def tally_inputs(rows: torch.Tensor, n_commits: int):
    """Unpack the tally's inputs from packed rows: (B, 5) int64 power limbs,
    (B,) counted, (B,) commit ids, (n_commits, 6) int32 thresholds."""
    r = rows.to(torch.int64)
    pw = r[C_POW:C_POW + 3]
    power5 = torch.stack([pw[0] & _M13, pw[0] >> 13, pw[1] & _M13,
                          pw[1] >> 13, pw[2]], dim=1)  # (B, 5)
    counted = ((r[C_FLAGS] >> 3) & 1) != 0
    thresh = rows[C_THRESH:].reshape(-1)[
        : n_commits * ek.TALLY_LIMBS].reshape(n_commits, ek.TALLY_LIMBS)
    return power5, counted, r[C_CID], thresh


def tally_quorum_plain(valid: torch.Tensor, rows: torch.Tensor,
                       n_commits: int):
    """Plain PyTorch version of the tally kernel: (B,) verdicts + packed
    rows -> ((n_commits, 6) int32 tally, (n_commits,) bool quorum)."""
    power5, counted, cids, thresh = tally_inputs(rows, n_commits)
    tally = ek.tally_core(valid != 0, power5, counted, cids, n_commits)
    return tally, ek.quorum_core(tally, thresh)


# csrc/tally_core.cuh kMaxSmemCommits: up to this many commits the tally
# kernel keeps its block partials in shared memory; above it, it adds to
# the global sums directly.
TALLY_SMEM_COMMITS = 256


def tally_outputs(n_commits: int, dev: torch.device):
    """The tally kernels' (n_commits, 6) int32 tally, (n_commits,) bool
    quorum and (n_commits * 5 + 1) int32 scratch (the kernel's entry
    zeroes it)."""
    return (torch.empty((n_commits, ek.TALLY_LIMBS), dtype=torch.int32,
                        device=dev),
            torch.empty((n_commits,), dtype=torch.bool, device=dev),
            torch.empty((n_commits * ek.POWER_LIMBS + 1,), dtype=torch.int32,
                        device=dev))


def tally_quorum(valid: torch.Tensor, rows: torch.Tensor, n_commits: int):
    """Per-commit tally over valid, counted columns and the quorum bit
    (tally > threshold). CUDA tensors launch csrc/tally_quorum.cu (one
    memset of its scratch, one kernel); CPU tensors run
    `tally_quorum_plain`.

    Precondition, not checked here: every power limb in rows C_POW.. is
    below 2^13, as `pack_rows` (through `ek.check_power_limbs`) and
    `ek.power_limbs` make them. On larger limbs the kernel's int32 sums
    wrap as the JAX package's do, and the plain version's int64 sums do
    not."""
    _check_rows(rows, C_THRESH + 1)
    B = rows.shape[1]
    if (valid.dtype != torch.int32 or tuple(valid.shape) != (B,)
            or not valid.is_contiguous()):
        raise ValueError("valid must be contiguous (B,) int32")
    if n_commits * ek.TALLY_LIMBS > (rows.shape[0] - C_THRESH) * B:
        raise ValueError("rows hold fewer thresholds than n_commits")
    if B > (1 << 17):
        raise ValueError("B > 2^17 could overflow the int32 limb sums")
    dev = rows.device
    if dev.type == "cpu":
        return tally_quorum_plain(valid, rows, n_commits)
    if dev.type != "cuda" or valid.device != dev:
        raise ValueError(f"no tally_quorum kernel for rows on {dev} and "
                         f"verdicts on {valid.device}")
    from cometbft_tpu_torch.ops import _build

    fn = _build.kernel_lib("tally_quorum.cu").cbt_tally_quorum
    tally, quorum, scratch = tally_outputs(n_commits, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(valid.data_ptr(), rows.data_ptr(), B, n_commits,
                 scratch.data_ptr(), tally.data_ptr(), quorum.data_ptr(),
                 stream)
    _raise_on(err, "tally_quorum")
    tally_quorum.launches += 1
    return tally, quorum


tally_quorum.launches = 0


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def _to_device(rows, device) -> torch.Tensor:
    t = torch.as_tensor(rows)
    if t.dtype != torch.int32:
        raise ValueError(f"packed rows must be int32, got {t.dtype}")
    return t.to(resolve(device)).contiguous()


def verify_rows(rows, device=None) -> torch.Tensor:
    """(R, B) packed array (numpy or tensor) -> (B,) bool validity on
    `device` (default: the CUDA card)."""
    return ed25519_verify(_to_device(rows, device)) != 0


def verify_tally_rows(rows, n_commits: int, device=None):
    """Fused verify + tally from one packed (R, B) int32 array: one upload,
    two kernels, three outputs (valid (B,) bool, tally (C, 6) int32,
    quorum (C,) bool)."""
    r = _to_device(rows, device)
    verdicts = ed25519_verify(r)
    tally, quorum = tally_quorum(verdicts, r, n_commits)
    return verdicts != 0, tally, quorum


def verify_batch(pubkeys, msgs, sigs, device=None) -> np.ndarray:
    """(pubkey, msg, sig) triples -> (n,) bool numpy validity; each host
    stage a crypto/batch.py `stage`."""
    with cbatch.stage("pack"):
        rows = pack_rows(ek.pack_batch(pubkeys, msgs, sigs,
                                       pad_to=pad_to_tile(len(pubkeys))))
    with cbatch.stage("dispatch"):
        valid = verify_rows(rows, device)
    with cbatch.stage("wait"):
        return valid.cpu().numpy()[: len(pubkeys)]


verify_batch.cols = pad_to_tile
