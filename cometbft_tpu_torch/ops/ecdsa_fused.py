"""Batched secp256k1 ECDSA verification over one packed int32 array, on
the hand-written Hopper kernel.

Counterpart of the JAX package's ops/ecdsa_pallas.py. The packed-row ABI
(`E_*`, `pack_rows`) is byte for byte the JAX package's, so one host array
feeds both. One kernel runs the verify:

  ecdsa_verify  csrc/ecdsa_verify.cu, one verdict per column.

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain PyTorch version (`ecdsa_verify_plain`, over ecdsa_kernel.verify_core)
for CPU tensors; nothing falls back silently. `ecdsa_verify.launches`
counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.crypto import batch as cbatch
from cometbft_tpu_torch.crypto import secp256k1_ref as ref
from cometbft_tpu_torch.ops import ecdsa_kernel as eck
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import field as fe
from cometbft_tpu_torch.ops import secp256k1 as curve
from cometbft_tpu_torch.ops.ed25519_fused import (_check_rows, _raise_on,
                                                  _to_device)
from cometbft_tpu_torch.ops.field import NLIMBS

B_TILE = 128
_M13 = (1 << 13) - 1

# compact row layout (all int32, lanes = signatures)
E_QX = 0       # 10 rows: pubkey x, limb pairs l[i] | l[i+10] << 13
E_XR1 = 10     # 10 rows: r as a field element
E_XR2 = 20     # 10 rows: r + N if < p else r
E_U1 = 30      # 8 rows: u1 byte digits (4 per word) for the base comb
E_U2 = 38      # 8 rows: u2 nibble digits (8 per word) for the window loop
E_FLAGS = 46   # parity | precheck << 2
E_KROWS = 47


# --------------------------------------------------------------------------
# host packing
# --------------------------------------------------------------------------


def pack_rows(pb: eck.PackedEcdsaBatch) -> np.ndarray:
    """PackedEcdsaBatch -> compact (E_KROWS, B) int32 array."""
    B = pb.qx.shape[0]
    rows = np.zeros((E_KROWS, B), np.int32)
    qx = np.asarray(pb.qx, np.int32)
    rows[E_QX:E_QX + 10] = (qx[:, :10] | (qx[:, 10:] << 13)).T
    x1 = np.asarray(pb.xr1, np.int32)
    rows[E_XR1:E_XR1 + 10] = (x1[:, :10] | (x1[:, 10:] << 13)).T
    x2 = np.asarray(pb.xr2, np.int32)
    rows[E_XR2:E_XR2 + 10] = (x2[:, :10] | (x2[:, 10:] << 13)).T
    u1_8 = (pb.u1dig[:, 0::2] + 16 * pb.u1dig[:, 1::2]).astype(np.int32)
    acc = np.zeros((B, 8), np.int32)
    for k in range(4):
        acc |= u1_8[:, 8 * k:8 * k + 8] << (8 * k)
    rows[E_U1:E_U1 + 8] = acc.T
    acc = np.zeros((B, 8), np.int32)
    u2 = np.asarray(pb.u2dig, np.int32)
    for k in range(8):
        acc |= u2[:, 8 * k:8 * k + 8] << (4 * k)
    rows[E_U2:E_U2 + 8] = acc.T
    rows[E_FLAGS] = (np.asarray(pb.qparity, np.int32)
                     | (np.asarray(pb.precheck, np.int32) << 2))
    return rows


def pad_to_tile(n: int) -> int:
    """Bucket size for the packed path: >= B_TILE and a multiple of it."""
    return max(ek.bucket_size(max(n, 1)), B_TILE)


# --------------------------------------------------------------------------
# comb table of G
# --------------------------------------------------------------------------


def _limbs26(v: int):
    return [(v >> (26 * i)) & ((1 << 26) - 1) for i in range(10)]


def comb26_from_points13(points) -> np.ndarray:
    """(N, 3, NLIMBS) projective points in 13-bit limbs (any int dtype,
    values below p) -> (N, 3, 10) int32 entries in the kernel's canonical
    26-bit limbs (csrc/secp256k1_core.cuh)."""
    pts = np.asarray(points).astype(np.int64)
    if pts.ndim != 3 or pts.shape[1:] != (3, NLIMBS):
        raise ValueError(f"points have shape {pts.shape}")
    vals = fe.limbs_to_int(pts)
    out = np.empty((pts.shape[0], 3, 10), np.int32)
    for i in range(pts.shape[0]):
        for c in range(3):
            v = int(vals[i, c])
            if not 0 <= v < ref.P:
                raise ValueError(f"entry {i} coordinate {c} is not below p")
            out[i, c] = _limbs26(v)
    return out


_TABLES: dict = {}


def comb_table_np() -> np.ndarray:
    """(8192, 3, 10) int32 kernel comb table, [d * 256^w]G at w * 256 + d,
    from the port's own secp256k1.base_table8_np."""
    t = _TABLES.get("comb_np")
    if t is None:
        t = comb26_from_points13(
            curve.base_table8_np().reshape(32 * 256, 3, NLIMBS))
        _TABLES["comb_np"] = t
    return t


def base_table(device) -> torch.Tensor:
    """The kernel's comb table, resident on `device` (uploaded once)."""
    key = ("comb", str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(comb_table_np()).to(device)
        _TABLES[key] = t
    return t


def base_points(device) -> torch.Tensor:
    """(32, 256, 3, NLIMBS) int64 comb table of the plain version."""
    key = ("points", str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(curve.base_table8_np().astype(np.int64)).to(
            device)
        _TABLES[key] = t
    return t


# --------------------------------------------------------------------------
# ecdsa_verify: kernel wrapper and plain version
# --------------------------------------------------------------------------


# Field multiplications and squarings of one column that runs to its end in
# csrc/secp256k1_core.cuh `ecdsa_verify_column`: the decompression (1M +
# 2S, the 13M + 253S square-root chain), 14 table adds, 63 x (4 doublings
# of 6M + 2S and one add), 32 comb adds and 2M for the final compare; an
# add is 12M. Each multiplication is 100 limb products, each squaring 55.
VERIFY_FE_MULS = 2836
VERIFY_FE_SQUARES = 759


def verify_products_per_signature() -> int:
    """32 x 32 -> 64 bit limb products of one verified signature."""
    return VERIFY_FE_MULS * 100 + VERIFY_FE_SQUARES * 55


def ecdsa_verify_plain(rows: torch.Tensor, points: torch.Tensor):
    """Plain PyTorch version of the verify kernel: (>= E_KROWS, B) int32
    rows + the (32, 256, 3, NLIMBS) comb table -> (B,) int32 verdicts."""
    r = rows[:E_KROWS].to(torch.int64)

    def limbs(row0):
        w = r[row0:row0 + 10]
        return torch.cat([w & _M13, (w >> 13) & _M13]).T.contiguous()

    # unpacking masks after the (arithmetic) shift: the top digit of a
    # word sets its sign bit
    u1 = torch.cat([(r[E_U1:E_U1 + 8] >> (8 * k)) & 255
                    for k in range(4)]).T.contiguous()  # (B, 32)
    u2 = torch.cat([(r[E_U2:E_U2 + 8] >> (4 * k)) & 15
                    for k in range(8)]).T.contiguous()  # (B, 64)
    u1dig = torch.stack([u1 & 15, u1 >> 4], -1).reshape(u1.shape[0], 64)
    flags = r[E_FLAGS]
    valid = eck.verify_core(limbs(E_QX), flags & 1, u1dig, u2, limbs(E_XR1),
                            limbs(E_XR2), (flags >> 2) & 1, points)
    return valid.to(torch.int32)


def ecdsa_verify(rows: torch.Tensor) -> torch.Tensor:
    """(>= E_KROWS, B) int32 packed rows -> (B,) int32 verdicts (1 valid).

    CUDA tensors launch csrc/ecdsa_verify.cu with the 26-bit comb table
    (`base_table`); CPU tensors run `ecdsa_verify_plain` with the plain
    table (`base_points`)."""
    _check_rows(rows, E_KROWS)
    dev = rows.device
    if dev.type == "cpu":
        return ecdsa_verify_plain(rows, base_points(dev))
    if dev.type != "cuda":
        raise ValueError(f"no ecdsa_verify kernel for device {dev}")
    from cometbft_tpu_torch.ops import _build

    fn = _build.kernel_lib("ecdsa_verify.cu").cbt_ecdsa_verify
    table = base_table(dev)
    B = rows.shape[1]
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rows.data_ptr(), B, table.data_ptr(), out.data_ptr(),
                 stream)
    _raise_on(err, "ecdsa_verify")
    ecdsa_verify.launches += 1
    return out


ecdsa_verify.launches = 0


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def verify_rows(rows, device=None) -> torch.Tensor:
    """(E_KROWS, B) packed array (numpy or tensor) -> (B,) bool validity
    on `device` (default: the CUDA card)."""
    return ecdsa_verify(_to_device(rows, device)) != 0


def verify_batch(pubkeys, msgs, sigs, device=None) -> np.ndarray:
    """(pubkey33, msg, sig64) triples -> (n,) bool numpy validity; each
    host stage a crypto/batch.py `stage`."""
    with cbatch.stage("pack"):
        rows = pack_rows(eck.pack_batch(pubkeys, msgs, sigs,
                                        pad_to=pad_to_tile(len(pubkeys))))
    with cbatch.stage("dispatch"):
        valid = verify_rows(rows, device)
    with cbatch.stage("wait"):
        return valid.cpu().numpy()[: len(pubkeys)]


verify_batch.cols = pad_to_tile
