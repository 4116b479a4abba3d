"""Carry state across from the JAX package.

The two packages share the packed-row ABI and the 13-bit limb layout of
the base comb table, so state made by one can feed the other. These
functions take the JAX package's numpy arrays (never its modules) and
return the port's tensors:

  base_table_from_jax(base_f32)  ed25519_pallas.base_f32(), a (8192, 80)
                                 float32 array of 13-bit limbs of
                                 [d * 256^w]B with Z = 1 -> the verify
                                 kernel's (8192, 3, 10) int32 niels table;
  rows_from_jax(rows, device)    an ed25519_pallas.pack_rows array -> a
                                 tensor (the ABI is shared, so this only
                                 checks shape and dtype);
  valset_table_from_jax(tab_i16, ok, power5, n_vals, device)
                                 the arrays of an ed25519_cached.ValsetTable
                                 -> the port's ValsetTable (same entries,
                                 the port's layout), so both packages
                                 verify against one table.
"""
from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.device import resolve
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops.field import NLIMBS


def base_table_from_jax(base_f32: np.ndarray, device="cpu") -> torch.Tensor:
    """(8192, 4 * NLIMBS) float32 comb table -> (8192, 3, 10) int32 kernel
    table on `device`. The float32 limbs are < 2^13, so they are exact."""
    b = np.asarray(base_f32)
    if b.shape != (32 * 256, 4 * NLIMBS):
        raise ValueError(f"base table has shape {b.shape}")
    limbs = b.astype(np.int64)
    if not np.array_equal(limbs.astype(b.dtype), b):
        raise ValueError("base table limbs are not integers")
    niels = kf.niels_from_points13(limbs.reshape(-1, 4, NLIMBS))
    return torch.from_numpy(niels).to(resolve(device))


def rows_from_jax(rows: np.ndarray, device=None) -> torch.Tensor:
    """A JAX-packed (R, B) int32 array -> the same rows as a tensor on
    `device` (default: the CUDA card)."""
    a = np.asarray(rows)
    if a.dtype != np.int32 or a.ndim != 2 or a.shape[0] <= kf.C_THRESH:
        raise ValueError(f"packed rows must be (> {kf.C_THRESH}, B) int32, "
                         f"got {a.dtype} {a.shape}")
    if a.shape[1] % kf.B_TILE:
        raise ValueError(f"B = {a.shape[1]} is not a multiple of "
                         f"{kf.B_TILE}")
    return torch.from_numpy(np.ascontiguousarray(a)).to(resolve(device))


def valset_table_from_jax(tab_i16, ok, power5, n_vals: int,
                          device="cpu") -> ec.ValsetTable:
    """A JAX ValsetTable's arrays -> the port's ValsetTable on `device`.

    tab_i16 is the JAX kernel layout, (M/128 * 8192, 128) int16: row
    blk * 8192 + e * 64 + r, lane v % 128 holds limb row r of entry e of
    validator v = blk * 128 + lane, rows 0-59 being (y - x, y + x, 2dt) as
    three 20-limb 13-bit canonical values and rows 60-63 padding. The
    port's table holds entry v * 128 + e as {y + x, y - x, 2dxy} in
    radix-2^25.5 limbs. The result has no host key copies and no pub_raw
    (so no near-miss patching and no device stamping)."""
    t = np.asarray(tab_i16)
    M = int(n_vals)
    if t.dtype != np.int16 or t.shape != (M // 128 * 8192, 128) or M % 128:
        raise ValueError(f"table is {t.dtype} {t.shape} for M = {M}")
    t = t.reshape(M // 128, ec.ENT_PER_VAL, 64, 128).transpose(0, 3, 1, 2)
    limbs = t.reshape(M, ec.ENT_PER_VAL, 64)[..., :60].astype(np.int64)
    ym, yp, t2d = np.split(limbs.reshape(M, ec.ENT_PER_VAL, 3, 20), 3, 2)
    niels = np.concatenate([yp, ym, t2d], 2)  # the port's field order
    tab = ec.limbs13_to_25(torch.from_numpy(niels)).to(torch.int32)
    dev = resolve(device)
    ok_t = torch.from_numpy(np.asarray(ok, np.bool_).reshape(M)).to(dev)
    p5 = torch.from_numpy(
        np.ascontiguousarray(np.asarray(power5, np.int32))).to(dev)
    return ec.ValsetTable(tab.reshape(M * ec.ENT_PER_VAL, 3, 10)
                          .contiguous().to(dev), ok_t, p5, M, device=dev)
