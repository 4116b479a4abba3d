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
                                 checks shape and dtype).
"""
from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.device import resolve
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
