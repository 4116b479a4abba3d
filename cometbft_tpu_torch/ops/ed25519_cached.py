"""Cached-valset ed25519 verification: per-validator window tables.

Counterpart of the JAX package's ops/ed25519_cached.py (the table half and
the verify half; device sign-bytes stamping is ops/ed25519_stamp.py).
Consensus and blocksync verify thousands of commits against the SAME
validator set, so the A-side work of every signature hoists into a
device-resident table built once per valset (and patched on epoch churn,
`update_table`):

  for each validator, [d] * (2^(32j) * (-A)) for the 8 bases j = 0..7 and
  the 16 window digits d, as affine niels points. Then

      h*(-A) = sum_w 16^w * sum_j [digit_{8j+w}] * base_j

  is a Horner loop of 7 x 4 doublings and 64 mixed adds, against 252
  doublings and a per-signature table in the general kernel.

Three kernels run the path, each with its plain PyTorch version beside it
(taken only for CPU tensors; a CUDA tensor launches the kernel or raises):

  valset_table_build     csrc/valset_table.cu, the table (and update_table's
                         128-slot delta);
  ed25519_verify_cached  csrc/ed25519_cached_verify.cu, one verdict per
                         column, column b is validator b mod M;
  tally_quorum_cached    csrc/tally_quorum.cu, per-commit power tally from
                         the table's power5, and the quorum bit.

The port's table layout: `tab` is (M * 128, 3, 10) int32, entry v * 128 +
j * 16 + d of validator v an affine niels point {y + x, y - x, 2dxy} in
canonical radix-2^25.5 limbs (the kernels' field layout). The JAX table
holds the same points as (y - x, y + x, 2dt) in 13-bit int16 limbs, blocked
by 128 validators; convert.valset_table_from_jax maps one onto the other.
The packed-row ABI (`V_*`, `pack_rows_cached`) is byte for byte the JAX
package's. A sharded table (`ShardedValsetTable`) holds one such table a
slot of a parallel/mesh.Mesh, each shard built on its slot's device.

The JAX module's stamping entries (`STAMP_NAMES`: `TemplateEntry`,
`template_entry`, `warm_template`, `stamp_rows_cached`,
`verify_tally_delta_cached`) resolve here to ops/ed25519_stamp.py's
objects, so callers and tests that look for them under this module get
the same functions.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cometbft_tpu_torch.crypto import batch as cbatch
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.device import resolve
from cometbft_tpu_torch.ops import curve25519 as curve
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import field as fe
from cometbft_tpu_torch.ops import table_cache as tc

NJ = 8          # split bases per validator: base_j = 2^(32j) * (-A)
NW = 8          # 4-bit Horner windows per base (8*8 nibbles = 256 bits)
NENT = 16       # table entries per (validator, base): [0..15] * base_j
ENT_PER_VAL = NJ * NENT

# Compact packed-row layout of the cached path (the JAX package's ABI): no
# pubkey rows (the table is the pubkey), no validator-index row (column b
# is validator b mod M by construction) and no power rows (voting power is
# valset data and rides in the table).
V_RY = 0        # 10 rows: sig R y limb pairs, word = l[i] | l[i+10] << 13
V_S8 = 10       # 8 rows: byte digits of s (comb), digit d at row d%8
V_H4 = 18       # 8 rows: nibble digits of h, digit d at row d%8
V_FLAGS = 26    # rsign | precheck<<1 | counted<<2 | commit_id<<3
V_KROWS = 27    # rows the verify kernel reads
V_THRESH = 27   # flattened (n_commits, TALLY_LIMBS) thresholds

_M13 = (1 << 13) - 1
_E = kf._E                                   # radix-2^25.5 limb boundaries
_W25 = [_E[i + 1] - _E[i] for i in range(10)]


# --------------------------------------------------------------------------
# limb layouts (13-bit x 20 <-> radix 2^25.5 x 10, canonical values)
# --------------------------------------------------------------------------


def limbs13_to_25(x: torch.Tensor) -> torch.Tensor:
    """(..., 20) canonical 13-bit limbs -> (..., 10) int64 canonical
    radix-2^25.5 limbs of the same value."""
    x = x.to(torch.int64)
    z = torch.zeros_like(x[..., :2])
    w = torch.cat([x, z], -1)
    out = []
    for i in range(10):
        k, off = divmod(_E[i], 13)
        v = w[..., k] | (w[..., k + 1] << 13) | (w[..., k + 2] << 26)
        out.append((v >> off) & ((1 << _W25[i]) - 1))
    return torch.stack(out, -1)


def limbs25_to_13(x: torch.Tensor) -> torch.Tensor:
    """(..., 10) canonical radix-2^25.5 limbs -> (..., 20) int64 13-bit
    limbs of the same value."""
    x = x.to(torch.int64)
    w = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
    out = []
    for k in range(20):
        s = 13 * k
        i = max(i for i in range(10) if _E[i] <= s)
        v = (w[..., i] >> (s - _E[i])) | (w[..., i + 1] << (_E[i + 1] - s))
        out.append(v & _M13)
    return torch.stack(out, -1)


def _bytes_to_limbs13(b: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 little-endian -> (..., 20) int64 limbs of the low
    255 bits, unreduced (ZIP-215 accepts y >= p)."""
    x = b.to(torch.int64).clone()
    x[..., 31] &= 0x7F
    w = torch.cat([x, torch.zeros_like(x[..., :3])], -1)
    out = []
    for i in range(20):
        j, r = divmod(13 * i, 8)
        win = w[..., j] | (w[..., j + 1] << 8) | (w[..., j + 2] << 16)
        out.append((win >> r) & _M13)
    return torch.stack(out, -1)


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_device(dev: torch.device, name: str, *tensors) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")


# --------------------------------------------------------------------------
# valset_table_build: kernel wrapper and plain version
# --------------------------------------------------------------------------


def valset_table_build_plain(pub_raw: torch.Tensor, lenok: torch.Tensor):
    """Plain PyTorch version of the table build: (M, 32) uint8 key bytes +
    (M,) bool length bits -> ((M * 128, 3, 10) int32 table, (M,) bool ok).
    A key that does not decode gets identity entries; ok = decoded and
    32 bytes long."""
    M = pub_raw.shape[0]
    dev = pub_raw.device
    A, dec = curve.decompress(_bytes_to_limbs13(pub_raw),
                              pub_raw[:, 31].to(torch.int64) >> 7)
    ident = curve.identity(M, dev)
    negA = tuple(torch.where(dec[:, None], c, i)
                 for c, i in zip(curve.neg(A), ident))
    bases = [negA]
    for _ in range(NJ - 1):
        p = bases[-1]
        for _ in range(32):
            p = curve.double(p)
        bases.append(p)
    flat = tuple(torch.cat([b[c] for b in bases]) for c in range(4))  # j-major
    pts = [curve.identity(NJ * M, dev), flat]
    for _ in range(NENT - 2):
        pts.append(curve.add(pts[-1], flat))
    # one inversion per (validator, j) over its 16 Z's (Montgomery's trick)
    pre = [pts[0][2]]
    for d in range(1, NENT):
        pre.append(fe.mul(pre[-1], pts[d][2]))
    inv = fe.invert(pre[-1])
    zinv = [None] * NENT
    for d in range(NENT - 1, 0, -1):
        zinv[d] = fe.mul(inv, pre[d - 1])
        inv = fe.mul(inv, pts[d][2])
    zinv[0] = inv
    d2 = fe.const(curve.D2, dev)
    ents = []
    for d in range(NENT):
        x = fe.mul(pts[d][0], zinv[d])
        y = fe.mul(pts[d][1], zinv[d])
        ents.append(torch.stack([fe.canonical(fe.add(y, x)),
                                 fe.canonical(fe.sub(y, x)),
                                 fe.canonical(fe.mul(fe.mul(x, y), d2))], 1))
    e = limbs13_to_25(torch.stack(ents, 1))          # (NJ*M, 16, 3, 10)
    e = e.reshape(NJ, M, NENT, 3, 10).transpose(0, 1)
    return (e.reshape(M * ENT_PER_VAL, 3, 10).to(torch.int32).contiguous(),
            dec & lenok)


# The C entries of csrc/valset_table.cu: a quad of four threads a
# validator, and a warp (eight quads) a validator. Both park their Z's in
# a scratch of TABLE_SCRATCH_WORDS int32 a validator.
TABLE_BUILD_ENTRIES = {"quad": "cbt_valset_table_build_quad",
                       "warp": "cbt_valset_table_build_warp"}
TABLE_SCRATCH_WORDS = NJ * (NENT - 1) * 10

# The wrapper launches the warp entry up to this many validators an SM and
# the quad entry above (1,056 validators on 132 SMs). From chip_smoke.py's
# sweep of both entries in phases 6 and 7 (device ms on one NVIDIA H100
# 80GB HBM3 at 700.00 W), warp / quad: 0.362026 / 0.678799 at M = 128,
# 0.466920 / 0.685865 at 1,024 (7.8 an SM), 0.812371 / 0.706293 at 2,048
# (15.5 an SM), 1.566344 / 0.731497 at 4,096, 5.928422 / 1.798220 at
# 16,384. While schedulers idle the chain decides, and the warp entry's
# is shorter; once every SM is full issue decides, and the quad issues
# about a quarter of the products a validator. The crossover lies
# between 7.8 and 15.5 validators an SM; 8 is the first whole number
# above the measured warp win.
WARP_MAX_VALS_PER_SM = 8


def table_build_entry(M: int, sms: int) -> str:
    """The entry the wrapper launches for an M-validator build on a card of
    `sms` SMs: "warp" up to WARP_MAX_VALS_PER_SM validators an SM, else
    "quad"."""
    return "warp" if M <= WARP_MAX_VALS_PER_SM * sms else "quad"


def launch_valset_table_build(pub_raw: torch.Tensor, lenok: torch.Tensor,
                              entry: str):
    """One launch of the table-build entry `entry` on CUDA operands the
    wrapper has checked; counts nothing. -> (tab, ok)."""
    from cometbft_tpu_torch.ops import _build

    dev = pub_raw.device
    M = pub_raw.shape[0]
    fn = getattr(_build.kernel_lib("valset_table.cu"),
                 TABLE_BUILD_ENTRIES[entry])
    tab = torch.empty((M * ENT_PER_VAL, 3, 10), dtype=torch.int32,
                      device=dev)
    ok = torch.empty((M,), dtype=torch.bool, device=dev)
    zs = torch.empty((M * TABLE_SCRATCH_WORDS,), dtype=torch.int32,
                     device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pub_raw.data_ptr(), lenok.data_ptr(), M, tab.data_ptr(),
                 zs.data_ptr(), ok.data_ptr(), stream)
    kf._raise_on(err, "valset_table_build")
    return tab, ok


def valset_table_build(pub_raw: torch.Tensor, lenok: torch.Tensor):
    """(M, 32) uint8 key bytes (zero for dead or malformed slots) + (M,)
    bool (key had 32 bytes) -> (tab (M * 128, 3, 10) int32, ok (M,) bool).

    CUDA tensors launch csrc/valset_table.cu, the entry
    `table_build_entry` names; CPU tensors run `valset_table_build_plain`."""
    M = pub_raw.shape[0]
    _check(pub_raw, "pub_raw", torch.uint8, (M, 32))
    _check(lenok, "lenok", torch.bool, (M,))
    dev = pub_raw.device
    if dev.type == "cpu" and lenok.device == dev:
        return valset_table_build_plain(pub_raw, lenok)
    _kernel_device(dev, "valset_table_build", lenok)
    out = launch_valset_table_build(pub_raw, lenok,
                                    table_build_entry(M, sm_count(dev)))
    valset_table_build.launches += 1
    return out


valset_table_build.launches = 0

# Field multiplications (M) and squarings (S) of the table build's parts in
# csrc/ed25519_core.cuh: a decompression, a doubling (1M more when it keeps
# T), the 14 cached adds that make entries 2..15 of a base (and 1M to put
# the base in cached form), an inversion chain, an affine niels conversion;
# a batch inversion costs 3M a Z after the first.
_DEC_M, _DEC_S = 19, 255
_DBL_M, _DBL_S = 3, 4
_ADDS_M = 1 + (NENT - 2) * 8
_INV_M, _INV_S = 11, 254
_NIELS_M = 4
_KERNEL_DBLS = 32 * NJ * (NJ - 1) // 2   # thread j doubles 32 j times
_LIVE_ENT = NJ * (NENT - 1)              # entries d >= 1; d = 0 is constant

# What csrc/ed25519_cached.cuh `table_entries` runs for one validator: 8
# (validator, j) threads, each with its own decompression, 32 j doublings,
# adds, a batch inversion over its 16 Z's and 16 conversions.
BUILD_FE_MULS = (NJ * (_DEC_M + _ADDS_M + 3 * (NENT - 1) + _INV_M
                       + NENT * _NIELS_M)
                 + _KERNEL_DBLS * _DBL_M + (NJ - 1))
BUILD_FE_SQUARES = NJ * (_DEC_S + _INV_S) + _KERNEL_DBLS * _DBL_S

# What one validator's table needs, the bound's count: one decompression,
# 224 chained doublings (the 7 that end a base keep T), the same adds, one
# batch inversion over the 120 entries d >= 1 and their 120 conversions.
# The kernel's repeated decompressions, doublings and inversions (2.8x
# these products) are its design's cost, not the function's.
BUILD_NEEDED_FE_MULS = (_DEC_M + 32 * (NJ - 1) * _DBL_M + (NJ - 1)
                        + NJ * _ADDS_M + 3 * (_LIVE_ENT - 1) + _INV_M
                        + _LIVE_ENT * _NIELS_M)
BUILD_NEEDED_FE_SQUARES = _DEC_S + 32 * (NJ - 1) * _DBL_S + _INV_S


# What csrc/valset_table_quad.cuh runs for one validator, counted over the
# four lanes of a quad (a lane's step is one product; the host build runs
# all four): a doubling is 4S + 4M, an addition 8M, a cached form 4M (lane
# 2's 2dT and three products by one), a Montgomery step 4M each way; x y
# of -A is 1M. A base's 15 entries cost 4M for its cached form, then per
# entry a forward step and, past the first, an addition and a cached form.
_QDBL = 4
_QBASE_FWD_M = 4 + 4 + (NENT - 2) * (8 + 4 + 4)
# The quad program: one decompression, 224 chained doublings, one
# inversion on the block's first warp over the 120 Z's, 120 backward steps.
BUILD_QUAD_FE_MULS = (_DEC_M + 1 + 32 * (NJ - 1) * _QDBL + NJ * _QBASE_FWD_M
                      + _INV_M + _LIVE_ENT * 4)
BUILD_QUAD_FE_SQUARES = _DEC_S + 32 * (NJ - 1) * _QDBL + _INV_S
# The warp program: one decompression; each of 8 quads runs all 224
# doublings and its base's entries, and inverts its 15 Z's.
BUILD_WARP_FE_MULS = _DEC_M + NJ * (1 + 32 * (NJ - 1) * _QDBL + _QBASE_FWD_M
                                    + _INV_M + (NENT - 1) * 4)
BUILD_WARP_FE_SQUARES = _DEC_S + NJ * (32 * (NJ - 1) * _QDBL + _INV_S)


def build_products_per_validator() -> int:
    """32 x 32 -> 64 bit limb products one validator's table needs."""
    return BUILD_NEEDED_FE_MULS * 100 + BUILD_NEEDED_FE_SQUARES * 55


# --------------------------------------------------------------------------
# the valset table
# --------------------------------------------------------------------------


class ValsetTable:
    """Device-resident window table for one validator set.

    n_vals is the PADDED size M (>= 128, bucketed); verification batches
    lay validator i's signature of commit c at column c * M + i, so column
    b is validator b mod M. Voting power lives here too: it is valset data,
    uploaded once with the table instead of riding every chunk."""

    def __init__(self, tab, ok, power5, n_vals: int,
                 pubs_host: Optional[tuple] = None,
                 powers_host: Optional[np.ndarray] = None,
                 pub_raw=None, device=None):
        self.tab = tab          # (M * 128, 3, 10) int32
        self.ok = ok            # (M,) bool
        self.power5 = power5    # (M, POWER_LIMBS) int32
        self.n_vals = n_vals
        # (M, 32) uint8 raw pubkeys: the A operand the stamping kernel
        # hashes (SHA-512(R||A||msg)); None disables device stamping
        self.pub_raw = pub_raw
        # per-slot ACTUAL pubkey bytes + host power copy: table_for_pubs
        # finds a near-miss cached table and its exact (pubkey, power)
        # delta without a device round trip. Full bytes, not digests, so
        # a digest collision can never pin a retired key into a table.
        self.pubs_host = pubs_host
        self.powers_host = powers_host
        if device is None and tab is not None:
            device = tab.device
        self.device = torch.device(device) if device is not None else None


def table_pad(n: int) -> int:
    """Padded table size M: >= 128 (one lane tile) and bucketed."""
    return max(128, ek.bucket_size(max(n, 1)))


def _pubs_host(pub_bytes: Sequence[bytes], padded: int) -> tuple:
    """Padded per-slot pubkey bytes (b"" for dead slots)."""
    out = list(pub_bytes[:padded])
    out.extend(b"" for _ in range(padded - len(out)))
    return tuple(out)


def _powers_host(powers, padded: int) -> np.ndarray:
    ph = np.zeros((padded,), np.int64)
    if powers is not None:
        ph[: len(powers)] = np.asarray(powers, np.int64)
    return ph


def _power_dev(powers, padded: int, device) -> torch.Tensor:
    p5 = np.zeros((padded, ek.POWER_LIMBS), np.int32)
    if powers is not None:
        p5[: len(powers)] = ek.power_limbs(np.asarray(powers, np.int64))
    return torch.from_numpy(p5).to(device)


def _pack_pub_arrays(pub_bytes: Sequence[bytes], padded: int):
    """(padded, 32) uint8 raw key bytes (dead and malformed slots zero)
    and (padded,) bool: the key had 32 bytes."""
    a_raw = np.zeros((padded, 32), np.uint8)
    lenok = np.zeros(padded, np.bool_)
    for i, p in enumerate(pub_bytes[:padded]):
        if len(p) == 32:
            a_raw[i] = np.frombuffer(p, np.uint8)
            lenok[i] = True
    return a_raw, lenok


def build_table(pub_bytes: Sequence[bytes], powers=None,
                device=None) -> ValsetTable:
    """Build the table for a list of 32-byte ed25519 pubkeys on `device`
    (default: the CUDA card)."""
    dev = resolve(device)
    padded = table_pad(len(pub_bytes))
    a_raw, lenok = _pack_pub_arrays(pub_bytes, padded)
    pub_raw = torch.from_numpy(a_raw).to(dev)
    tab, ok = valset_table_build(pub_raw, torch.from_numpy(lenok).to(dev))
    return ValsetTable(tab, ok, _power_dev(powers, padded, dev), padded,
                       _pubs_host(pub_bytes, padded),
                       _powers_host(powers, padded), pub_raw, dev)


# -- incremental update (validator-set churn) ------------------------------

UPDATE_PAD = 128  # one lane tile: the epoch-delta build shape


def update_table(table: ValsetTable, changes,
                 powers_by_idx=None) -> ValsetTable:
    """Incremental table update for a validator-set delta.

    changes: list of (index, pubkey_bytes) for slots whose key changed
    (or appeared: index may extend up to the table's padded size).
    powers_by_idx: optional {index: power} for slots whose power
    changed (power changes alone don't touch the curve table).

    The changed keys' columns come from `valset_table_build` over a
    128-slot delta; they are scattered into a copy of the table (the
    cached table a flush may still read is never written in place), so
    the result is byte-identical to a cold build."""
    idx_list = [i for i, _ in changes]
    if not all(0 <= i < table.n_vals for i in idx_list):
        raise ValueError("change index beyond the table's padded size")
    pw_items = list((powers_by_idx or {}).items())
    if not all(0 <= i < table.n_vals for i, _ in pw_items):
        raise ValueError("power index beyond the table's padded size")
    # slots needing a write: key changes plus power-only changes that
    # don't coincide with a key change
    extra_pw = [i for i, _ in pw_items if i not in set(idx_list)]
    if len(idx_list) + len(extra_pw) > UPDATE_PAD:
        raise ValueError(
            f"delta of {len(idx_list)}+{len(extra_pw)} slots exceeds "
            f"UPDATE_PAD={UPDATE_PAD}; rebuild the table instead"
        )
    if not changes and not pw_items:
        return table
    dev = table.device
    M = table.n_vals
    tab, ok, power5 = table.tab, table.ok, table.power5
    pr = table.pub_raw
    if changes:
        last = dict(changes)  # a repeated index keeps its last key
        idx = torch.as_tensor(list(last), dtype=torch.int64, device=dev)
        a_raw, lenok = _pack_pub_arrays(list(last.values()), UPDATE_PAD)
        a_dev = torch.from_numpy(a_raw).to(dev)
        cols, ok_new = valset_table_build(a_dev,
                                          torch.from_numpy(lenok).to(dev))
        k = len(last)
        tab = tab.clone()
        tab.view(M, -1).index_copy_(0, idx, cols.view(UPDATE_PAD, -1)[:k])
        ok = ok.clone()
        ok.index_copy_(0, idx, ok_new[:k])
        if pr is not None:
            pr = pr.clone()
            pr.index_copy_(0, idx, a_dev[:k])
    if pw_items:
        pw = dict(pw_items)
        pidx = torch.as_tensor(list(pw), dtype=torch.int64, device=dev)
        p5 = ek.power_limbs(np.asarray(list(pw.values()), np.int64))
        power5 = power5.clone()
        power5.index_copy_(0, pidx, torch.from_numpy(p5).to(dev))
    pubs_host = None
    if table.pubs_host is not None:
        lst = list(table.pubs_host)
        for (i, p) in changes:
            lst[i] = p
        pubs_host = tuple(lst)
    ph = None
    if table.powers_host is not None:
        ph = table.powers_host.copy()
        for i, pw in pw_items:
            ph[i] = pw
    return ValsetTable(tab, ok, power5, M, pubs_host, ph, pr, dev)


# The whole cache stack below (built tables, the two identity memos) is
# BOUNDED and EVICTING: instances, capacities, eviction/warm accounting
# and the shared lock live in ops/table_cache.py. Cache keys carry the
# device, so a table built for the CPU never serves the card.
_TABLE_CACHE = tc.TABLES
_TABLE_LOCK = tc.LOCK
_TABLE_STATS = tc.STATS
MAX_INCREMENTAL = 64  # fall back to full rebuild above this delta

note_warmed = tc.note_warmed


def table_cache_stats() -> dict:
    """Lookups, hits, evictions and incremental patches of the caches; a
    healthy consensus stream is ~all hits."""
    return tc.stats()


def table_cache_resident_bytes() -> int:
    """Bytes pinned by the bounded table cache: the tables' device
    tensors plus their host key and power copies."""
    return tc.resident_bytes()


def _cache_key(pub_bytes: Sequence[bytes], powers) -> bytes:
    h = hashlib.sha256()
    for p in pub_bytes:
        # length-prefix each key so the digest is injective over the
        # list (bare concat collides when key lengths vary)
        h.update(len(p).to_bytes(8, "big"))
        h.update(p)
    if powers is not None:
        for pw in powers:
            h.update(int(pw).to_bytes(8, "big", signed=True))
    return h.digest() + len(pub_bytes).to_bytes(4, "big")


# Identity memo over the content key: _cache_key walks every pubkey in
# Python, so callers that present a stable immutable key list (the stream
# verifier's per-valset columns) pay it once. Entries pin the tuples
# themselves, so an id() can never alias a collected object.
_KEY_MEMO = tc.KEY_MEMO


def _memo_cache_key(pub_bytes, powers) -> bytes:
    if type(pub_bytes) is not tuple or not (
        powers is None or type(powers) is tuple
    ):
        return _cache_key(pub_bytes, powers)  # mutable: never memoize
    with _TABLE_LOCK:
        ent = _KEY_MEMO.get(id(pub_bytes))
        if ent is not None and ent[0] is pub_bytes and ent[1] is powers:
            _TABLE_STATS["key_memo_hits"] += 1
            return ent[2]
    key = _cache_key(pub_bytes, powers)
    with _TABLE_LOCK:
        _KEY_MEMO.put(id(pub_bytes), (pub_bytes, powers, key))
    return key


def _find_incremental_base(target, padded: int, device):
    """Newest cached table on `device` with the same padded size and at
    most MAX_INCREMENTAL changed slots, plus the changed indices, or None.
    Callers hold _TABLE_LOCK. The delta compares FULL pubkey bytes."""
    for cand in reversed(list(_TABLE_CACHE.values())):
        if (cand.n_vals != padded or cand.pubs_host is None
                or cand.device != device):
            continue
        diff = [i for i in range(padded)
                if cand.pubs_host[i] != target[i]]
        if len(diff) <= MAX_INCREMENTAL:
            return cand, diff
    return None


def _patch_from_base(cand: ValsetTable, diff, target, powers,
                     padded: int) -> Optional[ValsetTable]:
    """Patch `cand`'s delta rows into the target valset's table. Returns
    None when the delta overflows update_table's slot budget (callers pay
    the full rebuild). Only CHANGED powers ride the update; powers=None
    means zero powers, as in a cold build_table(pubs, None)."""
    changes = [(int(i), target[i]) for i in diff]
    new_ph = _powers_host(powers, padded)
    old_ph = (cand.powers_host if cand.powers_host is not None
              else np.zeros((padded,), np.int64))
    pw_map = {int(i): int(new_ph[i])
              for i in np.nonzero(new_ph != old_ph)[0]}
    try:
        t = update_table(cand, changes, pw_map)
    except ValueError:
        return None  # delta too large: full rebuild on the caller
    with _TABLE_LOCK:
        _TABLE_STATS["incremental_patches"] += 1
    return t


def table_for_pubs_info(pub_bytes: Sequence[bytes], powers=None,
                        device=None) -> Tuple[ValsetTable, bool]:
    """(table, warm): warm=True when the lookup was a straight LRU hit,
    with no build and no incremental patch."""
    dev = resolve(device)
    key = (_memo_cache_key(pub_bytes, powers), str(dev))
    with _TABLE_LOCK:
        t = _TABLE_CACHE.get(key)
        if t is not None:
            _TABLE_STATS["hits"] += 1
            tc.consume_warmed(key)
            return t, True
        _TABLE_STATS["misses"] += 1
        # near-miss scan: same padded size, few changed slots -> update
        # the cached table incrementally (valset churn between epochs)
        padded = table_pad(len(pub_bytes))
        target = _pubs_host(pub_bytes, padded)
        base = _find_incremental_base(target, padded, dev)
    t = None
    if base is not None:
        cand, diff = base
        t = _patch_from_base(cand, diff, target, powers, padded)
    if t is None:
        t = build_table(pub_bytes, powers, dev)
    with _TABLE_LOCK:
        _TABLE_CACHE.put(key, t)
    return t, False


def warm_incremental(pub_bytes: Sequence[bytes], powers=None,
                     device=None) -> bool:
    """A warmer's incremental fast path: when a cached near-miss table
    covers the change set (<= MAX_INCREMENTAL slots), patch its delta
    rows into the cache instead of paying the full build. Returns True
    when the target table is now cached (already present, or patched in
    here); False means no eligible base exists. Counts neither a hit nor
    a miss: this is a warm, not a lookup."""
    dev = resolve(device)
    key = (_memo_cache_key(pub_bytes, powers), str(dev))
    with _TABLE_LOCK:
        if _TABLE_CACHE.get(key) is not None:
            return True
        padded = table_pad(len(pub_bytes))
        target = _pubs_host(pub_bytes, padded)
        base = _find_incremental_base(target, padded, dev)
    if base is None:
        return False
    cand, diff = base
    t = _patch_from_base(cand, diff, target, powers, padded)
    if t is None:
        return False
    with _TABLE_LOCK:
        _TABLE_CACHE.put(key, t)
    return True


def table_for_pubs(pub_bytes: Sequence[bytes], powers=None,
                   device=None) -> ValsetTable:
    return table_for_pubs_info(pub_bytes, powers, device)[0]


# Per-valset front cache: consensus and blocksync hold ONE ValidatorSet
# object per height window, so the (pubs, powers) column extraction and
# content digest hoist out of the per-chunk path. Entries pin the set AND
# its validators list: update_with_change_set replaces the list wholesale,
# so a mutated set can never serve a stale table.
_VALSET_MEMO = tc.VALSET_MEMO


def table_for_valset(vals, device=None) -> ValsetTable:
    """The window table of a types.validator.ValidatorSet on `device`,
    memoized by set identity over the content-keyed LRU."""
    dev = resolve(device)
    mkey = (id(vals), str(dev))
    with _TABLE_LOCK:
        ent = _VALSET_MEMO.get(mkey)
        if ent is not None and ent[0] is vals \
                and ent[1] is vals.validators:
            _TABLE_STATS["valset_hits"] += 1
            return ent[2]
    pubs = tuple(v.pub_key.data for v in vals.validators)
    powers = tuple(v.voting_power for v in vals.validators)
    t = table_for_pubs(pubs, powers, dev)
    with _TABLE_LOCK:
        _TABLE_STATS["valset_misses"] += 1
        _VALSET_MEMO.put(mkey, (vals, vals.validators, t))
    return t


# --------------------------------------------------------------------------
# sharded tables (the verify plane over a slot mesh, parallel/mesh.py)
# --------------------------------------------------------------------------


class ShardedValsetTable:
    """One validator set's window table sharded over a slot mesh: slot d
    holds the table, ok bits, power limbs and raw keys of validators
    [d*m_shard, (d+1)*m_shard), each a tensor on slot d's device (`tab`,
    `ok`, `power5` and `pub_raw` are tuples by slot). m_shard is a
    table_pad bucket, which keeps the kernels' `column mod M -> validator`
    map intact on every slot. `devs` are the slots' indices."""

    __slots__ = ("tab", "ok", "power5", "m_shard", "n_dev", "pub_raw",
                 "devs")

    def __init__(self, tab, ok, power5, m_shard: int, n_dev: int,
                 pub_raw=None, devs=None):
        self.tab = tuple(tab)
        self.ok = tuple(ok)
        self.power5 = tuple(power5)
        self.m_shard = m_shard
        self.n_dev = n_dev
        self.pub_raw = None if pub_raw is None else tuple(pub_raw)
        self.devs = tuple(range(n_dev)) if devs is None else tuple(devs)

    @property
    def nbytes(self) -> int:
        """Device bytes over every slot (table_cache sizes it by this)."""
        return sum(int(t.nbytes) for part in (self.tab, self.ok, self.power5,
                                               self.pub_raw or ())
                   for t in part)


def shard_stride(n_vals: int, n_dev: int) -> int:
    """Per-slot table stride M_s for an n_vals valset over n_dev slots:
    the table_pad bucket of the per-shard slice. Validator v lives on
    slot v // M_s at local slot v % M_s; verifyplane/fused.plan_fused and
    the table build agree on it through this one function."""
    return table_pad(-(-max(n_vals, 1) // max(n_dev, 1)))


# (content key, mesh key) -> ShardedValsetTable, bounded (tc.SHARDS)
_SHARD_CACHE = tc.SHARDS


def sharded_table_for_pubs_info(pub_bytes: Sequence[bytes], powers,
                                mesh) -> Tuple[ShardedValsetTable, bool]:
    """The per-slot window tables for (valset, mesh), memoized like
    table_for_pubs: the content key rides the identity memo, so a steady
    sharded flush uploads nothing. Counted under shard_hits /
    shard_misses. Returns (table, warm), warm = a straight cache hit.

    Each slot's shard (padded to exactly m_s slots with dead b"" keys of
    power 0) is built on the slot's device by `build_table`, bypassing the
    single-device LRU, so a shard never serves a single-device lookup."""
    from cometbft_tpu_torch.parallel import mesh as pm

    key = (_memo_cache_key(pub_bytes, powers), pm._mesh_key(mesh))
    with _TABLE_LOCK:
        t = _SHARD_CACHE.get(key)
        if t is not None:
            _TABLE_STATS["shard_hits"] += 1
            # the warmer marks sharded builds apart from plain ones and
            # per mesh: each half's first post-rotation flush attributes
            # its own hit
            tc.consume_warmed((key[0], "shard", key[1]))
            return t, True
        _TABLE_STATS["shard_misses"] += 1
    n_dev = mesh.size
    m_s = shard_stride(len(pub_bytes), n_dev)
    tabs, oks, p5s, prs = [], [], [], []
    for d, slot in enumerate(mesh.slots):
        lo = d * m_s
        chunk = list(pub_bytes[lo:lo + m_s])
        chunk.extend(b"" for _ in range(m_s - len(chunk)))
        pw = None
        if powers is not None:
            pw = list(powers[lo:lo + m_s])
            pw.extend(0 for _ in range(m_s - len(pw)))
        st = build_table(chunk, pw, slot.device)
        tabs.append(st.tab)
        oks.append(st.ok)
        p5s.append(st.power5)
        prs.append(st.pub_raw)
    t = ShardedValsetTable(tabs, oks, p5s, m_s, n_dev, prs, mesh.indices)
    with _TABLE_LOCK:
        _SHARD_CACHE.put(key, t)
    return t, False


def sharded_table_for_pubs(pub_bytes: Sequence[bytes], powers,
                           mesh) -> ShardedValsetTable:
    return sharded_table_for_pubs_info(pub_bytes, powers, mesh)[0]


def base60_repl(mesh) -> tuple:
    """The [S]B comb table on each slot's device, the sharded steps'
    `base` argument (`ed25519_fused.base_table`, uploaded once a
    device)."""
    return tuple(kf.base_table(s.device) for s in mesh.slots)


# --------------------------------------------------------------------------
# ed25519_verify_cached: kernel wrapper and plain version
# --------------------------------------------------------------------------


_INV2 = (ref.P + 1) // 2


def _niels_point(ent: torch.Tensor):
    """(..., 3, 10) niels entries {y+x, y-x, 2dxy} -> extended points
    (x, y, 1, xy) in 13-bit limbs."""
    ypx = limbs25_to_13(ent[..., 0, :])
    ymx = limbs25_to_13(ent[..., 1, :])
    inv2 = fe.const(_INV2, ent.device)
    x = fe.mul(fe.sub(ypx, ymx), inv2)
    y = fe.mul(fe.add(ypx, ymx), inv2)
    return (x, y, torch.zeros_like(x) + fe.const(1, ent.device),
            fe.mul(x, y))


def ed25519_verify_cached_plain(rows: torch.Tensor, tab: torch.Tensor,
                                ok: torch.Tensor, points: torch.Tensor):
    """Plain PyTorch version of the cached verify kernel: (>= V_KROWS, B)
    int32 rows, the (M * 128, 3, 10) table, (M,) ok bits and the (32, 256,
    4, NLIMBS) comb table -> (B,) int32 verdicts."""
    r = rows[:V_KROWS].to(torch.int64)
    B = r.shape[1]
    dev = rows.device
    v = torch.arange(B, device=dev) % ok.shape[0]
    w = r[V_RY:V_RY + 10]
    ry = torch.cat([w & _M13, (w >> 13) & _M13]).T.contiguous()
    s8 = torch.cat([(r[V_S8:V_S8 + 8] >> (8 * k)) & 255
                    for k in range(4)]).T.contiguous()  # (B, 32)
    h4 = torch.cat([(r[V_H4:V_H4 + 8] >> (4 * k)) & 15
                    for k in range(8)]).T.contiguous()  # (B, 64)
    flags = r[V_FLAGS]
    R, ok_r = curve.decompress(ry, flags & 1)
    acc = curve.identity(B, dev)
    for wi in range(NW - 1, -1, -1):
        if wi != NW - 1:
            acc = curve.double(curve.double(curve.double(curve.double(acc))))
        for j in range(NJ):
            ent = tab[v * ENT_PER_VAL + j * NENT + h4[:, NW * j + wi]]
            acc = curve.add(acc, _niels_point(ent))
    W = curve.add(curve.add(acc, curve.base_scalar_mul(s8, points)),
                  curve.neg(R))
    W8 = curve.double(curve.double(curve.double(W)))
    valid = (curve.is_identity(W8) & ok_r & (((flags >> 1) & 1) != 0)
             & ok[v])
    return valid.to(torch.int32)


def _check_table(tab: torch.Tensor, ok: torch.Tensor) -> int:
    M = ok.shape[0]
    _check(ok, "ok", torch.bool, (M,))
    _check(tab, "tab", torch.int32, (M * ENT_PER_VAL, 3, 10))
    return M


# The C entries of csrc/ed25519_cached_verify.cu: a quad of four threads a
# column, and one thread a column.
VERIFY_CACHED_ENTRIES = {"quad": "cbt_ed25519_verify_cached",
                         "thread": "cbt_ed25519_verify_cached_thread"}

# The wrapper launches the quad entry up to this many columns an SM, and the
# one-thread entry above. From chip_smoke.py's sweep of both entries over
# the stream chunk's column prefixes (M = 1,024; device time on one NVIDIA
# H100 80GB HBM3 at 700.00 W, 132 SMs), quad / one-thread ms: 0.249 / 0.584
# at 8,192 columns, 0.331 / 0.585 at 10,240, 0.576 / 0.583 at 16,384 (124
# an SM), 0.877 / 0.794 at 32,768 and 1.783 / 1.571 at 65,536. Below the
# crossover the one-thread kernel leaves SMs idle; above it every SM is
# full and the quad's extra instructions a column cost more than its
# shorter chain saves.
QUAD_MAX_COLS_PER_SM = 124


def verify_cached_entry(B: int, sms: int) -> str:
    """The entry the wrapper launches for B columns on a card of `sms`
    SMs: "quad" up to QUAD_MAX_COLS_PER_SM columns an SM, else "thread"."""
    return "quad" if B <= QUAD_MAX_COLS_PER_SM * sms else "thread"


def sm_count(dev: torch.device) -> int:
    """The streaming multiprocessors of CUDA device `dev`."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def launch_verify_cached(rows: torch.Tensor, tab: torch.Tensor,
                         ok: torch.Tensor, entry: str) -> torch.Tensor:
    """One launch of the cached verify entry `entry` on CUDA operands the
    wrapper has checked; counts nothing."""
    from cometbft_tpu_torch.ops import _build

    dev = rows.device
    fn = getattr(_build.kernel_lib("ed25519_cached_verify.cu"),
                 VERIFY_CACHED_ENTRIES[entry])
    base = kf.base_table(dev)
    B = rows.shape[1]
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rows.data_ptr(), B, tab.data_ptr(), ok.shape[0],
                 ok.data_ptr(), base.data_ptr(), out.data_ptr(), stream)
    kf._raise_on(err, "ed25519_verify_cached")
    return out


def ed25519_verify_cached(rows: torch.Tensor, tab: torch.Tensor,
                          ok: torch.Tensor) -> torch.Tensor:
    """(>= V_KROWS, B) int32 cached packed rows + a valset table's (tab,
    ok) -> (B,) int32 verdicts (1 valid), column b against validator
    b mod M.

    CUDA tensors launch csrc/ed25519_cached_verify.cu with the niels comb
    table (`ed25519_fused.base_table`), the entry `verify_cached_entry`
    names; CPU tensors run `ed25519_verify_cached_plain`."""
    kf._check_rows(rows, V_KROWS)
    _check_table(tab, ok)
    dev = rows.device
    if dev.type == "cpu" and tab.device == dev and ok.device == dev:
        return ed25519_verify_cached_plain(rows, tab, ok,
                                           kf.base_points(dev))
    _kernel_device(dev, "ed25519_verify_cached", tab, ok)
    out = launch_verify_cached(
        rows, tab, ok, verify_cached_entry(rows.shape[1], sm_count(dev)))
    ed25519_verify_cached.launches += 1
    return out


ed25519_verify_cached.launches = 0


# Field multiplications and squarings of one cached column that runs to
# its end in csrc/ed25519_cached.cuh `verify_column_cached`: one
# decompression (8M + 4S and a 251S + 11M power chain), 7 windows of
# 3 doublings at 3M + 4S and one at 4M + 4S, 64 + 32 mixed adds of 7M, the
# -R conversion and cached add (1M + 8M) and 3 cofactor doublings. A
# decompression that takes the sqrt(-1) branch adds one multiplication.
VERIFY_CACHED_FE_MULS = 800
VERIFY_CACHED_FE_SQUARES = 379


def verify_cached_products_per_signature() -> int:
    """32 x 32 -> 64 bit limb products of one cached verification."""
    return VERIFY_CACHED_FE_MULS * 100 + VERIFY_CACHED_FE_SQUARES * 55


# --------------------------------------------------------------------------
# tally_quorum_cached: kernel wrapper and plain version
# --------------------------------------------------------------------------


def _thresh_from_rows(rows: torch.Tensor, n_commits: int) -> torch.Tensor:
    """The per-commit thresholds packed into the trailing rows,
    zero-padded when the slice is short."""
    flat = rows[V_THRESH:].reshape(-1)
    need = n_commits * ek.TALLY_LIMBS
    if flat.numel() < need:
        flat = torch.nn.functional.pad(flat, (0, need - flat.numel()))
    return flat[:need].reshape(n_commits, ek.TALLY_LIMBS)


def tally_quorum_cached_plain(valid: torch.Tensor, rows: torch.Tensor,
                              power5: torch.Tensor, n_commits: int):
    """Plain PyTorch version of the cached tally: (B,) verdicts, packed
    rows and the table's (M, 5) power limbs -> ((n_commits, 6) int32
    tally, (n_commits,) bool quorum)."""
    B = rows.shape[1]
    flags = rows[V_FLAGS].to(torch.int64)
    pw = power5[torch.arange(B, device=rows.device) % power5.shape[0]]
    tally = ek.tally_core(valid != 0, pw, ((flags >> 2) & 1) != 0,
                          flags >> 3, n_commits)
    return tally, ek.quorum_core(tally, _thresh_from_rows(rows, n_commits))


def tally_quorum_cached(valid: torch.Tensor, rows: torch.Tensor,
                        power5: torch.Tensor, n_commits: int):
    """Per-commit tally over valid, counted columns of the cached layout
    (power of column b is power5[b mod M]) and the quorum bit
    (tally > threshold). CUDA tensors launch the cached entry of
    csrc/tally_quorum.cu (one memset of its scratch, one kernel); CPU
    tensors run `tally_quorum_cached_plain`.

    Precondition, not checked here: every limb of power5 is below 2^13,
    as `ek.power_limbs` makes them where a table's power5 is built or
    patched. On larger limbs the kernel's int32 sums wrap as the JAX
    package's do, and the plain version's int64 sums do not."""
    kf._check_rows(rows, V_THRESH + 1)
    B = rows.shape[1]
    _check(valid, "valid", torch.int32, (B,))
    M = power5.shape[0]
    _check(power5, "power5", torch.int32, (M, ek.POWER_LIMBS))
    if M < 1:
        raise ValueError("power5 holds no validator")
    if n_commits * ek.TALLY_LIMBS > (rows.shape[0] - V_THRESH) * B:
        raise ValueError("rows hold fewer thresholds than n_commits")
    if B > (1 << 17):
        raise ValueError("B > 2^17 could overflow the int32 limb sums")
    dev = rows.device
    if dev.type == "cpu" and valid.device == dev and power5.device == dev:
        return tally_quorum_cached_plain(valid, rows, power5, n_commits)
    _kernel_device(dev, "tally_quorum_cached", valid, power5)
    from cometbft_tpu_torch.ops import _build

    fn = _build.kernel_lib("tally_quorum.cu").cbt_tally_quorum_cached
    tally, quorum, scratch = kf.tally_outputs(n_commits, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(valid.data_ptr(), rows.data_ptr(), B, power5.data_ptr(), M,
                 n_commits, scratch.data_ptr(), tally.data_ptr(),
                 quorum.data_ptr(), stream)
    kf._raise_on(err, "tally_quorum_cached")
    tally_quorum_cached.launches += 1
    return tally, quorum


tally_quorum_cached.launches = 0


# --------------------------------------------------------------------------
# host packing + entry points
# --------------------------------------------------------------------------


def packed_rows_shape(B: int, n_commits: int = 1) -> tuple:
    """Shape of the packed (R, B) array pack_rows_cached builds for a
    B-row batch carrying n_commits thresholds. Staging buffers handed to
    pack_rows_cached(out=...) must be sized through this."""
    t_rows = max(1, -(-(n_commits * ek.TALLY_LIMBS) // B))
    return (V_THRESH + t_rows, B)


def pack_rows_cached(pb, counted=None, commit_ids=None,
                     thresh=None, out=None) -> np.ndarray:
    """PackedBatch -> one compact (R, B) int32 array for the cached path,
    byte for byte the JAX package's layout. Callers lay commits out in
    valset order padded to the table stride (row b is validator b mod M).
    `out` (optional) is a preallocated zeroed (R, B) int32 staging
    buffer."""
    B = pb.ry.shape[0]
    if thresh is None:
        thresh = np.zeros((1, ek.TALLY_LIMBS), np.int32)
    tvals = np.asarray(thresh, np.int32).reshape(-1)
    t_rows = max(1, -(-tvals.size // B))
    if out is not None and out.shape == (V_THRESH + t_rows, B) \
            and out.dtype == np.int32:
        rows = out
    else:
        rows = np.zeros((V_THRESH + t_rows, B), np.int32)
    ry = np.asarray(pb.ry, np.int32)
    rows[V_RY:V_RY + 10] = (ry[:, :10] | (ry[:, 10:] << 13)).T
    s8 = (pb.sdig[:, 0::2] + 16 * pb.sdig[:, 1::2]).astype(np.int32)
    acc = np.zeros((B, 8), np.int32)
    for k in range(4):
        acc |= s8[:, 8 * k:8 * k + 8] << (8 * k)
    rows[V_S8:V_S8 + 8] = acc.T
    acc = np.zeros((B, 8), np.int32)
    h4 = np.asarray(pb.hdig, np.int32)
    for k in range(8):
        acc |= h4[:, 8 * k:8 * k + 8] << (4 * k)
    rows[V_H4:V_H4 + 8] = acc.T
    flags = (pb.rsign.astype(np.int32)
             | (pb.precheck.astype(np.int32) << 1))
    if counted is not None:
        flags = flags | (np.asarray(counted, np.int32) << 2)
    if commit_ids is not None:
        flags = flags | (np.asarray(commit_ids, np.int32) << 3)
    rows[V_FLAGS] = flags
    flat = rows[V_THRESH:].reshape(-1)
    flat[: tvals.size] = tvals
    return rows


def pad_rows(n: int) -> int:
    """Batch padding for the cached path: fine-grained buckets (multiples
    of 2048 above 4096). Always >= B_TILE and a multiple of it."""
    n = max(n, 1)
    for b in (128, 256, 512, 1024, 2048, 4096):
        if n <= b:
            return b
    if n > 65536:
        raise ValueError(f"batch of {n} exceeds max bucket 65536")
    return -(-n // 2048) * 2048


def verify_tally_rows_cached(rows, table: ValsetTable, n_commits: int):
    """Fused verify + tally from one packed (R, B) int32 array (numpy or
    tensor) on the table's device: one upload, two kernels, three outputs
    (valid (B,) bool, tally (C, 6) int32, quorum (C,) bool). The table's
    tensors are long-lived caches and are only read."""
    r = kf._to_device(rows, table.device)
    verdicts = ed25519_verify_cached(r, table.tab, table.ok)
    tally, quorum = tally_quorum_cached(verdicts, r, table.power5, n_commits)
    return verdicts != 0, tally, quorum


def verify_rows_cached(rows, table: ValsetTable) -> torch.Tensor:
    """(R, B) packed rows -> (B,) bool validity (the verify kernel only:
    no tally is computed)."""
    r = kf._to_device(rows, table.device)
    return ed25519_verify_cached(r, table.tab, table.ok) != 0


def verify_batch_cached(pub_bytes, msgs, sigs,
                        table: Optional[ValsetTable] = None,
                        device=None) -> np.ndarray:
    """Drop-in verify_batch where row i's key is pub_bytes[i]; builds (or
    LRU-reuses) the valset table for the key list on `device`, in the
    `dispatch` stage (crypto/batch.py `stage`)."""
    n = len(pub_bytes)
    if table is None:
        with cbatch.stage("dispatch"):
            table = table_for_pubs(pub_bytes, device=device)
    with cbatch.stage("pack"):
        rows = pack_rows_cached(ek.pack_batch(pub_bytes, msgs, sigs,
                                              pad_to=pad_rows(n)))
    with cbatch.stage("dispatch"):
        valid = verify_rows_cached(rows, table)
    with cbatch.stage("wait"):
        return valid.cpu().numpy()[:n]


verify_batch_cached.cols = pad_rows


STAMP_NAMES = ("TemplateEntry", "template_entry", "warm_template",
               "stamp_rows_cached", "verify_tally_delta_cached")


def __getattr__(name: str):
    # ops/ed25519_stamp.py imports this module, so its names resolve at
    # first use
    if name in STAMP_NAMES:
        from cometbft_tpu_torch.ops import ed25519_stamp

        return getattr(ed25519_stamp, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
