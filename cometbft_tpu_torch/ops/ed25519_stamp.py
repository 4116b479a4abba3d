"""Device-side sign-bytes stamping of packed rows from per-row deltas.

Counterpart of the stamping half of the JAX package's
ops/ed25519_cached.py. A chunk whose rows all stamp ships per-row deltas
(64 B signature + 12 B timestamp words + 4 B flags) and a device-resident
template per height, instead of packed rows: the `stamp_rows` kernel
(csrc/stamp_rows.cu) rebuilds the EXACT packed rows of
`ed25519_cached.pack_rows_cached` on the device. It LEB128-stamps the
timestamp varints into the canonical sign-bytes (the layout of
types/canonical.VoteRowTemplate.patch_rows), hashes R || A || msg with
SHA-512, reduces the digest mod L and assembles the row layout. The rows
never exist on the host; they go straight to the cached verify kernel.

`stamp_rows_general` does the same for a chunk of mixed validator sets,
which the JAX package packs on the host: its deltas also carry each row's
32 B key and 8 B power, and it writes the EXACT rows of
`ed25519_fused.pack_rows` over a host pack (the general layout, with the
key's limbs, the power and the commit id), which go straight to the
general verify and tally kernels.

`stamp_rows_plain` and `stamp_rows_general_plain` are the plain PyTorch
versions, taken only for CPU tensors; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.device import resolve
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import table_cache as tc

V_RY, V_S8, V_H4, V_FLAGS, V_THRESH = (ec.V_RY, ec.V_S8, ec.V_H4,
                                       ec.V_FLAGS, ec.V_THRESH)


class TemplateEntry:
    """Device-resident encoded stamp templates for one chunk family: a row
    per StampSite (prefix bytes, suffix bytes, timestamp tag, lengths),
    padded to bucketed shapes. Cached in table_cache.TEMPLATES under the
    sites' content key and the device; a caller holding an entry keeps
    its tensors alive across an evict."""

    __slots__ = ("key", "pre_mat", "pre_len", "suf_mat", "suf_len",
                 "ts_tag", "n_sites", "msg_max", "nbytes")


MAX_TEMPLATE_SITES = 256  # the template id rides 8 bits of the flags

# 32-bit integer instructions of one SHA-512 compression in
# csrc/stamp_core.cuh `sha512_compress`, the stamp kernel's bound, with
# three-input logic and adds (LOP3, IADD3) taken at their best: a 64-bit
# rotate or shift is 2 funnel shifts, a 64-bit add of up to 3 operands 2
# adds, a logic function of up to 3 words one LOP3 a half. A round:
# Sigma1 and Sigma0 3 rotates and a 3-way xor each (8 + 8), ch and maj one
# LOP3 each (2 + 2), t1 a 5-operand add (4), e and a (2 + 2): 28. A
# schedule step (t >= 16): sigma0 and sigma1 2 rotates, a shift and a
# 3-way xor each (8 + 8), w a 4-operand add (4): 20. The feed-forward: 8
# adds (16). The 64-bit operations as written, two-input, are 2,920 a
# block (5,840 32-bit ones). The mod-L reduction, the varints and the row
# assembly are left out, so the bound is below the work.
SHA512_OPS_PER_BLOCK = 80 * 28 + 64 * 20 + 16


def sha512_blocks(msg_len: int) -> int:
    """SHA-512 blocks of R || A || msg for a sign-bytes row of msg_len."""
    return (64 + msg_len + 17 + 127) // 128


def _bucket_up(n: int, q: int) -> int:
    return -(-max(int(n), 1) // q) * q


def template_entry(sites, device=None) -> TemplateEntry:
    """The device template tensors for a tuple of canonical.StampSite, via
    the bounded template cache (template_hits/template_misses in
    table_cache_stats()). Shapes bucket as in the JAX package: pre/suf
    widths to 32 bytes, site count to a power of two, worst-case row
    length to 64. Raises ValueError for an empty or oversized site list."""
    sites = tuple(sites)
    if not 0 < len(sites) <= MAX_TEMPLATE_SITES:
        raise ValueError(
            f"{len(sites)} stamp sites (max {MAX_TEMPLATE_SITES})")
    dev = resolve(device)
    key = (tuple(s.key for s in sites), str(dev))
    with tc.LOCK:
        ent = tc.TEMPLATES.get(key)
        if ent is not None:
            tc.STATS["template_hits"] += 1
            tc.consume_warmed(("template",) + key)
            return ent
        tc.STATS["template_misses"] += 1
    t_pad = 1
    while t_pad < len(sites):
        t_pad *= 2
    pm = _bucket_up(max(s.pre.size for s in sites), 32)
    sm = _bucket_up(max(s.suf.size for s in sites), 32)
    pre = np.zeros((t_pad, pm), np.uint8)
    suf = np.zeros((t_pad, sm), np.uint8)
    pl = np.zeros((t_pad,), np.int32)
    sl = np.zeros((t_pad,), np.int32)
    tg = np.zeros((t_pad,), np.int32)
    for i, s in enumerate(sites):
        pre[i, : s.pre.size] = s.pre
        suf[i, : s.suf.size] = s.suf
        pl[i] = s.pre.size
        sl[i] = s.suf.size
        tg[i] = s.ts_tag
    ent = TemplateEntry()
    ent.key = key
    ent.pre_mat = torch.from_numpy(pre).to(dev)
    ent.pre_len = torch.from_numpy(pl).to(dev)
    ent.suf_mat = torch.from_numpy(suf).to(dev)
    ent.suf_len = torch.from_numpy(sl).to(dev)
    ent.ts_tag = torch.from_numpy(tg).to(dev)
    ent.n_sites = len(sites)
    ent.msg_max = _bucket_up(max(s.max_len for s in sites), 64)
    ent.nbytes = sum(int(a.nbytes) for a in
                     (ent.pre_mat, ent.pre_len, ent.suf_mat,
                      ent.suf_len, ent.ts_tag))
    with tc.LOCK:
        tc.TEMPLATES.put(key, ent)
    return ent


def warm_template(sites, device=None) -> bool:
    """A warmer's template pre-build: builds AND marks only when the
    entry is absent (a mark for an entry already cached would fake a
    warmed hit). Returns True when a build actually happened."""
    sites = tuple(sites)
    key = (tuple(s.key for s in sites), str(resolve(device)))
    with tc.LOCK:
        if key in tc.TEMPLATES:
            return False
    template_entry(sites, device)
    tc.note_warmed(("template",) + key)
    return True


# --------------------------------------------------------------------------
# stamp_rows: plain version
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF

_SHA512_K = (
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f,
    0xe9b5dba58189dbbc, 0x3956c25bf348b538, 0x59f111f1b605d019,
    0x923f82a4af194f9b, 0xab1c5ed5da6d8118, 0xd807aa98a3030242,
    0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235,
    0xc19bf174cf692694, 0xe49b69c19ef14ad2, 0xefbe4786384f25e3,
    0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65, 0x2de92c6f592b0275,
    0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f,
    0xbf597fc7beef0ee4, 0xc6e00bf33da88fc2, 0xd5a79147930aa725,
    0x06ca6351e003826f, 0x142929670a0e6e70, 0x27b70a8546d22ffc,
    0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6,
    0x92722c851482353b, 0xa2bfe8a14cf10364, 0xa81a664bbc423001,
    0xc24b8b70d0f89791, 0xc76c51a30654be30, 0xd192e819d6ef5218,
    0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99,
    0x34b0bcb5e19b48a8, 0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb,
    0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3, 0x748f82ee5defb2fc,
    0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915,
    0xc67178f2e372532b, 0xca273eceea26619c, 0xd186b8c721c0c207,
    0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178, 0x06f067aa72176fba,
    0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc,
    0x431d67c49c100d4c, 0x4cc5d4becb3e42b6, 0x597f299cfc657e2a,
    0x5fcb6fab3ad6faec, 0x6c44198c4a475817,
)
_SHA512_H0 = (
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
    0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
    0x1f83d9abfb41bd6b, 0x5be0cd19137e2179,
)
_L_U32 = tuple((ek.ref.L >> (32 * k)) & _M32 for k in range(8))

# 64-bit words as (hi, lo) pairs of int64 tensors holding 32-bit values,
# so no operation overflows int64


def _shl32(x, k: int):
    return (x & ((1 << (32 - k)) - 1)) << k


def _rotr(h, lo, n: int):
    if n == 32:
        return lo, h
    if n > 32:
        h, lo, n = lo, h, n - 32
    return ((h >> n) | _shl32(lo, 32 - n), (lo >> n) | _shl32(h, 32 - n))


def _shr(h, lo, n: int):
    return h >> n, (lo >> n) | _shl32(h, 32 - n)


def _xor3(a, b, c):
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def _add(*xs):
    hi, lo = xs[0]
    for h2, l2 in xs[1:]:
        lo = lo + l2
        hi = hi + h2 + (lo >> 32)
        lo = lo & _M32
        hi = hi & _M32
    return hi, lo


def _sha512(data: torch.Tensor, nblk_row: torch.Tensor, nblk: int):
    """SHA-512 of each row of (B, nblk * 128) int64 bytes that already hold
    their padding and length; row b absorbs its first nblk_row[b] blocks.
    Returns the 8 state words as (hi, lo) pairs."""
    B = data.shape[0]
    dev = data.device
    state = [(torch.full((B,), c >> 32, dtype=torch.int64, device=dev),
              torch.full((B,), c & _M32, dtype=torch.int64, device=dev))
             for c in _SHA512_H0]
    for j in range(nblk):
        blk = data[:, j * 128:(j + 1) * 128]
        w = []
        for t in range(16):
            b = [blk[:, 8 * t + k] for k in range(8)]
            w.append(((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3],
                      (b[4] << 24) | (b[5] << 16) | (b[6] << 8) | b[7]))
        for t in range(16, 80):
            s0 = _xor3(_rotr(*w[t - 15], 1), _rotr(*w[t - 15], 8),
                       _shr(*w[t - 15], 7))
            s1 = _xor3(_rotr(*w[t - 2], 19), _rotr(*w[t - 2], 61),
                       _shr(*w[t - 2], 6))
            w.append(_add(w[t - 16], s0, w[t - 7], s1))
        a, b, c, d, e, f, g, h = state
        for t in range(80):
            s1 = _xor3(_rotr(*e, 14), _rotr(*e, 18), _rotr(*e, 41))
            ch = ((e[0] & f[0]) ^ (~e[0] & _M32 & g[0]),
                  (e[1] & f[1]) ^ (~e[1] & _M32 & g[1]))
            k = (_SHA512_K[t] >> 32, _SHA512_K[t] & _M32)
            t1 = _add(h, s1, ch, k, w[t])
            s0 = _xor3(_rotr(*a, 28), _rotr(*a, 34), _rotr(*a, 39))
            maj = ((a[0] & b[0]) ^ (a[0] & c[0]) ^ (b[0] & c[0]),
                   (a[1] & b[1]) ^ (a[1] & c[1]) ^ (b[1] & c[1]))
            h, g, f, e = g, f, e, _add(d, t1)
            d, c, b, a = c, b, a, _add(t1, s0, maj)
        act = nblk_row > j
        state = [tuple(torch.where(act, n, o) for n, o in
                       zip(_add(s, x), s))
                 for s, x in zip(state, (a, b, c, d, e, f, g, h))]
    return state


def _sc_reduce_nibbles(dig):
    """64 little-endian digest byte columns (B,) -> the 64 base-16 digits
    of (digest mod L): ref10's sc_reduce over 21-bit limbs in int64."""
    pad = list(dig) + [torch.zeros_like(dig[0])] * 3
    s = []
    for i in range(24):
        j, sh = divmod(21 * i, 8)
        x = pad[j] | (pad[j + 1] << 8) | (pad[j + 2] << 16) | (
            pad[j + 3] << 24)
        s.append(x >> sh if i == 23 else (x >> sh) & 0x1FFFFF)

    def fold(i):
        v = s[i]
        for k, c in enumerate((666643, 470296, 654183, -997805, 136657,
                               -683901)):
            s[i - 12 + k] = s[i - 12 + k] + v * c
        s[i] = torch.zeros_like(v)

    def carry(i, rounded):
        c = (s[i] + (1 << 20)) >> 21 if rounded else s[i] >> 21
        s[i + 1] = s[i + 1] + c
        s[i] = s[i] - c * (1 << 21)

    for i in range(23, 17, -1):
        fold(i)
    for i in list(range(6, 17, 2)) + list(range(7, 16, 2)):
        carry(i, True)
    for i in range(17, 11, -1):
        fold(i)
    for i in list(range(0, 11, 2)) + list(range(1, 12, 2)):
        carry(i, True)
    fold(12)
    for i in range(12):
        carry(i, False)
    fold(12)
    for i in range(11):
        carry(i, False)
    nibs = []
    for t in range(64):
        i, off = divmod(4 * t, 21)
        v = s[i] >> off
        if off > 17:
            v = v | (s[i + 1] << (21 - off))
        nibs.append(v & 15)
    return nibs


def _leb_pack(gs):
    """7-bit groups (lsb first) -> (LEB128 bytes, lengths): length = last
    nonzero group + 1 (min 1), continuation bit on every byte before the
    last."""
    g = torch.stack(gs, 1)
    idx = torch.arange(1, g.shape[1] + 1, device=g.device)
    lens = torch.clamp(torch.where(g != 0, idx, 0).amax(1), min=1)
    cont = idx[None, :] < lens[:, None]
    return g | torch.where(cont, 0x80, 0), lens


def _uvarint64(lo, hi):
    """(B,) unsigned 32-bit lo/hi words of a 64-bit two's-complement value
    -> ((B, 10) LEB128 bytes, (B,) lengths)."""
    gs = []
    for j in range(10):
        s = 7 * j
        if s + 7 <= 32:
            g = lo >> s
        elif s < 32:
            g = (lo >> s) | _shl32(hi, 32 - s)
        else:
            g = hi >> (s - 32)
        gs.append(g & 0x7F)
    return _leb_pack(gs)


def _digest_nibbles(sg, t64, a_row, tmpl, pre_mat, pre_len, suf_mat,
                    suf_len, ts_tag, msg_max: int):
    """The 64 base-16 digits of h = SHA-512(R || A || msg) mod L of each
    row: sg the (B, 64) signature bytes, a_row the (B, 32) key bytes, t64
    the (B, 3) timestamp words and msg the sign-bytes of template row tmpl
    with that timestamp (all int64)."""
    B = sg.shape[0]
    dev = sg.device
    pm = pre_mat.shape[1]

    # timestamp varints + proto3 zero-skip lengths (patch_rows math)
    lo, hi = t64[:, 0] & _M32, t64[:, 1] & _M32
    sb, sl = _uvarint64(lo, hi)
    nb, nl = _uvarint64(t64[:, 2] & _M32, (t64[:, 2] >> 31) & _M32)
    s_nz = ((lo | hi) != 0).to(torch.int64)
    n_nz = (t64[:, 2] != 0).to(torch.int64)
    ts_len = torch.where(s_nz != 0, sl + 1, 0) + torch.where(
        n_nz != 0, nl + 1, 0)
    p_row = pre_len.to(torch.int64)[tmpl]
    s_row = suf_len.to(torch.int64)[tmpl]
    body_len = p_row + 2 + ts_len + s_row
    ob, ol = _leb_pack([(body_len >> (7 * j)) & 0x7F for j in range(5)])
    total = ol + body_len

    # one gather assembles every row from a per-row source vector via
    # piecewise boundaries (the segment layout of patch_rows)
    src = torch.cat([
        ob,                                              # +0  outer varint
        pre_mat.to(torch.int64)[tmpl],                   # +5
        ts_tag.to(torch.int64)[tmpl][:, None],           # +5+pm
        ts_len[:, None],                                 # +6+pm
        torch.full((B, 1), 0x08, dtype=torch.int64, device=dev),
        sb,                                              # +8+pm
        torch.full((B, 1), 0x10, dtype=torch.int64, device=dev),
        nb,                                              # +19+pm
        suf_mat.to(torch.int64)[tmpl],                   # +20+pm
        torch.zeros((B, 1), dtype=torch.int64, device=dev),
    ], 1)
    o_pre, o_tag = 5, 5 + pm
    o_tsl, o_t08, o_sb = o_tag + 1, o_tag + 2, o_tag + 3
    o_t10, o_nb = o_sb + 10, o_sb + 11
    o_suf = o_nb + 10
    o_z = o_suf + suf_mat.shape[1]
    bnd = [ol]
    for step in (p_row, 1, 1, s_nz, sl * s_nz, n_nz, nl * n_nz, s_row):
        bnd.append(bnd[-1] + step)
    b0, b1, b2, b3, b4, b5, b6, b7, b8 = [x[:, None] for x in bnd]
    p = torch.arange(msg_max, device=dev)[None, :]
    idx = torch.where(p < b0, p,
          torch.where(p < b1, o_pre + (p - b0),
          torch.where(p < b2, o_tag,
          torch.where(p < b3, o_tsl,
          torch.where(p < b4, o_t08,
          torch.where(p < b5, o_sb + (p - b4),
          torch.where(p < b6, o_t10,
          torch.where(p < b7, o_nb + (p - b6),
          torch.where(p < b8, o_suf + (p - b7), o_z)))))))))
    msg = torch.gather(src, 1, idx)

    # padded SHA-512 input: R || A || msg || 0x80 || 0* || 128-bit length
    nblk = (64 + msg_max + 17 + 127) // 128
    width = nblk * 128
    data = torch.cat([sg[:, :32], a_row, msg,
                      torch.zeros((B, width - 64 - msg_max),
                                  dtype=torch.int64, device=dev)], 1)
    pos = torch.arange(width, device=dev)[None, :]
    tm = (64 + total)[:, None]
    data = data | torch.where(pos == tm, 0x80, 0)
    nblk_row = (tm + 17 + 127) // 128
    rel = pos - (nblk_row * 128 - 8)
    bits = tm * 8
    sh = torch.clamp((7 - rel) * 8, 0, 56)
    data = data | torch.where((rel >= 0) & (rel < 8), (bits >> sh) & 0xFF, 0)
    st = _sha512(data, nblk_row[:, 0], nblk)
    dig = []
    for hi_w, lo_w in st:
        for w in (hi_w, lo_w):
            dig += [(w >> (24 - 8 * k)) & 0xFF for k in range(4)]
    return _sc_reduce_nibbles(dig)


def _word(parts):
    """Digits packed low to high into one 32-bit word."""
    acc = torch.zeros_like(parts[0])
    for k, x in enumerate(parts):
        acc = acc | (x << (32 // len(parts) * k))
    return acc


def _limb_pairs(enc, live):
    """(B, 32) int64 bytes of a point encoding -> the 10 rows of its y's
    13-bit limbs (the top bit dropped), limb i | limb i+10 << 13."""
    rb = [enc[:, k] for k in range(32)] + [torch.zeros_like(live)] * 3
    rb[31] = rb[31] & 0x7F
    rl = []
    for i in range(20):
        j, r = divmod(13 * i, 8)
        win = rb[j] | (rb[j + 1] << 8) | (rb[j + 2] << 16)
        rl.append((win >> r) & 0x1FFF)
    return [(rl[i] | (rl[i + 10] << 13)) * live for i in range(10)]


def _scalar_rows(sg, nibs, live):
    """(s8 rows, h4 rows, precheck): S's byte digits and h's nibbles, 8
    rows each (row j holds digit j, 8 + j, ...), and S < L."""
    h4 = [_word([nibs[8 * k + j] for k in range(8)]) * live
          for j in range(8)]
    s8 = [_word([sg[:, 32 + 8 * k + j] for k in range(4)]) * live
          for j in range(8)]
    lt = torch.zeros_like(live, dtype=torch.bool)
    dec = torch.zeros_like(lt)
    for k in range(7, -1, -1):
        wk = (sg[:, 32 + 4 * k] | (sg[:, 33 + 4 * k] << 8)
              | (sg[:, 34 + 4 * k] << 16) | (sg[:, 35 + 4 * k] << 24))
        lt = lt | (~dec & (wk < _L_U32[k]))
        dec = dec | (wk != _L_U32[k])
    return s8, h4, lt.to(torch.int64) * live


def _rows(head, thr, t_rows: int):
    """The head rows (int64 words) as int32 bit patterns over the
    thresholds laid flat on t_rows rows."""
    head = torch.stack(head)
    B = head.shape[1]
    head = ((head + (1 << 31)) & _M32) - (1 << 31)
    flat = thr.reshape(-1).to(torch.int64)
    flat = torch.nn.functional.pad(flat, (0, t_rows * B - flat.numel()))
    return torch.cat([head, flat.reshape(t_rows, B)]).to(torch.int32)


def _flag_fields(flags, n_sites: int):
    """(live, counted, template row, commit id) of (B,) flags words."""
    f = flags.to(torch.int64)
    return (f & 1, (f >> 1) & 1, torch.clamp((f >> 2) & 0xFF, max=n_sites - 1),
            f >> 10)


def stamp_rows_plain(sig, ts, flags, pre_mat, pre_len, suf_mat, suf_len,
                     ts_tag, pub_raw, thr, msg_max: int, t_rows: int):
    """Plain PyTorch version of the stamp kernel: per-row deltas, the
    template tensors and the (M, 32) uint8 pubkeys -> the (V_THRESH +
    t_rows, B) int32 packed rows, bit-identical to pack_rows_cached over a
    host pack of the expanded batch. Dead lanes (live = 0) give zero
    columns; thr is the (n_commits, TALLY_LIMBS) threshold matrix."""
    B = sig.shape[0]
    live, counted, tmpl, cid = _flag_fields(flags, pre_mat.shape[0])
    sg = sig.to(torch.int64)
    a_row = pub_raw.to(torch.int64)[torch.arange(B, device=sig.device)
                                    % pub_raw.shape[0]]
    nibs = _digest_nibbles(sg, ts.to(torch.int64), a_row, tmpl, pre_mat,
                           pre_len, suf_mat, suf_len, ts_tag, msg_max)
    s8, h4, precheck = _scalar_rows(sg, nibs, live)
    f_row = ((sg[:, 31] >> 7) * live | (precheck << 1)
             | ((counted * live) << 2) | ((cid * live) << 3))
    return _rows(_limb_pairs(sg[:, :32], live) + s8 + h4 + [f_row], thr,
                 t_rows)


def stamp_rows_general_plain(sig, key, ts, flags, power, pre_mat, pre_len,
                             suf_mat, suf_len, ts_tag, thr, msg_max: int,
                             t_rows: int):
    """Plain PyTorch version of the general stamp kernel: per-row deltas
    with each row's (B, 32) uint8 key and (B,) int64 power, and the
    template tensors -> the (C_THRESH + t_rows, B) int32 rows that
    kf.pack_rows builds from a host pack with the powers, counted bits,
    commit ids and thresholds. A dead lane (live = 0) gives a zero column
    but its commit id."""
    live, counted, tmpl, cid = _flag_fields(flags, pre_mat.shape[0])
    sg = sig.to(torch.int64)
    kb = key.to(torch.int64)
    nibs = _digest_nibbles(sg, ts.to(torch.int64), kb, tmpl, pre_mat,
                           pre_len, suf_mat, suf_len, ts_tag, msg_max)
    s8, h4, precheck = _scalar_rows(sg, nibs, live)
    f_row = ((kb[:, 31] >> 7) | ((sg[:, 31] >> 7) << 1)
             | (counted << 3)) * live | (precheck << 2)
    pw = [(power >> (ek.POWER_LIMB_BITS * i)) & ek.POWER_MASK
          for i in range(ek.POWER_LIMBS)]
    p_rows = [(pw[0] | (pw[1] << 13)) * live, (pw[2] | (pw[3] << 13)) * live,
              pw[4] * live]
    return _rows(_limb_pairs(kb, live) + _limb_pairs(sg[:, :32], live) + s8
                 + h4 + [f_row] + p_rows + [cid], thr, t_rows)


# --------------------------------------------------------------------------
# stamp_rows: kernel wrapper
# --------------------------------------------------------------------------


def stamp_rows(sig: torch.Tensor, ts: torch.Tensor, flags: torch.Tensor,
               ent: TemplateEntry, pub_raw: torch.Tensor, thr: torch.Tensor,
               t_rows: int) -> torch.Tensor:
    """(B, 64) uint8 signatures, (B, 3) int32 timestamp words, (B,) int32
    flags (bit 0 live, bit 1 counted, bits 2..9 template row, bits 10..
    commit id), a template entry, the table's (M, 32) uint8 pubkeys and
    the (n_commits, 6) int32 thresholds -> (V_THRESH + t_rows, B) int32
    packed rows.

    CUDA tensors launch csrc/stamp_rows.cu, and a sig or pub_raw that is
    not 16-byte aligned raises; CPU tensors run `stamp_rows_plain`."""
    B = sig.shape[0]
    _check = ec._check
    _check(sig, "sig", torch.uint8, (B, 64))
    _check(ts, "ts", torch.int32, (B, 3))
    _check(flags, "flags", torch.int32, (B,))
    _check(pub_raw, "pub_raw", torch.uint8, (pub_raw.shape[0], 32))
    if thr.dtype != torch.int32 or not thr.is_contiguous():
        raise ValueError("thr must be contiguous int32")
    if thr.numel() > t_rows * B:
        raise ValueError("t_rows rows cannot hold the thresholds")
    dev = sig.device
    operands = (ts, flags, pub_raw, thr, ent.pre_mat, ent.pre_len,
                ent.suf_mat, ent.suf_len, ent.ts_tag)
    if dev.type == "cpu" and all(t.device == dev for t in operands):
        return stamp_rows_plain(sig, ts, flags, ent.pre_mat, ent.pre_len,
                                ent.suf_mat, ent.suf_len, ent.ts_tag,
                                pub_raw, thr, ent.msg_max, t_rows)
    ec._kernel_device(dev, "stamp_rows", *operands)
    # the kernel reads sig and pub_raw with 16-byte loads and the template
    # rows as 8-byte words
    for t, name, q in ((sig, "sig", 16), (pub_raw, "pub_raw", 16),
                       (ent.pre_mat, "pre_mat", 8),
                       (ent.suf_mat, "suf_mat", 8)):
        if (t.data_ptr() | t.stride(0)) % q:
            raise ValueError(f"stamp_rows: {name} is not {q}-byte aligned")
    from cometbft_tpu_torch.ops import _build

    fn = _build.kernel_lib("stamp_rows.cu").cbt_stamp_rows
    out = torch.empty((V_THRESH + t_rows, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(sig.data_ptr(), ts.data_ptr(), flags.data_ptr(), B,
                 ent.pre_mat.data_ptr(), ent.pre_len.data_ptr(),
                 ent.pre_mat.shape[1], ent.suf_mat.data_ptr(),
                 ent.suf_len.data_ptr(), ent.suf_mat.shape[1],
                 ent.ts_tag.data_ptr(), ent.pre_mat.shape[0],
                 pub_raw.data_ptr(), pub_raw.shape[0], thr.data_ptr(),
                 thr.numel(), t_rows, out.data_ptr(), stream)
    kf._raise_on(err, "stamp_rows")
    stamp_rows.launches += 1
    return out


stamp_rows.launches = 0


def _on(x, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype).to(dev).contiguous()


def stamp_rows_cached(sig, ts, flags, ent: TemplateEntry,
                      table: ec.ValsetTable, n_commits: int = 1,
                      thresh=None) -> torch.Tensor:
    """Device-stamped packed rows for a delta chunk: what
    pack_rows_cached would build from the expanded batch, assembled on the
    table's device. Requires a table with pub_raw."""
    if table.pub_raw is None:
        raise ValueError("a delta chunk needs a table built with pub_raw")
    B = int(sig.shape[0])
    t_rows = ec.packed_rows_shape(B, n_commits)[0] - V_THRESH
    if thresh is None:
        thresh = np.zeros((1, ek.TALLY_LIMBS), np.int32)
    dev = table.device
    return stamp_rows(_on(sig, torch.uint8, dev), _on(ts, torch.int32, dev),
                      _on(flags, torch.int32, dev), ent, table.pub_raw,
                      _on(thresh, torch.int32, dev), t_rows)


def stamp_rows_general(sig: torch.Tensor, key: torch.Tensor,
                       ts: torch.Tensor, flags: torch.Tensor,
                       power: torch.Tensor, ent: TemplateEntry,
                       thr: torch.Tensor, t_rows: int) -> torch.Tensor:
    """(B, 64) uint8 signatures, (B, 32) uint8 keys, (B, 3) int32 timestamp
    words, (B,) int32 flags (as `stamp_rows`'), (B,) int64 powers, a
    template entry and the (n_commits, 6) int32 thresholds -> (C_THRESH +
    t_rows, B) int32 packed rows in the general layout (kf.C_*).

    CUDA tensors launch csrc/stamp_rows.cu `cbt_stamp_rows_general`, and a
    sig or key that is not 16-byte aligned raises; CPU tensors run
    `stamp_rows_general_plain`."""
    B = sig.shape[0]
    _check = ec._check
    _check(sig, "sig", torch.uint8, (B, 64))
    _check(key, "key", torch.uint8, (B, 32))
    _check(ts, "ts", torch.int32, (B, 3))
    _check(flags, "flags", torch.int32, (B,))
    _check(power, "power", torch.int64, (B,))
    if thr.dtype != torch.int32 or not thr.is_contiguous():
        raise ValueError("thr must be contiguous int32")
    if thr.numel() > t_rows * B:
        raise ValueError("t_rows rows cannot hold the thresholds")
    dev = sig.device
    operands = (key, ts, flags, power, thr, ent.pre_mat, ent.pre_len,
                ent.suf_mat, ent.suf_len, ent.ts_tag)
    if dev.type == "cpu" and all(t.device == dev for t in operands):
        return stamp_rows_general_plain(
            sig, key, ts, flags, power, ent.pre_mat, ent.pre_len,
            ent.suf_mat, ent.suf_len, ent.ts_tag, thr, ent.msg_max, t_rows)
    ec._kernel_device(dev, "stamp_rows_general", *operands)
    for t, name, q in ((sig, "sig", 16), (key, "key", 16),
                       (ent.pre_mat, "pre_mat", 8),
                       (ent.suf_mat, "suf_mat", 8)):
        if (t.data_ptr() | t.stride(0)) % q:
            raise ValueError(
                f"stamp_rows_general: {name} is not {q}-byte aligned")
    from cometbft_tpu_torch.ops import _build

    fn = _build.kernel_lib("stamp_rows.cu").cbt_stamp_rows_general
    out = torch.empty((kf.C_THRESH + t_rows, B), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(sig.data_ptr(), key.data_ptr(), ts.data_ptr(),
                 flags.data_ptr(), power.data_ptr(), B,
                 ent.pre_mat.data_ptr(), ent.pre_len.data_ptr(),
                 ent.pre_mat.shape[1], ent.suf_mat.data_ptr(),
                 ent.suf_len.data_ptr(), ent.suf_mat.shape[1],
                 ent.ts_tag.data_ptr(), ent.pre_mat.shape[0], thr.data_ptr(),
                 thr.numel(), t_rows, out.data_ptr(), stream)
    kf._raise_on(err, "stamp_rows_general")
    stamp_rows_general.launches += 1
    return out


stamp_rows_general.launches = 0


def verify_tally_delta_general(sig, key, ts, flags, power,
                               ent: TemplateEntry, n_commits: int, thresh,
                               device=None):
    """Fused verify + tally for a delta-staged general chunk (host arrays
    or tensors): `stamp_rows_general` builds the packed rows on `device`
    (default: the CUDA card), then the general verify and tally kernels
    consume them; the rows never exist on the host. The threshold rows
    are `kf.pack_rows`'. Returns (valid (B,) bool, tally (C, 6) int32,
    quorum (C,) bool)."""
    dev = resolve(device)
    B = int(sig.shape[0])
    thr = _on(thresh, torch.int32, dev)
    t_rows = max(1, -(-thr.numel() // B))
    rows = stamp_rows_general(
        _on(sig, torch.uint8, dev), _on(key, torch.uint8, dev),
        _on(ts, torch.int32, dev), _on(flags, torch.int32, dev),
        _on(power, torch.int64, dev), ent, thr, t_rows)
    verdicts = kf.ed25519_verify(rows)
    tally, quorum = kf.tally_quorum(verdicts, rows, n_commits)
    return verdicts != 0, tally, quorum


def verify_tally_delta_cached(sig, ts, flags, ent: TemplateEntry,
                              table: ec.ValsetTable, n_commits: int,
                              thresh=None):
    """Fused verify + tally for a delta-staged chunk: `stamp_rows` expands
    (template, deltas) into the packed rows on the device, then the cached
    verify and tally kernels consume them. Returns (valid (B,) bool,
    tally (C, 6) int32, quorum (C,) bool)."""
    rows = stamp_rows_cached(sig, ts, flags, ent, table, n_commits, thresh)
    verdicts = ec.ed25519_verify_cached(rows, table.tab, table.ok)
    tally, quorum = ec.tally_quorum_cached(verdicts, rows, table.power5,
                                           n_commits)
    return verdicts != 0, tally, quorum
