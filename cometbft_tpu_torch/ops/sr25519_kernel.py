"""Batched sr25519 (schnorrkel) verification on the hand-written Hopper
kernel.

Counterpart of the JAX package's ops/sr25519_kernel.py (reference seam:
crypto/sr25519/batch.go:44-77, voi's merlin-transcript batch verify). The
merlin challenge k = H(transcript) is computed on the host by the native
host packer (native.sr25519_batch_challenges, one call a message length)
and reduced mod L there too (native.batch_reduce_mod_l), as the
reference does (`challenge_scalars`, a stage of its own in
`verify_batch`); with `native=False` the numpy-batched STROBE
(crypto/merlin.BatchTranscript) and Python ints are the plain version.
The packed rows use the ed25519 ABI
(ops/ed25519_fused.py `C_*`), byte for byte the JAX package's:

  C_AY   A's ristretto encoding s (13-bit limb pairs)
  C_RY   the signature R's encoding
  C_S8   byte digits of the signature scalar s
  C_H4   nibble digits of k
  C_FLAGS bit 2: the host precheck (lengths, marker bit, s < L, both
         encodings canonical and even)

One kernel runs the curve work, `sr25519_verify` (csrc/sr25519_verify.cu):
ristretto-decode A and R, P1 = [s]B + [k](-A) over the ed25519 niels comb,
accept iff P1 equals R as ristretto points (X1 Y2 == Y1 X2 or Y1 Y2 ==
X1 X2). The wrapper launches it for CUDA tensors (or raises) and runs the
plain PyTorch version (`sr25519_verify_plain`) for CPU tensors; nothing
falls back silently. `sr25519_verify.launches` counts kernel launches.
`verify_tally_rows` follows the verify with the already-ported
`ed25519_fused.tally_quorum`.
"""
from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch import native as _native
from cometbft_tpu_torch.crypto import batch as cbatch
from cometbft_tpu_torch.crypto import merlin
from cometbft_tpu_torch.crypto import ristretto_ref as rist
from cometbft_tpu_torch.crypto import sr25519_ref as sr
from cometbft_tpu_torch.ops import curve25519 as curve
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import field as fe
from cometbft_tpu_torch.ops.ed25519_fused import (
    C_AY,
    C_FLAGS,
    C_H4,
    C_KROWS,
    C_RY,
    C_S8,
)
from cometbft_tpu_torch.ops.field import NLIMBS

_M13 = (1 << 13) - 1


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------


def rist_decode(s: torch.Tensor):
    """ristretto255 DECODE (RFC 9496 section 4.3.1) of (B, NLIMBS) limbs of
    encodings the host checked to be canonical and even -> (point, ok).
    The point is garbage where ok is False."""
    dev = s.device
    one = fe.const(1, dev)
    sqrt_m1 = fe.const(rist.SQRT_M1, dev)
    ss = fe.square(s)
    u1 = fe.sub(one, ss)
    u2 = fe.add(one, ss)
    u2s = fe.square(u2)
    v = -fe.add(fe.mul(fe.const(rist.D, dev), fe.square(u1)), u2s)
    w = fe.mul(v, u2s)
    w3 = fe.mul(fe.square(w), w)
    w7 = fe.mul(fe.square(w3), w)
    r = fe.mul(w3, fe.pow_p58(w7))
    check = fe.mul(w, fe.square(r))
    correct = fe.eq(check, one)
    flipped = fe.is_zero(check + one)            # check == -1
    flipped_i = fe.is_zero(check + sqrt_m1)      # check == -sqrt(-1)
    r = torch.where((flipped | flipped_i).unsqueeze(-1),
                    fe.mul(r, sqrt_m1), r)
    r = torch.where((fe.parity(r) != 0).unsqueeze(-1), -r, r)  # CT_ABS
    den_x = fe.mul(r, u2)
    den_y = fe.mul(fe.mul(r, den_x), v)
    x = fe.mul_small(fe.mul(s, den_x), 2)
    x = torch.where((fe.parity(x) != 0).unsqueeze(-1), -x, x)  # CT_ABS
    y = fe.mul(u1, den_y)
    t = fe.mul(x, y)
    ok = (correct | flipped) & (fe.parity(t) == 0) & ~fe.is_zero(y)
    return (x, y, torch.zeros_like(x) + one, t), ok


def sr25519_verify_plain(rows: torch.Tensor, points: torch.Tensor):
    """Plain PyTorch version of the verify kernel: (>= C_KROWS, B) int32
    rows + the (32, 256, 4, NLIMBS) ed25519 comb table -> (B,) int32
    verdicts."""
    r = rows[:C_KROWS].to(torch.int64)

    def limbs(row0):
        w = r[row0:row0 + 10]
        return torch.cat([w & _M13, (w >> 13) & _M13]).T.contiguous()

    s8 = torch.cat([(r[C_S8:C_S8 + 8] >> (8 * k)) & 255
                    for k in range(4)]).T.contiguous()  # (B, 32)
    h4 = torch.cat([(r[C_H4:C_H4 + 8] >> (4 * k)) & 15
                    for k in range(8)]).T.contiguous()  # (B, 64)
    A, ok_a = rist_decode(limbs(C_AY))
    R, ok_r = rist_decode(limbs(C_RY))
    P1 = curve.add(curve.base_scalar_mul(s8, points),
                   curve.scalar_mul_windowed(h4, curve.neg(A)))
    eq = (fe.eq(fe.mul(P1[0], R[1]), fe.mul(P1[1], R[0]))
          | fe.eq(fe.mul(P1[1], R[1]), fe.mul(P1[0], R[0])))
    valid = eq & ok_a & ok_r & (((r[C_FLAGS] >> 2) & 1) != 0)
    return valid.to(torch.int32)


# --------------------------------------------------------------------------
# sr25519_verify: kernel wrapper
# --------------------------------------------------------------------------


# Field multiplications and squarings of one column that runs to its end in
# csrc/ristretto_core.cuh `verify_column_sr`: two ristretto decodes (12M +
# 6S and a 11M + 251S power chain each), 15 table conversions and 14 adds
# (127M), 63 x (13M + 16S) of doublings, 64 cached adds of 8M, 32 niels
# adds of 7M, and 4M for the coset equality. A decode whose check is -1 or
# -sqrt(-1) adds one multiplication (about half of them). Each
# multiplication is 100 limb products, each squaring 55.
VERIFY_FE_MULS = 1732
VERIFY_FE_SQUARES = 1522


def verify_products_per_signature() -> int:
    """32 x 32 -> 64 bit limb products of one verified signature."""
    return VERIFY_FE_MULS * 100 + VERIFY_FE_SQUARES * 55


def sr25519_verify(rows: torch.Tensor) -> torch.Tensor:
    """(>= C_KROWS, B) int32 packed rows -> (B,) int32 verdicts (1 valid).

    CUDA tensors launch csrc/sr25519_verify.cu with the ed25519 niels comb
    table (`ed25519_fused.base_table`); CPU tensors run
    `sr25519_verify_plain` with the plain table (`base_points`)."""
    kf._check_rows(rows, C_KROWS)
    dev = rows.device
    if dev.type == "cpu":
        return sr25519_verify_plain(rows, kf.base_points(dev))
    if dev.type != "cuda":
        raise ValueError(f"no sr25519_verify kernel for device {dev}")
    from cometbft_tpu_torch.ops import _build

    fn = _build.kernel_lib("sr25519_verify.cu").cbt_sr25519_verify
    table = kf.base_table(dev)
    B = rows.shape[1]
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rows.data_ptr(), B, table.data_ptr(), out.data_ptr(),
                 stream)
    kf._raise_on(err, "sr25519_verify")
    sr25519_verify.launches += 1
    return out


sr25519_verify.launches = 0


# --------------------------------------------------------------------------
# host packing
# --------------------------------------------------------------------------


_P_WORDS = np.frombuffer(int.to_bytes(fe.P, 32, "little"), np.uint8).view(
    "<u8")


def batch_challenges(msgs, pubs, r_encs, native: bool = True) -> np.ndarray:
    """Merlin challenges for a batch: (n, 64) uint8 raw challenge bytes
    (the reduction mod L happens in the pack).

    Rows are grouped by len(msg): within a group the transcript's
    operations are identical, so one native call (or, for empty messages
    and with native=False, one BatchTranscript) runs them in lockstep. A
    commit's sign-bytes vary in length with the timestamp varints, so a
    commit makes a few groups."""
    n = len(msgs)
    out = np.zeros((n, 64), np.uint8)
    prefix = sr._signing_prefix()
    groups: dict = {}
    for i, m in enumerate(msgs):
        groups.setdefault(len(m), []).append(i)
    for ln, idxs in groups.items():
        marr = (np.frombuffer(b"".join(msgs[i] for i in idxs), np.uint8)
                .reshape(len(idxs), ln) if ln
                else np.empty((len(idxs), 0), np.uint8))
        parr = np.frombuffer(b"".join(pubs[i] for i in idxs),
                             np.uint8).reshape(len(idxs), 32)
        rarr = np.frombuffer(b"".join(r_encs[i] for i in idxs),
                             np.uint8).reshape(len(idxs), 32)
        if native and ln:
            st = prefix.strobe
            out[np.asarray(idxs)] = _native.sr25519_batch_challenges(
                bytes(st.st), st.pos, st.pos_begin, st.cur_flags, marr,
                parr, rarr)
            continue
        bt = merlin.BatchTranscript(len(idxs), prefix, native)
        bt.append_message_batch(b"sign-bytes", marr)
        bt.append_message_shared(b"proto-name", b"Schnorr-sig")
        bt.append_message_batch(b"sign:pk", parr)
        bt.append_message_batch(b"sign:R", rarr)
        out[np.asarray(idxs)] = bt.challenge_bytes_batch(b"sign:c", 64)
    return out


def challenge_scalars(pubkeys, msgs, sigs, native: bool = True
                      ) -> np.ndarray:
    """k = the merlin challenge mod L of each row: (n, 32) uint8, little
    endian. A key that is not 32 bytes, or an R of a signature that is not
    64, goes into the transcript as zeros (the pack's precheck fails the
    row). The challenges and the reduction run in the native host packer;
    `native=False` runs the numpy plain version and Python ints."""
    n = len(pubkeys)
    if not n:
        return np.zeros((0, 32), np.uint8)
    r_encs = [bytes(s[:32]) if len(s) == 64 else b"\x00" * 32 for s in sigs]
    # the zero key of a short-key row goes in before the transcripts, so
    # neither route ever sees a key that is not 32 bytes
    chal = batch_challenges(
        [bytes(m) for m in msgs],
        [bytes(p) if len(p) == 32 else b"\x00" * 32 for p in pubkeys],
        r_encs, native)
    if native:
        return _native.batch_reduce_mod_l(chal)
    from_b, to_b, L = int.from_bytes, int.to_bytes, sr.L
    return np.frombuffer(b"".join(
        to_b(from_b(bytes(c), "little") % L, 32, "little")
        for c in chal), np.uint8).reshape(n, 32).copy()


def pack_batch_sr(pubkeys, msgs, sigs, pad_to=None,
                  power5=None, counted=None, commit_ids=None, thresh=None,
                  native: bool = True, k_red=None):
    """sr25519 rows -> compact packed (R, B) int32 array in the ed25519
    layout (`ed25519_fused.pack_rows`), byte for byte the JAX package's
    `pack_batch_sr`. A row whose key is not 32 bytes gets a zero key in
    the transcript and fails the precheck. `k_red` is the rows'
    `challenge_scalars`, computed here when not given (`native=False`:
    the plain version)."""
    n = len(pubkeys)
    pad = pad_to or kf.pad_to_tile(n)
    a_l = np.zeros((pad, NLIMBS), np.int32)
    r_l = np.zeros((pad, NLIMBS), np.int32)
    sdig = np.zeros((pad, 64), np.int32)
    hdig = np.zeros((pad, 64), np.int32)
    precheck = np.zeros((pad,), np.int32)

    if k_red is None:
        k_red = challenge_scalars(pubkeys, msgs, sigs, native)
    lenok = np.array(
        [len(pubkeys[i]) == 32 and len(sigs[i]) == 64
         and bool(sigs[i][63] & 0x80) for i in range(n)], np.bool_)
    if n:
        pk_arr = np.zeros((n, 32), np.uint8)
        r_arr = np.zeros((n, 32), np.uint8)
        s_arr = np.zeros((n, 32), np.uint8)
        for i in np.flatnonzero(lenok):
            pk_arr[i] = np.frombuffer(bytes(pubkeys[i]), np.uint8)
            sig = np.frombuffer(bytes(sigs[i]), np.uint8)
            r_arr[i] = sig[:32]
            s_arr[i] = sig[32:]
        s_arr[:, 31] &= 0x7F
        # canonical encodings (< p, even) and s < L: the oracle's decode
        # and scalar rejections
        ok = (lenok & ek.below_words(pk_arr, _P_WORDS)
              & ek.below_words(r_arr, _P_WORDS)
              & ((pk_arr[:, 0] & 1) == 0) & ((r_arr[:, 0] & 1) == 0)
              & ek.s_below_l(s_arr))
        k_red = np.array(k_red, np.uint8)
        # zeroing the inputs of failed rows zeroes every derived output
        bad = ~ok
        for arr in (pk_arr, r_arr, s_arr, k_red):
            arr[bad] = 0
        a_l[:n] = fe.from_bytes_le(pk_arr)
        r_l[:n] = fe.from_bytes_le(r_arr)
        sdig[:n] = ek.nibbles(s_arr)
        hdig[:n] = ek.nibbles(k_red)
        precheck[:n] = ok.astype(np.int32)

    zeros = np.zeros((pad,), np.int32)
    pb = ek.PackedBatch(n, pad, a_l, zeros, r_l, zeros, sdig, hdig,
                        precheck)
    return kf.pack_rows(pb, power5, counted, commit_ids, thresh)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def verify_rows(rows, device=None) -> torch.Tensor:
    """(R, B) packed array (numpy or tensor) -> (B,) bool validity on
    `device` (default: the CUDA card)."""
    return sr25519_verify(kf._to_device(rows, device)) != 0


def verify_tally_rows(rows, n_commits: int, device=None):
    """Verify + tally from one packed (R, B) int32 array: one upload, two
    kernels (sr25519_verify, tally_quorum), three outputs (valid (B,)
    bool, tally (C, 6) int32, quorum (C,) bool)."""
    r = kf._to_device(rows, device)
    verdicts = sr25519_verify(r)
    tally, quorum = kf.tally_quorum(verdicts, r, n_commits)
    return verdicts != 0, tally, quorum


def verify_batch(pubkeys, msgs, sigs, device=None) -> np.ndarray:
    """(pubkey, msg, sig) triples -> (n,) bool numpy validity; each host
    stage a crypto/batch.py `stage`."""
    with cbatch.stage("challenges"):
        k_red = challenge_scalars(pubkeys, msgs, sigs)
    with cbatch.stage("pack"):
        rows = pack_batch_sr(pubkeys, msgs, sigs, k_red=k_red)
    with cbatch.stage("dispatch"):
        valid = verify_rows(rows, device)
    with cbatch.stage("wait"):
        return valid.cpu().numpy()[: len(pubkeys)]


verify_batch.cols = kf.pad_to_tile
