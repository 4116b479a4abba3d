"""The native host packer: numpy wrappers over csrc/hostaccel.cpp.

Counterpart of the JAX package's native/__init__.py, with its names,
signatures and byte formats. The library builds at first use with the host
C++ compiler into build/kernels/ (ops/_build.native_lib) and is called
through ctypes. One difference on purpose: the reference returns None, or
hashes with hashlib, when nothing is compiled; here every wrapper calls the
library, and a missing compiler or a failed build raises BuildError. The
numpy packers that stay beside it (`native=False` on
ed25519_kernel.pack_batch, sr25519_kernel.pack_batch_sr and
merlin.BatchStrobe) are the plain versions, selected only when asked for.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from cometbft_tpu_torch.ops import _build


def available() -> bool:
    """True when the library is built (building it now if need be) and
    loaded."""
    try:
        _build.native_lib()
    except _build.BuildError:
        return False
    return True


def _cat(rows: Sequence[bytes]):
    """Concatenated rows with their (offsets, lengths) as uint64."""
    n = len(rows)
    data = np.frombuffer(b"".join(rows), np.uint8)
    if data.size == 0:
        data = np.zeros(1, np.uint8)  # a valid pointer for all-empty rows
    lens = np.fromiter((len(r) for r in rows), np.uint64, count=n)
    offs = np.zeros(n, np.uint64)
    if n > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    return data, offs, lens


def batch_sha512(rows: Sequence[bytes]) -> np.ndarray:
    """SHA-512 of each row: (n, 64) uint8, one native call for the
    batch."""
    lib = _build.native_lib()
    out = np.empty((len(rows), 64), np.uint8)
    lib.batch_sha512(*_cat(rows), len(rows), out)
    return out


def _r_a(r_raw: np.ndarray, a_raw: np.ndarray, n: int):
    return (np.ascontiguousarray(r_raw[:n].reshape(n, 32), np.uint8),
            np.ascontiguousarray(a_raw[:n].reshape(n, 32), np.uint8))


def ed25519_batch_digest(r_raw: np.ndarray, a_raw: np.ndarray,
                         msgs: Sequence[bytes]) -> np.ndarray:
    """SHA512(R_i || A_i || M_i): (n, 64) uint8, without building the
    concatenations in Python."""
    lib = _build.native_lib()
    n = len(msgs)
    out = np.empty((n, 64), np.uint8)
    lib.ed25519_batch_digest(*_r_a(r_raw, a_raw, n), *_cat(msgs), n, out)
    return out


def ed25519_batch_challenge(r_raw: np.ndarray, a_raw: np.ndarray,
                            msgs: Sequence[bytes]) -> np.ndarray:
    """h_i = SHA512(R_i || A_i || M_i) mod L: (n, 32) little-endian
    bytes."""
    lib = _build.native_lib()
    n = len(msgs)
    out = np.empty((n, 32), np.uint8)
    lib.ed25519_batch_challenge(*_r_a(r_raw, a_raw, n), *_cat(msgs), n,
                                out)
    return out


def _pack_out(padded: int):
    return (np.zeros((padded, 20), np.int32), np.zeros(padded, np.int32),
            np.zeros((padded, 20), np.int32), np.zeros(padded, np.int32),
            np.zeros((padded, 64), np.int32), np.zeros((padded, 64), np.int32),
            np.zeros(padded, np.uint8))


def _pack_result(out):
    *arrays, precheck = out
    return (*arrays, precheck.astype(np.bool_))


def ed25519_pack(pub_cat: bytes, sig_cat: bytes, msgs: Sequence[bytes],
                 padded: int):
    """The whole ed25519 host pack of n rows (32-byte keys and 64-byte
    signatures, concatenated) padded to `padded`: (ay, asign, ry, rsign,
    sdig, hdig, precheck), the arrays of ed25519_kernel.pack_batch."""
    lib = _build.native_lib()
    n = len(msgs)
    out = _pack_out(padded)
    if n:
        lib.ed25519_pack(np.frombuffer(pub_cat, np.uint8),
                         np.frombuffer(sig_cat, np.uint8), *_cat(msgs), n,
                         *out)
    return _pack_result(out)


def ed25519_pack_commits(pub_cat: bytes, sig_cat: bytes, templates,
                         row_tmpl: np.ndarray, row_secs: np.ndarray,
                         row_nanos: np.ndarray, padded: int):
    """ed25519_pack with each row's canonical sign-bytes built in C from
    its commit's template and its timestamp: `templates` is [(prefix,
    suffix)] around the timestamp field (CanonicalVoteEncoder.template),
    row_tmpl[i] indexes it. Returns ed25519_pack's tuple."""
    lib = _build.native_lib()
    n = len(row_tmpl)
    out = _pack_out(padded)
    if n:
        parts = [p for pre_suf in templates for p in pre_suf]
        tmpl, offs, lens = _cat(parts)
        lib.ed25519_pack_commits(
            np.frombuffer(pub_cat, np.uint8),
            np.frombuffer(sig_cat, np.uint8), tmpl,
            np.ascontiguousarray(offs[0::2]), np.ascontiguousarray(lens[0::2]),
            np.ascontiguousarray(offs[1::2]), np.ascontiguousarray(lens[1::2]),
            np.ascontiguousarray(row_tmpl, np.int32),
            np.ascontiguousarray(row_secs, np.int64),
            np.ascontiguousarray(row_nanos, np.int64), n, *out)
    return _pack_result(out)


def batch_keccak_f1600(states: np.ndarray) -> np.ndarray:
    """(n, 25) uint64 lanes -> a permuted copy."""
    lib = _build.native_lib()
    out = np.array(states, dtype=np.uint64, order="C", copy=True)
    lib.batch_keccak_f1600(out, out.shape[0])
    return out


def batch_reduce_mod_l(digests: np.ndarray) -> np.ndarray:
    """(n, 64) little-endian digests -> (n, 32) little-endian scalars
    mod L."""
    lib = _build.native_lib()
    n = digests.shape[0]
    out = np.empty((n, 32), np.uint8)
    lib.batch_reduce_mod_l(
        np.ascontiguousarray(digests.reshape(n, 64), np.uint8), n, out)
    return out


def sr25519_batch_challenges(prefix_state: bytes, pos: int, pos_begin: int,
                             cur_flags: int, msgs: np.ndarray,
                             pks: np.ndarray, rs: np.ndarray) -> np.ndarray:
    """Whole sr25519 merlin challenge transcripts forked from one signing
    prefix (its 200-byte STROBE state, pos, pos_begin, cur_flags): (n, L)
    messages of one length, (n, 32) keys and (n, 32) R encodings -> (n,
    64) raw challenge bytes."""
    lib = _build.native_lib()
    n = msgs.shape[0]
    out = np.empty((n, 64), np.uint8)
    lib.sr25519_batch_challenges(
        np.frombuffer(prefix_state, np.uint8), pos, pos_begin, cur_flags,
        np.ascontiguousarray(msgs, np.uint8), msgs.shape[1],
        np.ascontiguousarray(pks, np.uint8),
        np.ascontiguousarray(rs, np.uint8), n, out)
    return out
