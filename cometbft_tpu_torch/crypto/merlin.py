"""STROBE-128 + merlin transcripts (scalar and numpy-batched).

A copy of the JAX package's crypto/merlin.py. The batched classes permute
through the native host packer (native.batch_keccak_f1600), as the
reference does; with native=False they permute with numpy
(keccak.keccak_f1600_np), the plain version.

The sr25519 (schnorrkel) challenge scalar is a merlin transcript
challenge; merlin is STROBE-128 instantiated on keccak-f[1600] with
protocol label "Merlin v1.0". Reference seam: crypto/sr25519/batch.go:69
(signingCtx.NewTranscriptBytes -> transcript passed to voi's verifier).

The batched classes run N transcripts in lockstep over a (N, 200)-byte
state array: every operation must be applied to all N transcripts with
the SAME label and SAME message length (data bytes differ) — exactly the
shape of a commit's signature set after grouping rows by sign-bytes
length. This makes the host-side challenge derivation for a 10k-signature
commit a handful of vectorized keccak passes instead of 10k serial
transcript walks.
"""
from __future__ import annotations

import numpy as np

from cometbft_tpu_torch import native as _native
from cometbft_tpu_torch.crypto.keccak import (
    bytes_to_state,
    keccak_f1600,
    keccak_f1600_np,
    state_to_bytes,
)

R = 166  # STROBE-128 rate: 200 - 2*16 - 2
FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


def _initial_state() -> bytes:
    st = bytearray(200)
    st[0:6] = bytes([1, R + 2, 1, 0, 1, 96])
    st[6:18] = b"STROBEv1.0.2"
    return bytes(state_to_bytes(keccak_f1600(bytes_to_state(st))))


_INIT = None


def initial_state() -> bytes:
    global _INIT
    if _INIT is None:
        _INIT = _initial_state()
    return _INIT


class Strobe128:
    """Single-stream STROBE-128 (the subset merlin uses: AD/meta-AD/PRF)."""

    def __init__(self, protocol_label: bytes):
        self.st = bytearray(initial_state())
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self):
        self.st[self.pos] ^= self.pos_begin
        self.st[self.pos + 1] ^= 0x04
        self.st[R + 1] ^= 0x80
        self.st = bytearray(
            state_to_bytes(keccak_f1600(bytes_to_state(self.st)))
        )
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for b in data:
            self.st[self.pos] ^= b
            self.pos += 1
            if self.pos == R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.st[self.pos])
            self.st[self.pos] = 0
            self.pos += 1
            if self.pos == R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert flags == self.cur_flags
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (FLAG_C | FLAG_K)) and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)


class Transcript:
    """merlin::Transcript."""

    def __init__(self, label: bytes, _strobe: Strobe128 = None):
        if _strobe is not None:
            self.strobe = _strobe
            return
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def clone(self) -> "Transcript":
        s = Strobe128.__new__(Strobe128)
        s.st = bytearray(self.strobe.st)
        s.pos = self.strobe.pos
        s.pos_begin = self.strobe.pos_begin
        s.cur_flags = self.strobe.cur_flags
        return Transcript(b"", _strobe=s)

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n)


class BatchStrobe:
    """N STROBE-128 streams in lockstep (same ops/lengths, distinct data).

    States live in a (N, 200) uint8 array; permutations run through the
    batched keccak (native, or numpy with native=False). Seeded either
    fresh or from a scalar Strobe128 whose prefix is shared by every
    stream (the cloned signing-context pattern).
    """

    def __init__(self, n: int, from_strobe: Strobe128, native: bool = True):
        self.n = n
        self._permute = (_native.batch_keccak_f1600 if native
                         else keccak_f1600_np)
        self.st = np.tile(
            np.frombuffer(bytes(from_strobe.st), np.uint8), (n, 1)
        ).copy()
        self.pos = from_strobe.pos
        self.pos_begin = from_strobe.pos_begin
        self.cur_flags = from_strobe.cur_flags

    def _run_f(self):
        self.st[:, self.pos] ^= self.pos_begin
        self.st[:, self.pos + 1] ^= 0x04
        self.st[:, R + 1] ^= 0x80
        lanes = self.st.view(np.uint64).reshape(self.n, 25)
        permuted = self._permute(lanes)
        self.st = permuted.view(np.uint8).reshape(self.n, 200).copy()
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: np.ndarray):
        """data (N, L) uint8 — same L for every stream."""
        L = data.shape[1]
        off = 0
        while off < L:
            take = min(R - self.pos, L - off)
            self.st[:, self.pos:self.pos + take] ^= data[:, off:off + take]
            self.pos += take
            off += take
            if self.pos == R:
                self._run_f()

    def _squeeze(self, n_bytes: int) -> np.ndarray:
        out = np.empty((self.n, n_bytes), np.uint8)
        off = 0
        while off < n_bytes:
            take = min(R - self.pos, n_bytes - off)
            out[:, off:off + take] = self.st[:, self.pos:self.pos + take]
            self.st[:, self.pos:self.pos + take] = 0
            self.pos += take
            off += take
            if self.pos == R:
                self._run_f()
        return out

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert flags == self.cur_flags
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        hdr = np.tile(
            np.array([old_begin, flags], np.uint8), (self.n, 1)
        )
        self._absorb(hdr)
        if (flags & (FLAG_C | FLAG_K)) and self.pos != 0:
            self._run_f()

    def _bcast(self, data: bytes) -> np.ndarray:
        return np.tile(np.frombuffer(data, np.uint8), (self.n, 1))

    def meta_ad_shared(self, data: bytes, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(self._bcast(data))

    def ad_batch(self, data: np.ndarray, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(np.ascontiguousarray(data, np.uint8))

    def prf(self, n_bytes: int) -> np.ndarray:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, False)
        return self._squeeze(n_bytes)


class BatchTranscript:
    """N merlin transcripts in lockstep, forked from a shared prefix."""

    def __init__(self, n: int, prefix: Transcript, native: bool = True):
        self.strobe = BatchStrobe(n, prefix.strobe, native)

    def append_message_batch(self, label: bytes, messages: np.ndarray):
        """messages (N, L) uint8 — equal length across the batch."""
        self.strobe.meta_ad_shared(label, False)
        self.strobe.meta_ad_shared(
            messages.shape[1].to_bytes(4, "little"), True
        )
        self.strobe.ad_batch(messages, False)

    def append_message_shared(self, label: bytes, message: bytes):
        self.strobe.meta_ad_shared(label, False)
        self.strobe.meta_ad_shared(
            len(message).to_bytes(4, "little"), True
        )
        self.strobe.ad_batch(
            np.tile(np.frombuffer(message, np.uint8),
                    (self.strobe.n, 1)).copy()
            if message else np.empty((self.strobe.n, 0), np.uint8),
            False,
        )

    def challenge_bytes_batch(self, label: bytes, n_bytes: int) -> np.ndarray:
        self.strobe.meta_ad_shared(label, False)
        self.strobe.meta_ad_shared(n_bytes.to_bytes(4, "little"), True)
        return self.strobe.prf(n_bytes)
