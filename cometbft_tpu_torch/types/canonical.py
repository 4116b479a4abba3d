"""Canonical sign-bytes encodings — byte-exact with the reference.

Reference: types/canonical.go (CanonicalizeVote/Proposal),
proto/tendermint/types/canonical.proto (field numbers/types),
canonical.pb.go MarshalToSizedBuffer (proto3 zero-skipping; non-nullable
Timestamp always emitted), types/vote.go:139 VoteSignBytes (varint
length-prefixed). Golden vectors: types/vote_test.go
TestVoteSignBytesTestVectors — replicated in tests/test_canonical.py.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.timestamp import Timestamp

# SignedMsgType enum (proto/tendermint/types/types.pb.go:45-48)
PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2
PROPOSAL_TYPE = 32


def canonical_block_id_body(bid: BlockID) -> bytes:
    """CanonicalBlockID message body (hash field 1, part_set_header
    field 2 non-nullable)."""
    psh = pe.f_varint(1, bid.part_set_header.total) + pe.f_bytes(
        2, bid.part_set_header.hash
    )
    return pe.f_bytes(1, bid.hash) + pe.f_msg(2, psh)


def canonical_vote_bytes(
    chain_id: str,
    vote_type: int,
    height: int,
    round_: int,
    block_id: Optional[BlockID],
    ts: Timestamp,
) -> bytes:
    """Length-prefixed CanonicalVote — the exact bytes a validator signs.

    block_id=None (or a nil BlockID) omits field 4 entirely
    (types/canonical.go CanonicalizeBlockID returns nil for nil votes).
    """
    body = pe.f_varint(1, vote_type)
    body += pe.f_sfixed64(2, height)
    body += pe.f_sfixed64(3, round_)
    if block_id is not None and not block_id.is_nil():
        body += pe.f_msg(4, canonical_block_id_body(block_id))
    body += pe.f_msg(5, pe.timestamp(ts.seconds, ts.nanos))
    body += pe.f_bytes(6, chain_id.encode())
    return pe.delimited(body)


class CanonicalVoteEncoder:
    """Template-cached CanonicalVote encoder for one (chain, type, height,
    round, block_id): within a commit only the timestamp varies per
    signature, so the invariant prefix (type/height/round/block_id) and
    suffix (chain_id) are encoded once. ~5x faster than re-encoding the
    whole message per row — the sign-bytes reconstruction loop is the
    hottest host-side step of streamed commit verification
    (types/validation.go:207 runs it per signature too).
    Byte-identical to canonical_vote_bytes (differential-tested)."""

    def __init__(self, chain_id: str, vote_type: int, height: int,
                 round_: int, block_id: Optional[BlockID]):
        pre = pe.f_varint(1, vote_type)
        pre += pe.f_sfixed64(2, height)
        pre += pe.f_sfixed64(3, round_)
        if block_id is not None and not block_id.is_nil():
            pre += pe.f_msg(4, canonical_block_id_body(block_id))
        self._pre = pre
        self._suf = pe.f_bytes(6, chain_id.encode())

    @property
    def template(self) -> tuple:
        """(prefix, suffix) bytes around the spliced timestamp field."""
        return self._pre, self._suf

    def bytes_for(self, ts: Timestamp) -> bytes:
        body = (self._pre + pe.f_msg(5, pe.timestamp(ts.seconds, ts.nanos))
                + self._suf)
        return pe.delimited(body)


# --------------------------------------------------------------------------
# Vectorized template packing (the zero-copy verify hot path)
# --------------------------------------------------------------------------
#
# Within one commit, every validator signs the SAME CanonicalVote except
# for the timestamp (types/block.go:595 "only the Timestamp differs").
# CanonicalVoteEncoder splices per-row; VoteRowTemplate goes further and
# patches ALL rows of a commit in a handful of numpy passes — no
# per-signature Python bytes objects at all. Byte-identical to
# canonical_vote_bytes (property-fuzzed in tests/test_sign_template.py).

_VARINT_MAX = 10  # 64-bit two's complement worst case


def _vec_uvarint(vals: np.ndarray):
    """(n,) uint64 -> ((n, 10) uint8 LEB128 bytes, (n,) int32 lengths).

    Row i's encoding is out[i, :lens[i]] — identical to pe.uvarint."""
    x = np.ascontiguousarray(np.asarray(vals, np.int64)).view(np.uint64)
    x = x.copy()
    n = x.shape[0]
    out = np.zeros((n, _VARINT_MAX), np.uint8)
    lens = np.ones(n, np.int32)
    for j in range(_VARINT_MAX):
        out[:, j] = (x & np.uint64(0x7F)).astype(np.uint8)
        x >>= np.uint64(7)
        cont = x != 0
        out[:, j] |= cont.astype(np.uint8) << 7
        lens += cont.astype(np.int32)
    return out, lens


class SignRows:
    """A batch of canonical sign-bytes as one (n, L) uint8 matrix plus
    per-row lengths — the zero-copy staging form of the numpy pack path. Rows are right-padded with zeros."""

    __slots__ = ("mat", "lens")

    def __init__(self, mat: np.ndarray, lens: np.ndarray):
        self.mat = mat
        self.lens = np.asarray(lens, np.int64)

    def __len__(self) -> int:
        return self.mat.shape[0]

    def row(self, i: int) -> bytes:
        return self.mat[i, : self.lens[i]].tobytes()

    def tolist(self) -> list:
        """Per-row bytes. When every row has the same length (the common
        commit shape: clustered timestamps) this is one flat tobytes()
        plus cheap slicing instead of n numpy row copies."""
        n = self.mat.shape[0]
        if n == 0:
            return []
        L0 = int(self.lens[0])
        if (self.lens == L0).all():
            flat = self.mat[:, :L0].tobytes()
            return [flat[i * L0:(i + 1) * L0] for i in range(n)]
        return [self.mat[i, : int(self.lens[i])].tobytes()
                for i in range(n)]


class StampSite:
    """The per-template metadata the device stamping kernel needs to
    expand (secs, nanos) deltas into complete sign-bytes rows: the
    invariant prefix/suffix byte arrays, the timestamp field tag, the
    varint width bounds, and the worst-case row length.

    The layout contract (mirrored by ``patch_rows`` and by the stamp
    kernel of ops/ed25519_stamp.py):

        row = uvarint(body_len) | pre | TS_TAG | ts_len
              | [0x08 secs-varint]? | [0x10 nanos-varint]? | suf

    with the two timestamp fields zero-skipped (proto3 scalar rules)
    and body_len = P + 2 + ts_len + S. ``ol_max`` bounds the outer
    length prefix; ``max_len`` bounds the whole row."""

    __slots__ = ("pre", "suf", "ts_tag", "ol_max", "max_len")

    # timestamp body worst case: 0x08 + 10-byte secs + 0x10 + 10-byte
    # nanos (64-bit two's-complement varints)
    TS_LEN_MAX = 22

    def __init__(self, pre: np.ndarray, suf: np.ndarray, ts_tag: int):
        self.pre = pre
        self.suf = suf
        self.ts_tag = ts_tag
        body_max = pre.size + 2 + self.TS_LEN_MAX + suf.size
        self.ol_max = len(pe.uvarint(body_max))
        self.max_len = self.ol_max + body_max

    @property
    def key(self) -> tuple:
        """Content identity: device template caches key on this."""
        return (self.pre.tobytes(), self.suf.tobytes(), self.ts_tag)


def split_ts_words(secs, nanos, out: Optional[np.ndarray] = None
                   ) -> np.ndarray:
    """(n,) secs + (n,) nanos -> (n, 3) int32 staged delta words
    [secs_lo, secs_hi, nanos]: unsigned lo word (int32 view) +
    arithmetic-shift hi word, nanos in their own word. ``out`` reuses a
    caller buffer (a staging-pool row slice)."""
    secs = np.ascontiguousarray(secs, np.int64)
    nanos = np.asarray(nanos, np.int64)
    if out is None:
        out = np.empty((secs.shape[0], 3), np.int32)
    u = secs.view(np.uint64)
    out[:, 0] = (u & np.uint64(0xFFFFFFFF)).astype(
        np.uint32).view(np.int32)
    out[:, 1] = (secs >> np.int64(32)).astype(np.int32)
    out[:, 2] = nanos.astype(np.int32)
    return out


class DeltaRows:
    """The compact per-row delta form of a vote batch: one int64
    secs/nanos pair per row against a shared VoteRowTemplate, not full
    packed sign-bytes (~12 B a row of payload where a packed row carries
    the whole message). ``ts_words()`` is the exact int32 staging layout
    the stamp kernel (ops/ed25519_stamp.py) consumes: a 64-bit seconds
    value ships as a lo/hi pair. ``expand()`` rebuilds the rows from those
    words through the numpy reference, the differential oracle that the
    delta form is lossless."""

    __slots__ = ("template", "secs", "nanos")

    def __init__(self, template: "VoteRowTemplate", secs: np.ndarray,
                 nanos: np.ndarray):
        self.template = template
        self.secs = secs
        self.nanos = nanos

    def __len__(self) -> int:
        return int(self.secs.shape[0])

    def stampable(self) -> bool:
        """Device-stamp eligibility: nanos must fit an int32 word (the
        staging layout sign-extends it on the device; out-of-range nanos,
        which no real Timestamp has, take the host pack)."""
        if self.nanos.size == 0:
            return True
        lo, hi = int(self.nanos.min()), int(self.nanos.max())
        return lo >= -(2 ** 31) and hi < 2 ** 31

    def ts_words(self) -> np.ndarray:
        """(n, 3) int32, the staged delta words: [secs_lo, secs_hi,
        nanos]."""
        return split_ts_words(self.secs, self.nanos)

    @property
    def nbytes(self) -> int:
        """Staged delta payload bytes (the ledger's delta_bytes unit)."""
        return int(self.secs.shape[0]) * 3 * 4

    def expand(self) -> SignRows:
        """Numpy reference expansion FROM THE STAGED WORDS, not from the
        original int64s, so byte-equality against patch_rows proves the
        int32 staging round-trips losslessly."""
        w = self.ts_words()
        secs = (w[:, 0].view(np.uint32).astype(np.uint64)
                | (w[:, 1].astype(np.int64).view(np.uint64)
                   << np.uint64(32))).view(np.int64)
        return self.template.patch_rows(secs, w[:, 2].astype(np.int64))


class VoteRowTemplate:
    """Vectorized row builder for one (chain_id, type, height, round,
    block_id): the invariant prefix/suffix encode once, then
    patch_rows() stamps any number of per-validator timestamps in a few
    numpy passes. Shares the (pre, suf) template contract with
    CanonicalVoteEncoder."""

    # tag(5, WIRE_BYTES): the CanonicalVote timestamp field
    TS_TAG = (5 << 3) | pe.WIRE_BYTES

    def __init__(self, chain_id: str, vote_type: int, height: int,
                 round_: int, block_id: Optional[BlockID]):
        enc = CanonicalVoteEncoder(chain_id, vote_type, height, round_,
                                   block_id)
        pre, suf = enc.template
        self._pre = pre
        self._suf = suf
        self._pre_arr = np.frombuffer(pre, np.uint8)
        self._suf_arr = np.frombuffer(suf, np.uint8)

    @property
    def template(self) -> tuple:
        """(prefix, suffix) around the spliced timestamp field."""
        return self._pre, self._suf

    def bytes_for(self, ts: Timestamp) -> bytes:
        """Single-row splice (CanonicalVoteEncoder semantics)."""
        body = (self._pre + pe.f_msg(5, pe.timestamp(ts.seconds, ts.nanos))
                + self._suf)
        return pe.delimited(body)

    def stamp_site(self) -> StampSite:
        """The device stamping contract for this template (memoized —
        one per template, shared by every chunk that cites it)."""
        site = getattr(self, "_site", None)
        if site is None:
            site = StampSite(self._pre_arr, self._suf_arr, self.TS_TAG)
            self._site = site
        return site

    def delta_rows(self, secs: Sequence[int],
                   nanos: Sequence[int]) -> DeltaRows:
        """The compact delta form of patch_rows: per-row (secs, nanos)
        against this template. The stamp kernel expands it on the device;
        DeltaRows.expand() is its numpy oracle."""
        return DeltaRows(self, np.asarray(secs, np.int64),
                         np.asarray(nanos, np.int64))

    def patch_rows(self, secs: Sequence[int],
                   nanos: Sequence[int]) -> SignRows:
        """Stamp n timestamps into the template: (n,) seconds + (n,)
        nanos -> SignRows of complete length-prefixed sign-bytes.

        Handles every varint width (including negative seconds/nanos as
        64-bit two's complement, matching pe.varint) and the zero-
        skipping rules of the scalar encoder."""
        secs = np.asarray(secs, np.int64)
        nanos = np.asarray(nanos, np.int64)
        n = secs.shape[0]
        P, S = self._pre_arr.size, self._suf_arr.size
        sb, sl = _vec_uvarint(secs)
        nb, nl = _vec_uvarint(nanos)
        s_nz = secs != 0
        n_nz = nanos != 0
        sfl = np.where(s_nz, sl + 1, 0)      # field-1 bytes (tag + varint)
        nfl = np.where(n_nz, nl + 1, 0)      # field-2 bytes
        ts_len = sfl + nfl                   # Timestamp body (< 128)
        body_len = P + 2 + ts_len + S        # + tag(5) + 1-byte msg len
        ob, ol = _vec_uvarint(body_len)
        total = ol + body_len
        mat = np.zeros((n, int(total.max()) if n else 0), np.uint8)
        r = np.arange(n)
        for j in range(int(ol.max()) if n else 0):
            m = ol > j
            mat[m, j] = ob[m, j]
        off = ol.astype(np.int64)
        if P:
            mat[r[:, None], off[:, None] + np.arange(P)] = self._pre_arr
        off += P
        mat[r, off] = self.TS_TAG
        mat[r, off + 1] = ts_len.astype(np.uint8)
        off += 2
        if s_nz.any():
            mat[r[s_nz], off[s_nz]] = 0x08   # tag(1, VARINT)
            for j in range(int(sl[s_nz].max())):
                m = s_nz & (sl > j)
                mat[r[m], off[m] + 1 + j] = sb[m, j]
        off = off + sfl
        if n_nz.any():
            mat[r[n_nz], off[n_nz]] = 0x10   # tag(2, VARINT)
            for j in range(int(nl[n_nz].max())):
                m = n_nz & (nl > j)
                mat[r[m], off[m] + 1 + j] = nb[m, j]
        off = off + nfl
        if S:
            mat[r[:, None], off[:, None] + np.arange(S)] = self._suf_arr
        return SignRows(mat, total)


def canonical_proposal_bytes(
    chain_id: str,
    height: int,
    round_: int,
    pol_round: int,
    block_id: Optional[BlockID],
    ts: Timestamp,
) -> bytes:
    """Length-prefixed CanonicalProposal (types/proposal.go:112)."""
    body = pe.f_varint(1, PROPOSAL_TYPE)
    body += pe.f_sfixed64(2, height)
    body += pe.f_sfixed64(3, round_)
    body += pe.f_varint(4, pol_round)
    if block_id is not None and not block_id.is_nil():
        body += pe.f_msg(5, canonical_block_id_body(block_id))
    body += pe.f_msg(6, pe.timestamp(ts.seconds, ts.nanos))
    body += pe.f_bytes(7, chain_id.encode())
    return pe.delimited(body)


def canonical_vote_extension_bytes(
    chain_id: str, height: int, round_: int, extension: bytes
) -> bytes:
    """Length-prefixed CanonicalVoteExtension (types/vote.go:154)."""
    body = pe.f_bytes(1, extension)
    body += pe.f_sfixed64(2, height)
    body += pe.f_sfixed64(3, round_)
    body += pe.f_bytes(4, chain_id.encode())
    return pe.delimited(body)
