"""Block, Header, Data — construction, hashing, proto encoding.

Reference: types/block.go (Header :324-461 incl. Hash :439 merkle-of-
field-encodings via cdcEncode wrappers, Block :25-140, populate/validate),
types/encoding_helper.go (cdcEncode: gogotypes String/Int64/BytesValue
wrappers), proto/tendermint/types/types.pb.go (field numbers).

The port's copy of the JAX package's types/block.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from cometbft_tpu_torch.crypto import merkle, tmhash
from cometbft_tpu_torch.libs import protoenc as pe
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.commit import Commit, CommitSig
from cometbft_tpu_torch.types.timestamp import Timestamp

# Protocol version (proto/tendermint/version/types.pb.go Consensus)
BLOCK_PROTOCOL = 11


class BlockError(Exception):
    pass


def _cdc_bytes(b: bytes) -> bytes:
    """cdcEncode for byte slices: BytesValue{value=1} proto wrapper; empty
    -> empty leaf (encoding_helper.go returns nil)."""
    return pe.f_bytes(1, b) if b else b""


def _cdc_string(s: str) -> bytes:
    return pe.f_bytes(1, s.encode()) if s else b""


def _cdc_int64(v: int) -> bytes:
    return pe.f_varint(1, v) if v else b""


def version_bytes(block: int = BLOCK_PROTOCOL, app: int = 0) -> bytes:
    """cmtversion.Consensus proto: block=1, app=2 (both uint64 varint)."""
    return pe.f_varint(1, block) + pe.f_varint(2, app)


def block_id_proto(bid: BlockID) -> bytes:
    psh = pe.f_varint(1, bid.part_set_header.total) + pe.f_bytes(
        2, bid.part_set_header.hash
    )
    return pe.f_bytes(1, bid.hash) + pe.f_msg(2, psh)


@dataclass
class Header:
    chain_id: str = ""
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp)
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""
    version_block: int = BLOCK_PROTOCOL
    version_app: int = 0

    def hash(self) -> Optional[bytes]:
        """Merkle of the 14 field encodings (types/block.go:439)."""
        if not self.validators_hash:
            return None
        return merkle.hash_from_byte_slices([
            version_bytes(self.version_block, self.version_app),
            _cdc_string(self.chain_id),
            _cdc_int64(self.height),
            pe.timestamp(self.time.seconds, self.time.nanos),
            block_id_proto(self.last_block_id),
            _cdc_bytes(self.last_commit_hash),
            _cdc_bytes(self.data_hash),
            _cdc_bytes(self.validators_hash),
            _cdc_bytes(self.next_validators_hash),
            _cdc_bytes(self.consensus_hash),
            _cdc_bytes(self.app_hash),
            _cdc_bytes(self.last_results_hash),
            _cdc_bytes(self.evidence_hash),
            _cdc_bytes(self.proposer_address),
        ])

    def to_proto_bytes(self) -> bytes:
        """tendermint.types.Header proto encoding (types.pb.go)."""
        out = pe.f_msg(
            1, version_bytes(self.version_block, self.version_app)
        )
        out += pe.f_bytes(2, self.chain_id.encode())
        out += pe.f_varint(3, self.height)
        out += pe.f_msg(4, pe.timestamp(self.time.seconds, self.time.nanos))
        out += pe.f_msg(5, block_id_proto(self.last_block_id))
        out += pe.f_bytes(6, self.last_commit_hash)
        out += pe.f_bytes(7, self.data_hash)
        out += pe.f_bytes(8, self.validators_hash)
        out += pe.f_bytes(9, self.next_validators_hash)
        out += pe.f_bytes(10, self.consensus_hash)
        out += pe.f_bytes(11, self.app_hash)
        out += pe.f_bytes(12, self.last_results_hash)
        out += pe.f_bytes(13, self.evidence_hash)
        out += pe.f_bytes(14, self.proposer_address)
        return out


@dataclass
class Data:
    txs: List[bytes] = field(default_factory=list)

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices(self.txs)


def evidence_hash(evs: List) -> bytes:
    """EvidenceData.Hash (types/evidence.go EvidenceList.Hash): merkle of
    per-evidence hashes."""
    return merkle.hash_from_byte_slices([ev.hash() for ev in evs])


def commit_sig_proto(cs: CommitSig) -> bytes:
    body = pe.f_varint(1, cs.flag)
    body += pe.f_bytes(2, cs.validator_address)
    body += pe.f_msg(3, pe.timestamp(cs.timestamp.seconds, cs.timestamp.nanos))
    body += pe.f_bytes(4, cs.signature)
    return body


def commit_proto(c: Commit) -> bytes:
    body = pe.f_varint(1, c.height)
    body += pe.f_varint(2, c.round)
    body += pe.f_msg(3, block_id_proto(c.block_id))
    for cs in c.signatures:
        body += pe.f_msg(4, commit_sig_proto(cs))
    return body


@dataclass
class Block:
    header: Header
    data: Data
    last_commit: Optional[Commit] = None
    # committed evidence (types/block.go:48 Evidence EvidenceData): list
    # of DuplicateVoteEvidence / LightClientAttackEvidence, hashed into
    # header.evidence_hash
    evidence: List = field(default_factory=list)

    def hash(self) -> Optional[bytes]:
        return self.header.hash()

    def make_part_set(self, part_size: Optional[int] = None):
        """Split into 64KiB parts w/ proofs (types/block.go:140
        MakePartSet); memoized — the split is a pure function of the
        block's canonical wire form."""
        from cometbft_tpu_torch.types import part_set as psmod

        size = part_size or psmod.BLOCK_PART_SIZE
        cached = getattr(self, "_part_set", None)
        if cached is None or cached[0] != size:
            cached = (size, psmod.make_block_parts(self, size))
            self._part_set = cached
        return cached[1]

    def block_id(self, part_set_header: Optional[PartSetHeader] = None
                 ) -> BlockID:
        """BlockID{Hash, PartSetHeader} — the psh is the real part-set
        merkle header (consensus-critical: votes sign over it, so every
        node must derive the identical value from the block bytes)."""
        h = self.hash()
        psh = part_set_header or self.make_part_set().header()
        return BlockID(h or b"", psh)

    def fill_header(self) -> None:
        """Populate derived header hashes (types/block.go:439 fillHeader)."""
        if not self.header.last_commit_hash and self.last_commit is not None:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash()
        if not self.header.evidence_hash:
            self.header.evidence_hash = evidence_hash(self.evidence)

    def validate_basic(self) -> None:
        """types/block.go:48-101."""
        if self.header.height < 0:
            raise BlockError("negative Height")
        if self.header.height > 1:
            if self.last_commit is None:
                raise BlockError("nil LastCommit")
            if self.header.last_commit_hash != self.last_commit.hash():
                raise BlockError("wrong Header.LastCommitHash")
        if self.header.data_hash != self.data.hash():
            raise BlockError("wrong Header.DataHash")
        if self.header.evidence_hash != evidence_hash(self.evidence):
            raise BlockError("wrong Header.EvidenceHash")
        for ev in self.evidence:
            ev.validate_basic()
        if len(self.header.proposer_address) != tmhash.TRUNCATED_SIZE:
            raise BlockError("invalid proposer address size")
