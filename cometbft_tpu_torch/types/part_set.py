"""PartSet: a block split into fixed-size parts with merkle proofs.

Reference: types/part_set.go — Part (:31-96, index + bytes + proof),
PartSet build (:214-231 NewPartSetFromData), receive side
(:234-252 NewPartSetFromHeader, :314 AddPart proof verification),
assembly via the reader the reactors decode from.

The part payload here is the block's canonical JSON wire form (our
allowed wire format); the PartSetHeader hash is the RFC-6962 merkle
root over the chunks, so a proposal's BlockID commits to the exact
bytes every part must prove membership in. 64 KiB parts match the
reference's BlockPartSizeBytes (types/params.go).

The port's copy of the JAX package's types/part_set.py.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.types.block_id import PartSetHeader

BLOCK_PART_SIZE = 65536  # types/params.go BlockPartSizeBytes


class PartSetError(Exception):
    pass


@dataclass
class Part:
    index: int
    data: bytes
    proof: merkle.Proof

    # log2(PartSet.MAX_TOTAL): a valid RFC-6962 proof over <=2^20 leaves
    # never needs more aunts than this, so anything longer is garbage the
    # receiver would otherwise buffer unverified (proof.go ValidateBasic).
    MAX_AUNTS = 20

    def validate_basic(self) -> None:
        if self.index < 0:
            raise PartSetError("negative part index")
        if len(self.data) == 0 or len(self.data) > BLOCK_PART_SIZE:
            raise PartSetError("bad part size")
        if self.proof.index != self.index:
            raise PartSetError("part/proof index mismatch")
        if not 0 < self.proof.total <= PartSet.MAX_TOTAL:
            raise PartSetError("part proof total out of range")
        if len(self.proof.leaf_hash) != 32:
            raise PartSetError("bad proof leaf hash length")
        if len(self.proof.aunts) > self.MAX_AUNTS:
            raise PartSetError("too many proof aunts")
        if any(len(a) != 32 for a in self.proof.aunts):
            raise PartSetError("bad proof aunt length")

    def to_j(self) -> dict:
        return {
            "i": self.index,
            "d": self.data.hex(),
            "pf": {
                "t": self.proof.total,
                "lh": self.proof.leaf_hash.hex(),
                "a": [a.hex() for a in self.proof.aunts],
            },
        }

    @classmethod
    def from_j(cls, j: dict) -> "Part":
        idx = int(j["i"])
        pf = j["pf"]
        return cls(idx, bytes.fromhex(j["d"]), merkle.Proof(
            int(pf["t"]), idx, bytes.fromhex(pf["lh"]),
            [bytes.fromhex(a) for a in pf["a"]],
        ))


@dataclass
class PartSet:
    header_: PartSetHeader
    parts: List[Optional[Part]]
    _count: int = 0
    _byte_size: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_data(cls, data: bytes,
                  part_size: int = BLOCK_PART_SIZE) -> "PartSet":
        """Split `data` into parts with inclusion proofs
        (part_set.go:214 NewPartSetFromData)."""
        chunks = [data[i:i + part_size]
                  for i in range(0, len(data), part_size)] or [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        parts: List[Optional[Part]] = [
            Part(i, chunk, proofs[i]) for i, chunk in enumerate(chunks)
        ]
        ps = cls(PartSetHeader(len(chunks), root), parts)
        ps._count = len(chunks)
        ps._byte_size = len(data)
        return ps

    # hard allocation guard for attacker-supplied headers; callers with
    # real size knowledge (consensus reactor) apply tighter caps
    MAX_TOTAL = 1 << 20

    @classmethod
    def from_header(cls, header: PartSetHeader) -> "PartSet":
        """Empty set awaiting parts (part_set.go:234)."""
        if not 0 < header.total <= cls.MAX_TOTAL:
            raise PartSetError(f"part count {header.total} out of range")
        return cls(header, [None] * header.total)

    # -- receive side --------------------------------------------------------

    def add_part(self, part: Part) -> bool:
        """Verify the part's proof against our header and slot it in
        (part_set.go:314). Returns False for duplicates; raises on an
        invalid part."""
        part.validate_basic()
        with self._lock:
            if part.index >= self.header_.total:
                raise PartSetError(
                    f"part index {part.index} out of range "
                    f"(total {self.header_.total})"
                )
            if part.proof.total != self.header_.total:
                raise PartSetError("part proof total mismatch")
            if self.parts[part.index] is not None:
                return False
            if not part.proof.verify(self.header_.hash, part.data):
                raise PartSetError("invalid part proof")
            self.parts[part.index] = part
            self._count += 1
            self._byte_size += len(part.data)
            return True

    def has(self, index: int) -> bool:
        with self._lock:
            return 0 <= index < len(self.parts) \
                and self.parts[index] is not None

    def is_complete(self) -> bool:
        with self._lock:
            return self._count == self.header_.total

    def assemble(self) -> bytes:
        """The original data, once complete."""
        with self._lock:
            if self._count != self.header_.total:
                raise PartSetError("part set incomplete")
            return b"".join(p.data for p in self.parts)

    # -- introspection -------------------------------------------------------

    def header(self) -> PartSetHeader:
        return self.header_

    def count(self) -> int:
        with self._lock:
            return self._count

    def total(self) -> int:
        return self.header_.total

    def byte_size(self) -> int:
        with self._lock:
            return self._byte_size

    def bit_array(self) -> BitArray:
        """Which parts we hold (gossip bookkeeping, part_set.go:265)."""
        with self._lock:
            ba = BitArray(self.header_.total)
            for i, p in enumerate(self.parts):
                if p is not None:
                    ba.set_index(i, True)
            return ba

    def get_part(self, index: int) -> Optional[Part]:
        with self._lock:
            if 0 <= index < len(self.parts):
                return self.parts[index]
            return None


def make_block_parts(block, part_size: int = BLOCK_PART_SIZE) -> PartSet:
    """Split a block's canonical wire form into a PartSet
    (types/block.go:140 MakePartSet)."""
    from cometbft_tpu_torch.types import serde

    return PartSet.from_data(
        serde.block_to_json(block).encode(), part_size
    )
