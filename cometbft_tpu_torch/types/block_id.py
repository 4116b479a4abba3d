"""BlockID and PartSetHeader.

Reference: types/block.go:1044-1125 (BlockID, PartSetHeader), with
IsNil/IsComplete semantics used by vote/commit validation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.crypto import tmhash


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        """True for the zero BlockID (a nil-vote's target)."""
        return len(self.hash) == 0 and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (
            len(self.hash) == tmhash.SIZE
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == tmhash.SIZE
        )

    def key(self) -> bytes:
        """Map key for vote bookkeeping (types/vote_set.go votesByBlock)."""
        return (
            self.hash
            + self.part_set_header.total.to_bytes(4, "big")
            + self.part_set_header.hash
        )


NIL_BLOCK_ID = BlockID()
