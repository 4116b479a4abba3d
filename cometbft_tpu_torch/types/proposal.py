"""Proposal: a signed block proposal for (height, round).

Reference: types/proposal.go (Proposal struct :20-34, SignBytes :105-118
via CanonicalizeProposal, ValidateBasic :47).

The port's copy of the JAX package's types/proposal.py; the sign
bytes are the JAX package's, byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.timestamp import Timestamp


class ProposalError(Exception):
    pass


@dataclass
class Proposal:
    height: int
    round: int
    pol_round: int  # -1 if no proof-of-lock
    block_id: BlockID
    timestamp: Timestamp
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.canonical_proposal_bytes(
            chain_id, self.height, self.round, self.pol_round,
            self.block_id, self.timestamp,
        )

    def verify(self, chain_id: str, pub_key) -> bool:
        return pub_key.verify_signature(
            self.sign_bytes(chain_id), self.signature
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ProposalError("negative Height")
        if self.round < 0:
            raise ProposalError("negative Round")
        if self.pol_round < -1 or self.pol_round >= self.round:
            raise ProposalError("POLRound out of range")
        if not self.block_id.is_complete():
            raise ProposalError("expected a complete BlockID")
        if not self.signature or len(self.signature) > 64:
            raise ProposalError("bad signature size")
