"""Consensus parameters (minimal working subset).

Reference: types/params.go (ConsensusParams, DefaultConsensusParams,
HashConsensusParams :hash over proto HashedParams{BlockMaxBytes,
BlockMaxGas}).

The port's copy of the JAX package's types/params.py: the same hash,
so a header's consensus_hash is equal in both packages.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.libs import protoenc as pe


@dataclass
class BlockParams:
    max_bytes: int = 22020096  # 21MB (params.go DefaultBlockParams)
    max_gas: int = -1


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 10**9
    max_bytes: int = 1048576


@dataclass
class ValidatorParams:
    pub_key_types: tuple = ("ed25519",)


@dataclass
class ABCIParams:
    """params.go ABCIParams: vote extensions are REQUIRED on non-nil
    precommits at heights >= enable_height, forbidden below; 0 means
    never enabled."""

    vote_extensions_enable_height: int = 0


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    abci: ABCIParams = field(default_factory=ABCIParams)

    def extensions_enabled(self, height: int) -> bool:
        """params.go VoteExtensionsEnabled."""
        e = self.abci.vote_extensions_enable_height
        return e > 0 and height >= e

    def hash(self) -> bytes:
        """SHA256 of proto HashedParams (params.go HashConsensusParams)."""
        body = pe.f_varint(1, self.block.max_bytes) + pe.f_varint(
            2, self.block.max_gas
        )
        return hashlib.sha256(body).digest()

    def to_j(self) -> dict:
        return {
            "block": {"max_bytes": self.block.max_bytes,
                      "max_gas": self.block.max_gas},
            "evidence": {
                "max_age_num_blocks": self.evidence.max_age_num_blocks,
                "max_age_duration_ns": self.evidence.max_age_duration_ns,
                "max_bytes": self.evidence.max_bytes,
            },
            "validator": {
                "pub_key_types": list(self.validator.pub_key_types)
            },
            "abci": {
                "vote_extensions_enable_height":
                    self.abci.vote_extensions_enable_height
            },
        }

    @staticmethod
    def from_j(j: Optional[dict]) -> "ConsensusParams":
        if not j:
            return ConsensusParams()
        b, e = j.get("block", {}), j.get("evidence", {})
        v, a = j.get("validator", {}), j.get("abci", {})
        return ConsensusParams(
            block=BlockParams(**{**BlockParams().__dict__, **b}),
            evidence=EvidenceParams(**{**EvidenceParams().__dict__, **e}),
            validator=ValidatorParams(
                pub_key_types=tuple(v.get("pub_key_types", ("ed25519",)))
            ),
            abci=ABCIParams(**{**ABCIParams().__dict__, **a}),
        )
