"""Evidence types: equivocation and light-client attacks.

Reference: types/evidence.go — DuplicateVoteEvidence (:33: two conflicting
votes from one validator at the same H/R/type, with TotalVotingPower /
ValidatorPower / Timestamp snapshotted for light-client verifiability),
LightClientAttackEvidence (:193: a conflicting light block + the common
height and byzantine validators), ABCI conversion (:88-103), hashing.

The port's copy of the JAX package's types/evidence.py.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import List, Optional

from cometbft_tpu_torch.types import serde
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.vote import Vote

MAX_EVIDENCE_BYTES = 444  # types/evidence.go MaxEvidenceBytes (duplicate)


class EvidenceError(Exception):
    pass


@dataclass
class DuplicateVoteEvidence:
    """Two conflicting votes (same validator, height, round, type,
    different block IDs) — types/evidence.go:33."""

    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: Timestamp = field(default_factory=Timestamp)

    @staticmethod
    def from_votes(vote1: Vote, vote2: Vote, block_time: Timestamp,
                   total_power: int, val_power: int
                   ) -> "DuplicateVoteEvidence":
        """NewDuplicateVoteEvidence (:47): vote_a is the lexically smaller
        block ID so the evidence hash is order-independent."""
        if vote1.block_id.key() <= vote2.block_id.key():
            a, b = vote1, vote2
        else:
            a, b = vote2, vote1
        return DuplicateVoteEvidence(a, b, total_power, val_power,
                                     block_time)

    @property
    def height(self) -> int:
        return self.vote_a.height

    def bytes(self) -> bytes:
        """Canonical encoding (hash input)."""
        return json.dumps({
            "t": "duplicate_vote",
            "a": serde.vote_to_j(self.vote_a),
            "b": serde.vote_to_j(self.vote_b),
            "tvp": self.total_voting_power,
            "vp": self.validator_power,
            "ts": serde.ts_to_j(self.timestamp),
        }, sort_keys=True).encode()

    def hash(self) -> bytes:
        return hashlib.sha256(self.bytes()).digest()

    def validate_basic(self) -> None:
        a, b = self.vote_a, self.vote_b
        if a is None or b is None:
            raise EvidenceError("empty duplicate vote evidence")
        if a.block_id.is_nil() and b.block_id.is_nil():
            # at least one must be for a real block? The reference only
            # requires the pair differ; nil-vs-block is valid equivocation
            pass
        if (a.height, a.round, a.vote_type) != (b.height, b.round,
                                                b.vote_type):
            raise EvidenceError("votes are for different H/R/type")
        if a.validator_address != b.validator_address:
            raise EvidenceError("votes are from different validators")
        if a.block_id.key() == b.block_id.key():
            raise EvidenceError("votes are for the same block ID")
        if a.block_id.key() > b.block_id.key():
            raise EvidenceError("votes not in canonical order")


@dataclass
class LightClientAttackEvidence:
    """A conflicting light block presented to a light client
    (types/evidence.go:193). Carried with the common height and the
    byzantine validator snapshot.

    `conflicting_commit` is the attached PROOF: the +1/3 commit sealing
    the forged header (the reference carries the whole ConflictingBlock,
    and hashes it — evidence.go LightClientAttackEvidence.Hash covers
    ConflictingBlock). The proof IS part of bytes()/hash() here too:
    were it excluded, a relayer could strip or corrupt the proof
    without changing the evidence hash, making one block's
    evidence_hash verify on nodes that already hold the evidence
    pending and fail on nodes seeing it fresh — honest nodes
    disagreeing about one block hash."""

    conflicting_header_hash: bytes
    conflicting_height: int
    common_height: int
    byzantine_validators: List[bytes] = field(default_factory=list)
    total_voting_power: int = 0
    timestamp: Timestamp = field(default_factory=Timestamp)
    conflicting_commit: Optional[object] = None  # types.commit.Commit

    @property
    def height(self) -> int:
        return self.common_height

    def bytes(self) -> bytes:
        j = {
            "t": "light_client_attack",
            "h": self.conflicting_header_hash.hex(),
            "ch": self.conflicting_height,
            "common": self.common_height,
            "byz": [a.hex() for a in self.byzantine_validators],
            "tvp": self.total_voting_power,
            "ts": serde.ts_to_j(self.timestamp),
        }
        if self.conflicting_commit is not None:
            j["commit"] = serde.commit_to_j(self.conflicting_commit)
        return json.dumps(j, sort_keys=True).encode()

    def hash(self) -> bytes:
        return hashlib.sha256(self.bytes()).digest()

    def validate_basic(self) -> None:
        if self.common_height <= 0 or self.conflicting_height <= 0:
            raise EvidenceError("non-positive heights")
        if self.common_height > self.conflicting_height:
            raise EvidenceError("common height after conflicting height")
        if len(self.conflicting_header_hash) != 32:
            raise EvidenceError("bad conflicting header hash")


Evidence = object  # DuplicateVoteEvidence | LightClientAttackEvidence


def evidence_to_j(ev) -> dict:
    if isinstance(ev, DuplicateVoteEvidence):
        return json.loads(ev.bytes().decode())
    if isinstance(ev, LightClientAttackEvidence):
        # bytes() already carries the proof commit (hash-covered)
        return json.loads(ev.bytes().decode())
    raise EvidenceError(f"unknown evidence type {type(ev)}")


def evidence_from_j(j: dict):
    if j["t"] == "duplicate_vote":
        return DuplicateVoteEvidence(
            serde.vote_from_j(j["a"]), serde.vote_from_j(j["b"]),
            j["tvp"], j["vp"], serde.ts_from_j(j["ts"]),
        )
    if j["t"] == "light_client_attack":
        return LightClientAttackEvidence(
            bytes.fromhex(j["h"]), j["ch"], j["common"],
            [bytes.fromhex(a) for a in j["byz"]], j["tvp"],
            serde.ts_from_j(j["ts"]),
            conflicting_commit=serde.commit_from_j(j.get("commit")),
        )
    raise EvidenceError(f"unknown evidence tag {j.get('t')!r}")
