"""Vote: a prevote/precommit for a block, with canonical sign-bytes.

Reference: types/vote.go (struct :72-84, VoteSignBytes :139, Verify :224,
ValidateBasic :284), types/canonical.go.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.timestamp import Timestamp, ZERO

MAX_VOTES_COUNT = 10000  # types/vote_set.go:18


def sign_bytes_template(chain_id: str, vote_type: int, height: int,
                        round_: int,
                        block_id: Optional[BlockID]) -> "canonical.VoteRowTemplate":
    """The vectorized sign-bytes builder for one (chain, type, height,
    round, block_id): votes in a commit differ only in timestamp, so the
    invariant parts encode once and `patch_rows(secs, nanos)` stamps any
    number of per-validator timestamps in a few numpy passes —
    byte-identical to per-vote `Vote.sign_bytes`."""
    return canonical.VoteRowTemplate(chain_id, vote_type, height, round_,
                                     block_id)


class VoteError(Exception):
    pass


@dataclass
class Vote:
    vote_type: int  # PREVOTE_TYPE or PRECOMMIT_TYPE
    height: int
    round: int
    block_id: BlockID  # nil BlockID = vote for nil
    timestamp: Timestamp
    validator_address: bytes
    validator_index: int
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        """The exact signed bytes (types/vote.go:139 VoteSignBytes)."""
        return canonical.canonical_vote_bytes(
            chain_id,
            self.vote_type,
            self.height,
            self.round,
            self.block_id,
            self.timestamp,
        )

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        return canonical.canonical_vote_extension_bytes(
            chain_id, self.height, self.round, self.extension
        )

    def verify(self, chain_id: str, pub_key) -> None:
        """Single-vote verification (types/vote.go:224). Raises VoteError."""
        if pub_key.address() != self.validator_address:
            raise VoteError("invalid validator address")
        if not pub_key.verify_signature(
            self.sign_bytes(chain_id), self.signature
        ):
            raise VoteError("invalid signature")

    def verify_extension(self, chain_id: str, pub_key) -> None:
        """Verify the extension signature (types/vote.go:233
        VerifyExtension). Raises VoteError."""
        if not self.extension_signature:
            raise VoteError("missing vote extension signature")
        if not pub_key.verify_signature(
            self.extension_sign_bytes(chain_id), self.extension_signature
        ):
            raise VoteError("invalid vote extension signature")

    def verify_with_extension(self, chain_id: str, pub_key) -> None:
        """Verify the vote AND its extension signature in one pass
        (types/vote.go VerifyVoteAndExtension): both sign-bytes are
        staged, then both signatures checked in a single loop — the
        host-path counterpart of submitting both to the verify plane
        as one batch. Raises VoteError naming the failing signature."""
        if pub_key.address() != self.validator_address:
            raise VoteError("invalid validator address")
        if not self.extension_signature:
            raise VoteError("missing vote extension signature")
        checks = (
            (self.sign_bytes(chain_id), self.signature,
             "invalid signature"),
            (self.extension_sign_bytes(chain_id), self.extension_signature,
             "invalid vote extension signature"),
        )
        for msg, sig, err in checks:
            if not pub_key.verify_signature(msg, sig):
                raise VoteError(err)

    def validate_basic(self) -> None:
        """types/vote.go:284 ValidateBasic."""
        if self.vote_type not in (
            canonical.PREVOTE_TYPE,
            canonical.PRECOMMIT_TYPE,
        ):
            raise VoteError("invalid Type")
        if self.height < 0:
            raise VoteError("negative Height")
        if self.round < 0:
            raise VoteError("negative Round")
        if not self.block_id.is_nil() and not self.block_id.is_complete():
            raise VoteError("blockID must be either empty or complete")
        if len(self.validator_address) != tmhash.TRUNCATED_SIZE:
            raise VoteError("invalid validator address size")
        if self.validator_index < 0:
            raise VoteError("negative ValidatorIndex")
        if not self.signature:
            raise VoteError("signature is missing")
        if len(self.signature) > 64:
            raise VoteError("signature too big")
        if self.vote_type == canonical.PREVOTE_TYPE and (
            self.extension or self.extension_signature
        ):
            raise VoteError("unexpected vote extension on prevote")

    def is_nil(self) -> bool:
        return self.block_id.is_nil()
