"""Commit and CommitSig: the aggregated precommits carried in a block.

Reference: types/block.go:595-646 (CommitSig, BlockIDFlag), :836-1030
(Commit, GetVote, VoteSignBytes :871-883). Only the Timestamp differs
between validators' signed messages — the property the batched device
verifier exploits (all sign-bytes share structure, SURVEY.md §2.2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.block_id import NIL_BLOCK_ID, BlockID
from cometbft_tpu_torch.types.timestamp import Timestamp, ZERO
from cometbft_tpu_torch.types.vote import Vote

# BlockIDFlag (types/block.go:52-62)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


class CommitError(Exception):
    pass


@dataclass
class CommitSig:
    flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Timestamp = ZERO
    signature: bytes = b""

    @staticmethod
    def absent() -> "CommitSig":
        return CommitSig()

    def is_absent(self) -> bool:
        return self.flag == BLOCK_ID_FLAG_ABSENT

    def is_commit(self) -> bool:
        return self.flag == BLOCK_ID_FLAG_COMMIT

    def for_block(self) -> bool:
        return self.flag == BLOCK_ID_FLAG_COMMIT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this sig signed over (types/block.go:672-686)."""
        if self.flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        return NIL_BLOCK_ID

    def validate_basic(self) -> None:
        if self.flag not in (
            BLOCK_ID_FLAG_ABSENT,
            BLOCK_ID_FLAG_COMMIT,
            BLOCK_ID_FLAG_NIL,
        ):
            raise CommitError(f"unknown BlockIDFlag {self.flag}")
        if self.is_absent():
            if self.validator_address or self.signature:
                raise CommitError("absent sig must be empty")
        else:
            if len(self.validator_address) != tmhash.TRUNCATED_SIZE:
                raise CommitError("invalid validator address size")
            if not self.signature:
                raise CommitError("signature is missing")
            if len(self.signature) > 64:
                raise CommitError("signature too big")


@dataclass
class Commit:
    height: int
    round: int
    block_id: BlockID
    signatures: List[CommitSig]

    def size(self) -> int:
        return len(self.signatures)

    def get_vote(self, val_idx: int) -> Vote:
        """Reconstruct validator val_idx's precommit (block.go:848-869)."""
        cs = self.signatures[val_idx]
        return Vote(
            vote_type=canonical.PRECOMMIT_TYPE,
            height=self.height,
            round=self.round,
            block_id=cs.block_id(self.block_id),
            timestamp=cs.timestamp,
            validator_address=cs.validator_address,
            validator_index=val_idx,
            signature=cs.signature,
        )

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """The bytes validator val_idx signed (block.go:880-883).

        Uses per-commit template encoders (only the timestamp and the
        nil-vote flag vary across a commit's signatures) — this loop runs
        once per signature in every verification path."""
        cs = self.signatures[val_idx]
        enc = getattr(self, "_sb_enc", None)
        if enc is None or enc[0] != chain_id:
            enc = (
                chain_id,
                canonical.CanonicalVoteEncoder(
                    chain_id, canonical.PRECOMMIT_TYPE, self.height,
                    self.round, self.block_id,
                ),
                canonical.CanonicalVoteEncoder(
                    chain_id, canonical.PRECOMMIT_TYPE, self.height,
                    self.round, None,
                ),
            )
            self._sb_enc = enc
        bid = cs.block_id(self.block_id)
        use_nil = bid is None or bid.is_nil()
        return enc[2 if use_nil else 1].bytes_for(cs.timestamp)

    def sign_bytes_template(self, chain_id: str) -> tuple:
        """The (for-block, for-nil) VoteRowTemplates of this commit —
        everything but the timestamp is invariant across its signatures.
        Cached per (commit, chain_id) like the splice encoders."""
        tmpl = getattr(self, "_sb_tmpl", None)
        if tmpl is None or tmpl[0] != chain_id:
            from cometbft_tpu_torch.types.vote import sign_bytes_template

            tmpl = (
                chain_id,
                sign_bytes_template(chain_id, canonical.PRECOMMIT_TYPE,
                                    self.height, self.round, self.block_id),
                sign_bytes_template(chain_id, canonical.PRECOMMIT_TYPE,
                                    self.height, self.round, None),
            )
            self._sb_tmpl = tmpl
        return tmpl[1], tmpl[2]

    def sign_bytes_rows(self, chain_id: str,
                        idxs: Optional[List[int]] = None) -> List[bytes]:
        """Vectorized `vote_sign_bytes` for many signatures at once: the
        per-row Python encode loop of the verification paths becomes two
        numpy template patches (for-block rows + nil rows). Byte-equal to
        [self.vote_sign_bytes(chain_id, i) for i in idxs] — the template-
        packing hot path of types/validation.py."""
        import numpy as np

        if idxs is None:
            idxs = range(len(self.signatures))
        idxs = list(idxs)
        tmpl_b, tmpl_n = self.sign_bytes_template(chain_id)
        sigs = self.signatures
        nil = np.asarray(
            [not sigs[i].is_commit() for i in idxs], np.bool_
        )
        secs = np.asarray([sigs[i].timestamp.seconds for i in idxs],
                          np.int64)
        nanos = np.asarray([sigs[i].timestamp.nanos for i in idxs],
                           np.int64)
        out: List[bytes] = [b""] * len(idxs)
        for tmpl, mask in ((tmpl_b, ~nil), (tmpl_n, nil)):
            where = np.flatnonzero(mask)
            if where.size == 0:
                continue
            rows = tmpl.patch_rows(secs[where], nanos[where]).tolist()
            for k, row in zip(where, rows):
                out[int(k)] = row
        return out

    def validate_basic(self) -> None:
        """block.go:893-917."""
        if self.height < 0:
            raise CommitError("negative Height")
        if self.round < 0:
            raise CommitError("negative Round")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise CommitError("commit cannot be for nil block")
            if not self.signatures:
                raise CommitError("no signatures in commit")
            for cs in self.signatures:
                cs.validate_basic()

    def hash(self) -> bytes:
        """Merkle root over proto-encoded CommitSigs (block.go:921)."""
        from cometbft_tpu_torch.crypto import merkle
        from cometbft_tpu_torch.libs import protoenc as pe

        leaves = []
        for cs in self.signatures:
            body = pe.f_varint(1, cs.flag)
            body += pe.f_bytes(2, cs.validator_address)
            body += pe.f_msg(3, pe.timestamp(
                cs.timestamp.seconds, cs.timestamp.nanos
            ))
            body += pe.f_bytes(4, cs.signature)
            leaves.append(body)
        return merkle.hash_from_byte_slices(leaves)


@dataclass
class ExtendedCommitSig:
    """CommitSig + the validator's vote extension
    (types/block.go:714-722 ExtendedCommitSig)."""

    commit_sig: CommitSig = field(default_factory=CommitSig)
    extension: bytes = b""
    extension_signature: bytes = b""

    def validate_basic(self, extensions_enabled: bool) -> None:
        self.commit_sig.validate_basic()
        if extensions_enabled and self.commit_sig.is_commit():
            if not self.extension_signature:
                raise CommitError(
                    "vote extension signature missing on commit sig"
                )
        elif self.extension or self.extension_signature:
            if not extensions_enabled or not self.commit_sig.is_commit():
                raise CommitError("unexpected vote extension")


@dataclass
class ExtendedCommit:
    """A Commit that retains each precommit's vote extension
    (types/block.go:646-768 ExtendedCommit) — persisted as the seen
    commit when extensions are enabled so the next proposer can hand
    them to PrepareProposal (store/store.go:254)."""

    height: int
    round: int
    block_id: BlockID
    extended_signatures: List[ExtendedCommitSig]

    def to_commit(self) -> Commit:
        """StripExtensions (block.go:700)."""
        return Commit(
            self.height, self.round, self.block_id,
            [e.commit_sig for e in self.extended_signatures],
        )

    def get_extended_vote(self, val_idx: int) -> Vote:
        e = self.extended_signatures[val_idx]
        cs = e.commit_sig
        return Vote(
            vote_type=canonical.PRECOMMIT_TYPE,
            height=self.height,
            round=self.round,
            block_id=cs.block_id(self.block_id),
            timestamp=cs.timestamp,
            validator_address=cs.validator_address,
            validator_index=val_idx,
            signature=cs.signature,
            extension=e.extension,
            extension_signature=e.extension_signature,
        )

    def validate_basic(self, extensions_enabled: bool = True) -> None:
        """block.go ExtendedCommit.ValidateBasic: structural commit
        checks + per-sig extension discipline."""
        self.to_commit().validate_basic()
        for e in self.extended_signatures:
            e.validate_basic(extensions_enabled)
