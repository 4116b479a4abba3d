"""Evidence verification.

Reference: evidence/verify.go — VerifyDuplicateVote (:166: votes well-
formed + conflicting, validator was in the set at that height, powers
match the historical snapshot, both signatures valid),
VerifyLightClientAttack (:110: common-height commit still trusted via
VerifyCommitLightTrusting, conflicting header sealed by VerifyCommitLight
— both riding the batched device verifier).

The port's copy of the JAX package's evidence/verify.py. Two seams differ:
without an explicit batch_fn, commit signatures verify on the running
verify plane, or on the card directly when none runs (never on the host);
and the named byzantine validators' signatures are checked as ONE
batch_fn call (one device launch on the card) instead of one host verify
a row. The verdict and the error (the first forged address, in the named
order, with the same text) are the reference's.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    EvidenceError,
    LightClientAttackEvidence,
)
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.types.vote import VoteError


def evidence_batch_fn(batch_fn: Optional[Callable] = None) -> Callable:
    """The batch_fn evidence verification uses: an explicit one wins;
    otherwise rows go to the running verify plane (CONSENSUS lane), or to
    the card directly when no plane runs. A device plane that cannot take
    the rows (stopped, full) verifies them on its own device; a host
    plane (use_device=False) on the host; a DeviceError propagates."""
    if batch_fn is not None:
        return batch_fn
    from cometbft_tpu_torch.verifyplane.plane import consensus_batch_fn

    return consensus_batch_fn()


def verify_duplicate_vote(
    ev: DuplicateVoteEvidence,
    chain_id: str,
    vals: ValidatorSet,
) -> None:
    """evidence/verify.go:166. `vals` is the validator set AT the evidence
    height (state store LoadValidators)."""
    ev.validate_basic()
    _, val = vals.get_by_address(ev.vote_a.validator_address)
    if val is None:
        raise EvidenceError(
            f"validator {ev.vote_a.validator_address.hex()} not in set at "
            f"height {ev.height}"
        )
    # power snapshots must match the historical set (verify.go:203-215)
    if ev.validator_power != val.voting_power:
        raise EvidenceError(
            f"validator power mismatch: evidence {ev.validator_power}, "
            f"set {val.voting_power}"
        )
    if ev.total_voting_power != vals.total_voting_power():
        raise EvidenceError(
            f"total power mismatch: evidence {ev.total_voting_power}, "
            f"set {vals.total_voting_power()}"
        )
    try:
        ev.vote_a.verify(chain_id, val.pub_key)
        ev.vote_b.verify(chain_id, val.pub_key)
    except VoteError as e:
        raise EvidenceError(f"invalid signature on evidence vote: {e}")


def verify_light_client_attack(
    ev: LightClientAttackEvidence,
    chain_id: str,
    common_vals: ValidatorSet,
    conflicting_commit=None,
    conflicting_vals: Optional[ValidatorSet] = None,
    trust_level=(1, 3),
    batch_fn: Optional[Callable] = None,
) -> None:
    """evidence/verify.go:110: the conflicting header must be sealed by
    (a) >=1/3 of the common-height set (VerifyCommitLightTrusting,
    :123) and (b) 2/3+ of its own claimed set (VerifyCommitLight, :135).

    `conflicting_commit` defaults to the proof the evidence carries
    (ev.conflicting_commit); the evidence pool and reactor verify
    gossiped / block-included attacks through exactly this path. The
    named byzantine validators must be members of the common-height set
    AND signers of the conflicting commit (verify.go:150-186's
    getByzantineValidators contract — naming an innocent validator makes
    the evidence invalid, it must not reach the app's slashing logic)."""
    from cometbft_tpu_torch.types import validation

    ev.validate_basic()
    if conflicting_commit is None:
        conflicting_commit = ev.conflicting_commit
    if conflicting_commit is None:
        raise EvidenceError(
            "light client attack evidence carries no conflicting commit"
        )
    # the proof must actually be about the claimed conflicting header
    if conflicting_commit.height != ev.conflicting_height:
        raise EvidenceError(
            f"conflicting commit height {conflicting_commit.height} != "
            f"evidence conflicting height {ev.conflicting_height}"
        )
    if conflicting_commit.block_id.hash != ev.conflicting_header_hash:
        raise EvidenceError(
            "conflicting commit seals a different header than the "
            "evidence claims"
        )
    if ev.total_voting_power != common_vals.total_voting_power():
        raise EvidenceError(
            f"total power mismatch: evidence {ev.total_voting_power}, "
            f"common set {common_vals.total_voting_power()}"
        )
    try:
        conflicting_commit.validate_basic()
    except Exception as e:  # noqa: BLE001 - malformed proof commit
        raise EvidenceError(f"malformed conflicting commit: {e}")
    # Each NAMED byzantine validator's commit signature is verified
    # DIRECTLY here: the trusting verification below early-exits once
    # 1/3 of power is tallied, so a commit row past that point is never
    # examined — an unverified membership check would let an attacker
    # append a forged for_block row naming an INNOCENT validator and
    # have the slashing pipeline punish them. The rows are verified as
    # one batch: the membership walk stops at its first error, the rows
    # named before it verify together, and the first forged one among
    # them is raised ahead of that error, as the one-by-one walk does.
    batch_fn = evidence_batch_fn(batch_fn)
    sig_row = {
        cs.validator_address: idx
        for idx, cs in enumerate(conflicting_commit.signatures)
        if cs.for_block()
    }
    named, walk_err = [], None
    for addr in ev.byzantine_validators:
        _, val = common_vals.get_by_address(addr)
        if val is None:
            walk_err = EvidenceError(
                f"byzantine validator {addr.hex()} not in common set at "
                f"height {ev.common_height}"
            )
            break
        idx = sig_row.get(addr)
        if idx is None:
            walk_err = EvidenceError(
                f"byzantine validator {addr.hex()} did not sign the "
                f"conflicting header"
            )
            break
        named.append((addr, val, idx))
    if named:
        idxs = [idx for _, _, idx in named]
        ok = np.asarray(batch_fn(
            [val.pub_key for _, val, _ in named],
            conflicting_commit.sign_bytes_rows(chain_id, idxs),
            [conflicting_commit.signatures[i].signature for i in idxs],
        ), np.bool_)[: len(named)]
        if not ok.all():
            addr = named[int(np.argmin(ok))][0]
            raise EvidenceError(
                f"byzantine validator {addr.hex()} named with a FORGED "
                f"conflicting-commit signature"
            )
    if walk_err is not None:
        raise walk_err
    try:
        validation.verify_commit_light_trusting(
            chain_id, common_vals, conflicting_commit, trust_level,
            batch_fn,
        )
    except validation.VerificationError as e:
        raise EvidenceError(
            f"conflicting commit fails trusting verification: {e}"
        )
    if conflicting_vals is not None:
        try:
            validation.verify_commit_light(
                chain_id, conflicting_vals, conflicting_commit.block_id,
                conflicting_commit.height, conflicting_commit, batch_fn,
            )
        except validation.VerificationError as e:
            raise EvidenceError(
                f"conflicting commit fails light verification against "
                f"its claimed set: {e}"
            )
