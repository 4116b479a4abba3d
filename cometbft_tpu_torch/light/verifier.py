"""Light-client verification: adjacent and non-adjacent (skipping).

Reference: light/verifier.go — VerifyNonAdjacent (:32: trust 1/3+ of the
OLD validator set via VerifyCommitLightTrusting :58, then 2/3+ of the NEW
set via VerifyCommitLight :73), VerifyAdjacent (:93: height+1 link through
next_validators_hash :117), Verify dispatch (:139), plus header sanity
checks (verifyNewHeaderAndVals :170-208) and trusted-header expiry
(HeaderExpired :234).

All signature checking bottoms out in the batched device verifier through
types/validation.py — a 10k-validator light-block verification is two
device passes (the BASELINE config #5 shape).

The port's copy of the JAX package's light/verifier.py. Without an
explicit batch_fn, commits go through the running verify plane
(plane_batch_fn): on a card plane, ed25519 rows take its fused or grouped
path and secp256k1 rows its grouped path (the ECDSA kernel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from cometbft_tpu_torch.types.block import Header
from cometbft_tpu_torch.types.commit import Commit
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.validation import (
    NotEnoughPowerError,
    VerificationError,
    verify_commit_light,
    verify_commit_light_trusting,
)
from cometbft_tpu_torch.types.validator import ValidatorSet

DEFAULT_TRUST_LEVEL = (1, 3)


def _resolve_batch_fn(batch_fn: Optional[Callable]) -> Optional[Callable]:
    """An explicit batch_fn wins; otherwise commits route through the
    running verify plane (cross-caller coalescing) when there is one,
    and fall back to the serial host loop when there isn't."""
    if batch_fn is not None:
        return batch_fn
    from cometbft_tpu_torch.verifyplane import plane_batch_fn

    return plane_batch_fn()


class LightClientError(Exception):
    pass


class ErrOldHeaderExpired(LightClientError):
    pass


class ErrNewValSetCantBeTrusted(LightClientError):
    """< trustLevel of the trusted set signed the new header — triggers
    bisection in the skipping client (light/client.go:729)."""


class ErrInvalidHeader(LightClientError):
    pass


@dataclass
class SignedHeader:
    """Header + the commit that seals it (types/block.go SignedHeader)."""

    header: Header
    commit: Commit

    @property
    def height(self) -> int:
        return self.header.height

    @property
    def time(self) -> Timestamp:
        return self.header.time

    def validate_basic(self, chain_id: str) -> None:
        if self.header.chain_id != chain_id:
            raise ErrInvalidHeader(
                f"header chain_id {self.header.chain_id} != {chain_id}"
            )
        if self.commit.height != self.header.height:
            raise ErrInvalidHeader("commit height != header height")
        if self.commit.block_id.hash != self.header.hash():
            raise ErrInvalidHeader("commit signs a different header")


@dataclass
class LightBlock:
    """SignedHeader + its validator set (types/light.go)."""

    signed_header: SignedHeader
    validator_set: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.height

    @property
    def time(self) -> Timestamp:
        return self.signed_header.time

    def validate_basic(self, chain_id: str) -> None:
        self.signed_header.validate_basic(chain_id)
        if self.validator_set.hash() != \
                self.signed_header.header.validators_hash:
            raise ErrInvalidHeader("validator set doesn't match header")


def header_expired(h: Header, trusting_period: float, now: Timestamp) -> bool:
    """HeaderExpired (light/verifier.go:234). Integer-ns comparison:
    float64 seconds lose ~400 ns of precision at current epochs."""
    return now.to_ns() >= h.time.to_ns() + int(trusting_period * 1e9)


def _check_new_header(
    chain_id: str,
    trusted: SignedHeader,
    untrusted: SignedHeader,
    now: Timestamp,
    max_clock_drift: float,
) -> None:
    """verifyNewHeaderAndVals (light/verifier.go:170-208) header checks."""
    untrusted.validate_basic(chain_id)
    if untrusted.height <= trusted.height:
        raise ErrInvalidHeader(
            f"expected new header height {untrusted.height} > "
            f"trusted {trusted.height}"
        )
    if untrusted.time.to_ns() <= trusted.time.to_ns():
        raise ErrInvalidHeader("new header time <= trusted header time")
    if untrusted.time.to_ns() > now.to_ns() + int(max_clock_drift * 1e9):
        raise ErrInvalidHeader("new header time from the future")


def verify_non_adjacent(
    chain_id: str,
    trusted: SignedHeader,
    trusted_next_vals: ValidatorSet,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float = 10.0,
    trust_level: Tuple[int, int] = DEFAULT_TRUST_LEVEL,
    batch_fn: Optional[Callable] = None,
) -> None:
    """light/verifier.go:32 VerifyNonAdjacent."""
    batch_fn = _resolve_batch_fn(batch_fn)
    if untrusted.height == trusted.height + 1:
        raise LightClientError("headers are adjacent: use verify_adjacent")
    if header_expired(trusted.header, trusting_period, now):
        raise ErrOldHeaderExpired(
            f"trusted header expired at "
            f"{trusted.time.to_ns() // 10**9 + trusting_period}"
        )
    _check_new_header(chain_id, trusted, untrusted, now, max_clock_drift)
    if untrusted_vals.hash() != untrusted.header.validators_hash:
        raise ErrInvalidHeader("untrusted vals hash != header vals hash")

    # 1/3+ of the OLD (trusted) set must have signed the new header
    # (light/verifier.go:58)
    try:
        verify_commit_light_trusting(
            chain_id, trusted_next_vals, untrusted.commit,
            trust_level, batch_fn,
        )
    except NotEnoughPowerError as e:
        raise ErrNewValSetCantBeTrusted(str(e)) from e
    except VerificationError as e:
        raise ErrInvalidHeader(str(e)) from e

    # 2/3+ of the NEW set must have signed it (light/verifier.go:73)
    try:
        verify_commit_light(
            chain_id, untrusted_vals, untrusted.commit.block_id,
            untrusted.height, untrusted.commit, batch_fn,
        )
    except VerificationError as e:
        raise ErrInvalidHeader(str(e)) from e


def verify_adjacent(
    chain_id: str,
    trusted: SignedHeader,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float = 10.0,
    batch_fn: Optional[Callable] = None,
) -> None:
    """light/verifier.go:93 VerifyAdjacent: height+1, linked by
    next_validators_hash (:117)."""
    batch_fn = _resolve_batch_fn(batch_fn)
    if untrusted.height != trusted.height + 1:
        raise LightClientError("headers must be adjacent in height")
    if header_expired(trusted.header, trusting_period, now):
        raise ErrOldHeaderExpired("trusted header expired")
    _check_new_header(chain_id, trusted, untrusted, now, max_clock_drift)
    if untrusted.header.validators_hash != \
            trusted.header.next_validators_hash:
        raise ErrInvalidHeader(
            "new header validators hash doesn't match trusted header's "
            "next validators hash"
        )
    if untrusted_vals.hash() != untrusted.header.validators_hash:
        raise ErrInvalidHeader("untrusted vals hash != header vals hash")
    try:
        verify_commit_light(
            chain_id, untrusted_vals, untrusted.commit.block_id,
            untrusted.height, untrusted.commit, batch_fn,
        )
    except VerificationError as e:
        raise ErrInvalidHeader(str(e)) from e


def verify(
    chain_id: str,
    trusted: SignedHeader,
    trusted_next_vals: ValidatorSet,
    untrusted: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period: float,
    now: Timestamp,
    max_clock_drift: float = 10.0,
    trust_level: Tuple[int, int] = DEFAULT_TRUST_LEVEL,
    batch_fn: Optional[Callable] = None,
) -> None:
    """Verify dispatch (light/verifier.go:139)."""
    if untrusted.height != trusted.height + 1:
        verify_non_adjacent(
            chain_id, trusted, trusted_next_vals, untrusted, untrusted_vals,
            trusting_period, now, max_clock_drift, trust_level, batch_fn,
        )
    else:
        verify_adjacent(
            chain_id, trusted, untrusted, untrusted_vals,
            trusting_period, now, max_clock_drift, batch_fn,
        )
