"""Validator and ValidatorSet: power-sorted set, proposer rotation, hashing.

Reference: types/validator.go (Validator, Bytes :119 SimpleValidator
proto), types/validator_set.go — NewValidatorSet (:70: update +
IncrementProposerPriority(1)), sort order ValidatorsByVotingPower
(:752-763: voting power DESC, address ASC tiebreak — consensus-critical:
it fixes both the merkle hash and the commit-signature index mapping),
GetByAddress (:latest, linear scan — a dict here), TotalVotingPower memo
w/ MaxTotalVotingPower = MaxInt64/8 cap (:25), IncrementProposerPriority
(:116-141) + RescalePriorities (:143), Hash (:347), updateWithChangeSet
(:589-639: compute priorities -> apply -> rescale -> center -> sort).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.crypto.keys import PubKey
from cometbft_tpu_torch.libs import protoenc as pe

MAX_TOTAL_VOTING_POWER = (2**63 - 1) // 8  # validator_set.go:25
PRIORITY_WINDOW_SIZE_FACTOR = 2  # validator_set.go:31


class ValidatorSetError(Exception):
    pass


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int
    address: bytes = b""
    proposer_priority: int = 0

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()

    def bytes(self) -> bytes:
        """SimpleValidator proto bytes — the merkle leaf for valset Hash
        (types/validator.go:119). PublicKey oneof: ed25519 = field 1,
        secp256k1 = field 2 (proto/tendermint/crypto/keys.proto)."""
        key_field = 1 if self.pub_key.key_type == "ed25519" else 2
        pk_body = pe.f_bytes(key_field, self.pub_key.data)
        return pe.f_msg(1, pk_body) + pe.f_varint(2, self.voting_power)

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; ties break by lower address
        (validator.go:83 CompareProposerPriority)."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        return self if self.address < other.address else other


def _power_sort_key(v: Validator):
    """ValidatorsByVotingPower Less: power desc, address asc."""
    return (-v.voting_power, v.address)


class ValidatorSet:
    """Power-sorted validator list with memoized total power.

    NOT thread-safe (mirrors the reference; callers hold their own locks).
    """

    def __init__(self, validators: Sequence[Validator]):
        # NewValidatorSet semantics (validator_set.go:70-79): genesis
        # validators all receive the same initial priority (equal after
        # centering -> 0), then one priority increment seats the proposer.
        vals = sorted(validators, key=_power_sort_key)
        self.validators: List[Validator] = vals
        self._index: Dict[bytes, int] = {}
        self._reindex()
        self._total_power: Optional[int] = None
        self.proposer: Optional[Validator] = None
        if vals:
            self._update_total_voting_power()
            self.increment_proposer_priority(1)

    def _reindex(self) -> None:
        idx = {v.address: i for i, v in enumerate(self.validators)}
        if len(idx) != len(self.validators):
            raise ValidatorSetError("duplicate validator address")
        self._index = idx

    # -- queries -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.validators)

    def is_nil_or_empty(self) -> bool:
        return len(self.validators) == 0

    def get_by_address(
        self, address: bytes
    ) -> Tuple[int, Optional[Validator]]:
        i = self._index.get(address, -1)
        return (i, self.validators[i]) if i >= 0 else (-1, None)

    def get_by_index(self, idx: int) -> Optional[Validator]:
        if 0 <= idx < len(self.validators):
            return self.validators[idx]
        return None

    def has_address(self, address: bytes) -> bool:
        return address in self._index

    def total_voting_power(self) -> int:
        if self._total_power is None:
            self._update_total_voting_power()
        return self._total_power

    def _update_total_voting_power(self) -> None:
        total = 0
        for v in self.validators:
            total += v.voting_power
            if total > MAX_TOTAL_VOTING_POWER:
                raise ValidatorSetError(
                    "total voting power exceeds MaxTotalVotingPower"
                )
        self._total_power = total

    def hash(self) -> bytes:
        """Merkle root of SimpleValidator leaves (validator_set.go:347)."""
        return merkle.hash_from_byte_slices(
            [v.bytes() for v in self.validators]
        )

    # -- proposer rotation ---------------------------------------------------

    def _find_proposer(self) -> Validator:
        best = self.validators[0]
        for v in self.validators[1:]:
            best = best.compare_proposer_priority(v)
        return best

    def get_proposer(self) -> Optional[Validator]:
        if not self.validators:
            return None
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer

    def increment_proposer_priority(self, times: int) -> None:
        """validator_set.go:116-141: rescale into the priority window,
        center around zero, then `times` rounds of priority bumping."""
        if self.is_nil_or_empty():
            raise ValidatorSetError("empty validator set")
        if times <= 0:
            raise ValidatorSetError("times must be positive")
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self._rescale_priorities(diff_max)
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_once()
        self.proposer = proposer

    def _increment_once(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = _safe_add(
                v.proposer_priority, v.voting_power
            )
        mostest = self._find_proposer()
        mostest.proposer_priority -= self.total_voting_power()
        return mostest

    def _rescale_priorities(self, diff_max: int) -> None:
        if diff_max <= 0:
            return
        prios = [v.proposer_priority for v in self.validators]
        diff = max(prios) - min(prios)
        if diff > diff_max:
            ratio = (diff + diff_max - 1) // diff_max
            for v in self.validators:
                v.proposer_priority = _int_div_go(v.proposer_priority, ratio)

    def _shift_by_avg_proposer_priority(self) -> None:
        n = len(self.validators)
        avg = sum(v.proposer_priority for v in self.validators)
        avg = _int_div_go(avg, n)
        for v in self.validators:
            v.proposer_priority = _safe_sub(v.proposer_priority, avg)

    # -- updates (epoch changes via ABCI) -------------------------------------

    def copy(self) -> "ValidatorSet":
        vs = ValidatorSet.__new__(ValidatorSet)
        vs.validators = [replace(v) for v in self.validators]
        vs._index = dict(self._index)
        vs._total_power = self._total_power
        vs.proposer = None
        if self.proposer is not None:
            i = self._index.get(self.proposer.address, -1)
            vs.proposer = (
                vs.validators[i] if i >= 0 else replace(self.proposer)
            )
        return vs

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        vs = self.copy()
        vs.increment_proposer_priority(times)
        return vs

    def update_with_change_set(self, changes: Sequence[Validator]) -> None:
        """Apply adds/updates (power > 0) and removals (power == 0) —
        validator_set.go:589-639: new validators start at
        -1.125 * (total power after updates, before removals); then
        rescale, center, and re-sort by power."""
        if not changes:
            return
        seen: Dict[bytes, Validator] = {}
        for c in changes:
            if c.voting_power < 0:
                raise ValidatorSetError("negative voting power")
            if c.address in seen:
                raise ValidatorSetError("duplicate address in changes")
            seen[c.address] = c

        removals = [a for a, c in seen.items() if c.voting_power == 0]
        for a in removals:
            if not self.has_address(a):
                raise ValidatorSetError("removing a validator not in the set")

        by_addr = {v.address: replace(v) for v in self.validators}
        # total voting power after updates, BEFORE removals — the priority
        # basis for new validators (validator_set.go:443 verifyUpdates +
        # computeNewPriorities)
        tvp_after_updates = sum(v.voting_power for v in by_addr.values())
        for a, c in seen.items():
            if c.voting_power == 0:
                continue
            prev = by_addr[a].voting_power if a in by_addr else 0
            tvp_after_updates += c.voting_power - prev
        if tvp_after_updates > MAX_TOTAL_VOTING_POWER:
            raise ValidatorSetError("updates exceed MaxTotalVotingPower")

        new_prio = -(tvp_after_updates + (tvp_after_updates >> 3))
        for a, c in seen.items():
            if c.voting_power == 0:
                continue
            if a in by_addr:
                by_addr[a].voting_power = c.voting_power
            else:
                by_addr[a] = Validator(c.pub_key, c.voting_power, a, new_prio)
        for a in removals:
            del by_addr[a]

        vals = sorted(by_addr.values(), key=_power_sort_key)
        if not vals:
            raise ValidatorSetError("validator set is empty after update")
        self.validators = vals
        self._reindex()
        self._total_power = None
        self._update_total_voting_power()
        self._rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        )
        self._shift_by_avg_proposer_priority()
        self.proposer = None


def _int_div_go(a: int, b: int) -> int:
    """Go integer division truncates toward zero; Python floors."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


_I64_MAX = 2**63 - 1
_I64_MIN = -(2**63)


def _safe_add(a: int, b: int) -> int:
    """Saturating int64 add (validator_set.go safeAddClip)."""
    return max(_I64_MIN, min(_I64_MAX, a + b))


def _safe_sub(a: int, b: int) -> int:
    return max(_I64_MIN, min(_I64_MAX, a - b))
