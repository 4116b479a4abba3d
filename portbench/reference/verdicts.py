"""The outcome each driven path owes, worked out from the inputs alone.

- A validator set's order: CometBFT's ValidatorsByVotingPower (power
  descending, then address ascending; an ed25519 address is the first 20
  bytes of SHA-256 of the key).
- `VerifyCommitLight` (types/validation.go): signatures for the block are
  collected in set order until their power passes 2/3 of the set's total;
  at or under it the commit fails for power, before any signature is
  checked; else the first collected signature that does not verify is
  blamed.
- A vote quorum group: it tallies the power of the votes that verify,
  and reaches quorum at its threshold.

A verdict is None (accepted), ("InvalidSignatureError", index) or
("NotEnoughPowerError",).
"""
from __future__ import annotations

import hashlib
from typing import Iterable, List, Optional, Sequence, Tuple

BAD_SIG = "InvalidSignatureError"
LOW_POWER = "NotEnoughPowerError"


def address(pub: bytes) -> bytes:
    return hashlib.sha256(pub).digest()[:20]


def valset_order(pubs: Sequence[bytes], powers: Sequence[int]) -> List[int]:
    """Indices of the validators in set order."""
    return sorted(range(len(pubs)),
                  key=lambda i: (-powers[i], address(pubs[i])))


def two_thirds(powers: Iterable[int]) -> int:
    return sum(powers) * 2 // 3


def light_collect(powers: Sequence[int], present: Sequence[bool]
                  ) -> Tuple[List[int], int, int]:
    """(collected signature indices, their power, power needed)."""
    needed = two_thirds(powers)
    idxs, tallied = [], 0
    for i, (p, here) in enumerate(zip(powers, present)):
        if not here:
            continue
        idxs.append(i)
        tallied += p
        if tallied > needed:
            break
    return idxs, tallied, needed


def light_verdict(idxs: Sequence[int], tallied: int, needed: int,
                  invalid) -> Optional[tuple]:
    if tallied <= needed:
        return (LOW_POWER,)
    for i in idxs:
        if i in invalid:
            return (BAD_SIG, i)
    return None


def group_tally(powers: Sequence[int], invalid) -> int:
    """The power a quorum group holds once every vote of the set was
    submitted once."""
    return sum(p for i, p in enumerate(powers) if i not in invalid)
