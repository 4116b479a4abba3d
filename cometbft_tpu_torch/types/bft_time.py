"""BFT time: the weighted median of commit timestamps.

Reference: types/time (WeightedMedian) + state/validation.go:123 — a
proposed block's Time must equal the voting-power-weighted median of its
LastCommit's signature timestamps, making block time a BFT quantity no
f < n/3 cabal can drag.

The port's copy of the JAX package's types/bft_time.py.
"""
from __future__ import annotations

from cometbft_tpu_torch.types.commit import Commit
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.validator import ValidatorSet


def median_time(commit: Commit, vals: ValidatorSet) -> Timestamp:
    """MedianTime (types/time/weighted_median.go): weighted median over
    the commit's non-absent signatures, weights = voting power."""
    weighted = []
    total = 0
    for idx, cs in enumerate(commit.signatures):
        if cs.is_absent():
            continue
        val = vals.get_by_index(idx)
        if val is None:
            continue
        weighted.append((cs.timestamp.to_ns(), val.voting_power))
        total += val.voting_power
    if not weighted:
        return Timestamp()

    def from_ns(t):
        return Timestamp(t // 1_000_000_000, t % 1_000_000_000)

    weighted.sort(key=lambda t: t[0])
    half = total // 2
    acc = 0
    for t, w in weighted:
        acc += w
        if acc > half:
            return from_ns(t)
    return from_ns(weighted[-1][0])
