"""HeightVoteSet: all VoteSets (prevotes + precommits per round) for one
height.

Reference: consensus/types/height_vote_set.go:41-60 (round -> {prevotes,
precommits}, lazy round creation, peer catchup rounds).

The port's copy of the JAX package's consensus/height_vote_set.py. One
seam differs: `device` is handed to every VoteSet, which verifies on
that device when no verify plane runs (types/vote_set.py); None keeps
the VoteSet's serial host path, as in the JAX package.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.types.vote_set import VoteSet


class HeightVoteSet:
    def __init__(self, chain_id: str, height: int, valset: ValidatorSet,
                 ext_enabled: bool = False, device=None):
        self.chain_id = chain_id
        self.height = height
        self.valset = valset
        self.ext_enabled = ext_enabled
        self.device = device
        self._lock = threading.Lock()
        self._rounds: Dict[int, Dict[int, VoteSet]] = {}
        self.round = 0
        # propagated to every VoteSet (existing + lazily created): the
        # verify-plane flush-seq observer the height ledger joins on
        self.on_flush = None
        self.set_round(0)

    def set_on_flush(self, fn) -> None:
        """Install the flush-seq observer on every vote set of this
        height — the rounds already allocated AND the ones
        _ensure_round creates later."""
        with self._lock:
            self.on_flush = fn
            for sets in self._rounds.values():
                for vs in sets.values():
                    vs.on_flush = fn

    def _ensure_round(self, round_: int) -> None:
        """Allocate vote sets for round_ WITHOUT advancing self.round —
        peer catch-up allocation must not ratchet the round bound."""
        if round_ not in self._rounds:
            sets = {
                canonical.PREVOTE_TYPE: VoteSet(
                    self.chain_id, self.height, round_,
                    canonical.PREVOTE_TYPE, self.valset,
                    device=self.device,
                ),
                canonical.PRECOMMIT_TYPE: VoteSet(
                    self.chain_id, self.height, round_,
                    canonical.PRECOMMIT_TYPE, self.valset,
                    ext_enabled=self.ext_enabled, device=self.device,
                ),
            }
            for vs in sets.values():
                vs.on_flush = self.on_flush
            self._rounds[round_] = sets

    def set_round(self, round_: int) -> None:
        """Advance the consensus round; only the engine entering a new
        round moves the bound (height_vote_set.go:90 SetRound)."""
        with self._lock:
            for r in range(self.round, round_ + 2):
                self._ensure_round(r)
            self.round = max(self.round, round_)

    def add_vote(self, vote: Vote, verify: bool = True) -> bool:
        # peers may be at most one round ahead of the CONSENSUS round
        # (height_vote_set.go ErrGotVoteFromUnwantedRound); checked before
        # any allocation, and add_vote never advances the bound — else a
        # sequence of crafted future-round votes allocates without limit
        with self._lock:
            if vote.round > self.round + 1:
                return False
            self._ensure_round(vote.round)
            vs = self._rounds[vote.round][vote.vote_type]
        return vs.add_vote(vote, verify=verify)

    def prevotes(self, round_: int) -> Optional[VoteSet]:
        with self._lock:
            self._ensure_round(round_)
            return self._rounds[round_][canonical.PREVOTE_TYPE]

    def precommits(self, round_: int) -> Optional[VoteSet]:
        with self._lock:
            self._ensure_round(round_)
            return self._rounds[round_][canonical.PRECOMMIT_TYPE]

    def pol_info(self):
        """Highest round with a prevote 2/3 majority (POLRound, POLBlockID)."""
        with self._lock:
            for r in sorted(self._rounds.keys(), reverse=True):
                maj = self._rounds[r][canonical.PREVOTE_TYPE].two_thirds_majority()
                if maj is not None:
                    return r, maj
        return -1, None
