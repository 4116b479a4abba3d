"""Evidence pool: pending/committed evidence with expiry and block
prioritization.

Reference: evidence/pool.go — AddEvidence (:136: verify, dedupe, persist
pending), CheckEvidence (:192: verify proposed-block evidence, reject
committed/expired), PendingEvidence (:87: prioritized for inclusion up to
maxBytes), MarkEvidenceAsCommitted (:110), expiry by age in both height
and time (consensus params EvidenceParams).

The pool carries BOTH evidence kinds of types/evidence.go:
DuplicateVoteEvidence (equivocation, verified against the historical
validator set) and LightClientAttackEvidence (a forged header sealed by
>=1/3 of a common-height set, verified via verify_light_client_attack
over the proof commit the evidence carries). Everything downstream —
gossip (evidence/reactor.py), block inclusion, CheckEvidence on proposed
blocks, mark_committed, ABCI misbehavior — is type-agnostic.

The port's copy of the JAX package's evidence/pool.py. With batch_fn=None
a light-client attack's signatures verify on the running verify plane, or
on the card directly (evidence/verify.py evidence_batch_fn); a
duplicate vote's two signatures verify on the host, as upstream does.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from cometbft_tpu_torch.evidence.verify import (
    verify_duplicate_vote,
    verify_light_client_attack,
)
from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    EvidenceError,
    LightClientAttackEvidence,
)

# consensus params defaults (types/params.go EvidenceParams)
MAX_AGE_NUM_BLOCKS = 100_000
MAX_AGE_SECONDS = 48 * 3600


class EvidencePool:
    def __init__(
        self,
        chain_id: str,
        load_validators: Callable[[int], Optional[object]],
        max_age_blocks: int = MAX_AGE_NUM_BLOCKS,
        max_age_seconds: float = MAX_AGE_SECONDS,
        batch_fn: Optional[Callable] = None,
    ):
        """load_validators(height) -> ValidatorSet at that height (the
        state store's LoadValidators seam). batch_fn feeds the commit
        verification of light-client-attack evidence (None: the verify
        plane when one runs, else the card)."""
        self.chain_id = chain_id
        self.load_validators = load_validators
        self.max_age_blocks = max_age_blocks
        self.max_age_seconds = max_age_seconds
        self.batch_fn = batch_fn
        self._pending: Dict[bytes, object] = {}
        self._committed: dict = {}  # key -> commit height
        # ATTACK-level dedup for light-client attacks: the evidence hash
        # covers the commit proof, and the proof is malleable (different
        # signer subsets / rows past the 1/3 early-exit), so one attack
        # could otherwise re-enter the pool under unlimited distinct
        # hashes — gossip spam and double punishment. Keyed by
        # (conflicting_header_hash, common_height).
        self._pending_attacks: Dict[tuple, bytes] = {}
        self._committed_attacks: dict = {}  # attack key -> (h, t)
        self._lock = threading.Lock()
        self.height = 0  # latest committed block height
        self.time_s = 0  # latest committed block time (seconds)

    # -- intake --------------------------------------------------------------

    def _verify(self, ev) -> None:
        """Type dispatch (pool.go:136 AddEvidence's verify step)."""
        vals = self.load_validators(ev.height)
        if vals is None:
            raise EvidenceError(f"no validator set for height {ev.height}")
        if isinstance(ev, DuplicateVoteEvidence):
            verify_duplicate_vote(ev, self.chain_id, vals)
        elif isinstance(ev, LightClientAttackEvidence):
            # `vals` is the COMMON-height set (ev.height == common_height)
            verify_light_client_attack(
                ev, self.chain_id, vals, batch_fn=self.batch_fn,
            )
        else:
            raise EvidenceError(f"unknown evidence type {type(ev)}")

    @staticmethod
    def _attack_key(ev):
        if isinstance(ev, LightClientAttackEvidence):
            return (ev.conflicting_header_hash, ev.common_height)
        return None

    def _known_locked(self, key, ak) -> bool:
        return (key in self._pending or key in self._committed
                or (ak is not None
                    and (ak in self._pending_attacks
                         or ak in self._committed_attacks)))

    def add_evidence(self, ev) -> bool:
        """AddEvidence (pool.go:136): verify then persist pending.
        Returns False (no raise) for duplicates/committed/expired."""
        key = ev.hash()
        ak = self._attack_key(ev)
        with self._lock:
            if self._known_locked(key, ak) or self._expired_locked(ev):
                return False
        self._verify(ev)
        with self._lock:
            # re-check under the lock: the verify window is unlocked,
            # and the consensus thread may have committed (or another
            # intake raced in) this evidence meanwhile — re-inserting
            # committed evidence would poison our next proposal
            if self._known_locked(key, ak) or self._expired_locked(ev):
                return False
            self._pending[key] = ev
            if ak is not None:
                self._pending_attacks[ak] = key
        return True

    def check_evidence(self, evs: List) -> None:
        """CheckEvidence (pool.go:192): every item of a proposed block
        must verify and be neither committed nor expired; raises on the
        first offender."""
        seen = set()
        seen_attacks = set()
        for ev in evs:
            key = ev.hash()
            ak = self._attack_key(ev)
            if key in seen or (ak is not None and ak in seen_attacks):
                raise EvidenceError("duplicate evidence in block")
            seen.add(key)
            if ak is not None:
                seen_attacks.add(ak)
            with self._lock:
                if key in self._committed or \
                        (ak is not None and ak in self._committed_attacks):
                    raise EvidenceError("evidence already committed")
                if self._expired_locked(ev):
                    raise EvidenceError("evidence expired")
                known = key in self._pending
            if not known:
                self._verify(ev)

    # -- consumption ---------------------------------------------------------

    def pending_evidence(self, max_bytes: int = -1) -> List:
        """PendingEvidence (pool.go:87): oldest-first up to max_bytes."""
        with self._lock:
            evs = sorted(self._pending.values(), key=lambda e: e.height)
        out, total = [], 0
        for ev in evs:
            sz = len(ev.bytes())
            if max_bytes >= 0 and total + sz > max_bytes:
                break
            out.append(ev)
            total += sz
        return out

    def mark_committed(self, height: int, time_s: int, evs: List) -> None:
        """MarkEvidenceAsCommitted + Update (pool.go:110): drop from
        pending, remember committed, advance the expiry frontier."""
        with self._lock:
            self.height = height
            self.time_s = time_s
            for ev in evs:
                key = ev.hash()
                self._committed[key] = (height, time_s)
                self._pending.pop(key, None)
                ak = self._attack_key(ev)
                if ak is not None:
                    self._committed_attacks[ak] = (height, time_s)
                    # a pending VARIANT of the same attack (different
                    # proof bytes, same misbehavior) is punished now too
                    old = self._pending_attacks.pop(ak, None)
                    if old is not None:
                        self._pending.pop(old, None)
            # prune expired pending
            for key in [k for k, e in self._pending.items()
                        if self._expired_locked(e)]:
                del self._pending[key]
            self._pending_attacks = {
                a: k for a, k in self._pending_attacks.items()
                if k in self._pending
            }
            # prune committed markers once the evidence is expired by
            # BOTH bounds (same rule as _expired_locked: age-based
            # rejection only kicks in when block-age AND time-age are
            # exceeded, so dropping a marker earlier would reopen a
            # double-punishment window)
            cutoff_h = height - self.max_age_blocks
            cutoff_t = time_s - self.max_age_seconds
            for key in [k for k, (h, t) in self._committed.items()
                        if h < cutoff_h and t < cutoff_t]:
                del self._committed[key]
            for ak in [a for a, (h, t) in self._committed_attacks.items()
                       if h < cutoff_h and t < cutoff_t]:
                del self._committed_attacks[ak]

    def size(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- expiry ----------------------------------------------------------------

    def _expired_locked(self, ev) -> bool:
        """Evidence is expired only when BOTH age bounds are exceeded
        (pool.go isExpired: height AND time)."""
        if self.height == 0:
            return False
        age_blocks = self.height - ev.height
        age_seconds = self.time_s - ev.timestamp.seconds
        return (age_blocks > self.max_age_blocks
                and age_seconds > self.max_age_seconds)
