"""Light client: trust-period verification with sequential or skipping
(bisection) modes, primary + witness providers, trusted store.

Reference: light/client.go:174 (Client), VerifyLightBlockAtHeight (:474),
verifySequential (:613), verifySkipping (:706: bisection driven by
ErrNewValSetCantBeTrusted), detector.go (witness cross-examination ->
divergence errors), light/store (trusted light-block store).

The expensive inner step — VerifyCommitLight/Trusting over hundreds or
thousands of signatures — runs on the batched device verifier; bisection
turns a 10k-block gap into O(log) fused device passes.

The port's copy of the JAX package's light/client.py. Its commits go
through light/verifier.py, which routes them through the running verify
plane unless the caller passes a batch_fn.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from cometbft_tpu_torch.light.verifier import (
    DEFAULT_TRUST_LEVEL,
    ErrNewValSetCantBeTrusted,
    LightBlock,
    LightClientError,
    header_expired,
    verify_adjacent,
    verify_non_adjacent,
)
from cometbft_tpu_torch.types.timestamp import Timestamp


class NoSuchBlockError(LightClientError):
    """Provider doesn't have the block (yet) — an AVAILABILITY error,
    retryable, unlike verification failures (provider.ErrLightBlockNot
    Found vs the verifier's security errors)."""


class Provider:
    """Light-block source (light/provider/provider.go): an RPC node in the
    reference; any callable source here."""

    def __init__(self, chain_id: str,
                 fetch: Callable[[int], Optional[LightBlock]]):
        self.chain_id = chain_id
        self._fetch = fetch

    def light_block(self, height: int) -> LightBlock:
        lb = self._fetch(height)
        if lb is None:
            raise NoSuchBlockError(
                f"provider has no light block {height}"
            )
        return lb


class DivergenceError(LightClientError):
    """A witness returned a conflicting header (detector.go divergence)."""

    def __init__(self, witness_idx: int, msg: str = ""):
        self.witness_idx = witness_idx
        super().__init__(msg or f"witness {witness_idx} diverged")


class TrustedStore:
    """In-memory trusted light-block store (light/store/db analog).

    Thread-safe: every method takes the store lock, and
    :meth:`lowest_at_or_above` gives concurrent callers (the gateway's
    backwards walks) an atomic anchor scan instead of a racy
    heights()-then-get() sequence."""

    def __init__(self):
        self._blocks: Dict[int, LightBlock] = {}
        self._lock = threading.Lock()

    def save(self, lb: LightBlock) -> None:
        with self._lock:
            self._blocks[lb.height] = lb

    def get(self, height: int) -> Optional[LightBlock]:
        with self._lock:
            return self._blocks.get(height)

    def delete(self, height: int) -> None:
        with self._lock:
            self._blocks.pop(height, None)

    def latest(self) -> Optional[LightBlock]:
        with self._lock:
            if not self._blocks:
                return None
            return self._blocks[max(self._blocks)]

    def heights(self) -> List[int]:
        with self._lock:
            return sorted(self._blocks)

    def lowest_at_or_above(self, height: int) -> Optional[LightBlock]:
        """The stored block with the smallest height >= `height`, read
        atomically (a concurrent delete between a heights() scan and
        the get() would otherwise hand back None mid-walk)."""
        with self._lock:
            above = [h for h in self._blocks if h >= height]
            if not above:
                return None
            return self._blocks[min(above)]


class Client:
    """light.Client (light/client.go:174).

    Thread-safe for concurrent verification (the light-client gateway
    shares ONE client across many serving threads): the store is
    internally locked, the `verifications` counter rides its own lock,
    and the backwards walk anchors atomically. The client lock is NEVER
    held across the device-verify wait inside `_verify_one` — two
    threads bisecting disjoint ranges submit to the verify plane
    concurrently, so their flushes coalesce and overlap. Bisection
    state itself (`cur`, the pivot stack) is method-local; concurrent
    verifications of overlapping ranges duplicate work at worst (the
    gateway's coalescer exists to prevent exactly that), never corrupt
    trust."""

    def __init__(
        self,
        chain_id: str,
        primary: Provider,
        witnesses: Optional[List[Provider]] = None,
        trusting_period: float = 14 * 24 * 3600.0,
        trust_level: Tuple[int, int] = DEFAULT_TRUST_LEVEL,
        max_clock_drift: float = 10.0,
        batch_fn: Optional[Callable] = None,
        skipping: bool = True,
        store: Optional["TrustedStore"] = None,
    ):
        self.chain_id = chain_id
        self.primary = primary
        self.witnesses = witnesses or []
        self.trusting_period = trusting_period
        self.trust_level = trust_level
        self.max_clock_drift = max_clock_drift
        self.batch_fn = batch_fn
        self.skipping = skipping
        # any object with the TrustedStore surface; pass light.store.
        # DBStore for durable trust across restarts (light/store/db/db.go)
        self.store = store if store is not None else TrustedStore()
        # instrumentation for tests/benchmarks (bisection step count);
        # += under _count_lock — concurrent gateway verifies must not
        # lose increments (the coalescing assertions read this)
        self.verifications = 0
        self._count_lock = threading.Lock()
        # per-thread step window (step_count): a gateway leader needs
        # ITS verification's step count, and a delta over the shared
        # counter would absorb concurrent leaders' increments
        self._tl_steps = threading.local()
        # divergence reporting hook: receives LightClientAttackEvidence
        # (detector.go -> full-node evidence submission seam)
        self.on_attack_evidence = None

    def _count_verification(self) -> None:
        with self._count_lock:
            self.verifications += 1
        if getattr(self._tl_steps, "active", False):
            self._tl_steps.steps += 1

    def begin_step_count(self) -> None:
        """Open a per-THREAD verification-step window (concurrency-safe
        where a delta over the shared `verifications` counter is not)."""
        self._tl_steps.active = True
        self._tl_steps.steps = 0

    def end_step_count(self) -> int:
        """Close this thread's window; returns steps counted on it."""
        self._tl_steps.active = False
        return getattr(self._tl_steps, "steps", 0)

    # -- bootstrap ---------------------------------------------------------

    def trust_light_block(self, lb: LightBlock) -> None:
        """Initialize trust from a social-consensus root (light/client.go
        initializeWithTrustOptions analog; hash pinning happens upstream)."""
        lb.validate_basic(self.chain_id)
        self.store.save(lb)

    # -- core API ----------------------------------------------------------

    def verify_light_block_at_height(
        self, height: int, now: Optional[Timestamp] = None
    ) -> LightBlock:
        """VerifyLightBlockAtHeight (light/client.go:474)."""
        now = now or Timestamp.now()
        got = self.store.get(height)
        if got is not None:
            return got
        latest = self.store.latest()
        if latest is None:
            raise LightClientError("no trusted state: call trust_light_block")
        if height <= latest.height:
            # backwards verification (light/client.go:734 backwards):
            # walk DOWN from the earliest trusted header, checking each
            # header's last_block_id hash-links to its parent
            return self._verify_backwards(height, now)
        target = self.primary.light_block(height)
        target.validate_basic(self.chain_id)
        if self.skipping:
            self._verify_skipping(latest, target, now)
        else:
            self._verify_sequential(latest, target, now)
        self._cross_check(target)
        self.store.save(target)
        return target

    def _verify_backwards(self, height: int, now: Timestamp) -> LightBlock:
        """light/client.go:734: headers are trusted backwards through the
        last_block_id hash chain (no signature checks needed — each
        header commits to its parent's hash)."""
        anchor = self.store.lowest_at_or_above(height)
        if anchor is None:
            raise LightClientError("no trusted header above target")
        if header_expired(anchor.signed_header.header,
                          self.trusting_period, now):
            raise LightClientError("trusted anchor expired")
        cur = anchor
        for h in range(anchor.height - 1, height - 1, -1):
            prev = self.primary.light_block(h)
            prev.validate_basic(self.chain_id)
            self._count_verification()
            want = cur.signed_header.header.last_block_id.hash
            if prev.signed_header.header.hash() != want:
                raise LightClientError(
                    f"backwards verification failed at height {h}: header "
                    f"hash does not match last_block_id of height {h + 1}"
                )
            self.store.save(prev)
            cur = prev
        return cur

    # -- verification strategies ------------------------------------------

    def _verify_one(self, trusted: LightBlock, new: LightBlock,
                    now: Timestamp) -> None:
        # counter under its own lock; the verify itself (which may wait
        # on a device flush) runs UNLOCKED so concurrent verifications
        # coalesce into shared plane flushes
        self._count_verification()
        if new.height == trusted.height + 1:
            verify_adjacent(
                self.chain_id, trusted.signed_header, new.signed_header,
                new.validator_set, self.trusting_period, now,
                self.max_clock_drift, self.batch_fn,
            )
        else:
            verify_non_adjacent(
                self.chain_id, trusted.signed_header,
                trusted.validator_set,  # vals at trusted height sign h+1..
                new.signed_header, new.validator_set,
                self.trusting_period, now, self.max_clock_drift,
                self.trust_level, self.batch_fn,
            )

    def _verify_sequential(self, trusted: LightBlock, target: LightBlock,
                           now: Timestamp) -> None:
        """light/client.go:613 verifySequential: walk every height."""
        cur = trusted
        for h in range(trusted.height + 1, target.height):
            nxt = self.primary.light_block(h)
            nxt.validate_basic(self.chain_id)
            self._verify_one(cur, nxt, now)
            self.store.save(nxt)
            cur = nxt
        self._verify_one(cur, target, now)

    def _verify_skipping(self, trusted: LightBlock, target: LightBlock,
                         now: Timestamp) -> None:
        """light/client.go:706 verifySkipping: try the jump; on
        ErrNewValSetCantBeTrusted bisect toward the trusted height."""
        cur = trusted
        pivot_stack: List[LightBlock] = [target]
        while pivot_stack:
            candidate = pivot_stack[-1]
            try:
                self._verify_one(cur, candidate, now)
            except ErrNewValSetCantBeTrusted:
                pivot_h = (cur.height + candidate.height) // 2
                if pivot_h in (cur.height, candidate.height):
                    raise LightClientError(
                        "bisection exhausted: validator set changed too "
                        "much between adjacent heights"
                    )
                pivot = self.primary.light_block(pivot_h)
                pivot.validate_basic(self.chain_id)
                pivot_stack.append(pivot)
                continue
            self.store.save(candidate)
            cur = candidate
            pivot_stack.pop()

    # -- witness cross-examination ----------------------------------------

    def _cross_check(self, verified: LightBlock) -> None:
        """detector.go: compare the verified header against every witness;
        a mismatching header hash is a divergence (fork) signal. The
        conflicting block is turned into LightClientAttackEvidence
        (detector.go -> examineConflictingHeaderAgainstTrace) carrying
        the byzantine signer snapshot, attached to the raised error and
        pushed through on_attack_evidence for submission to full nodes."""
        want = verified.signed_header.header.hash()
        for i, w in enumerate(self.witnesses):
            try:
                alt = w.light_block(verified.height)
            except LightClientError:
                continue  # unresponsive witness is skipped, not fatal
            if alt.signed_header.header.hash() != want:
                ev = self._make_attack_evidence(verified, alt)
                if self.on_attack_evidence is not None and ev is not None:
                    try:
                        self.on_attack_evidence(ev)
                    except Exception:  # noqa: BLE001 - reporter hook
                        pass
                err = DivergenceError(
                    i,
                    f"witness {i} header {alt.signed_header.header.hash()!r}"
                    f" != primary {want!r} at height {verified.height}",
                )
                err.evidence = ev
                raise err

    def _make_attack_evidence(self, verified: LightBlock,
                              conflicting: LightBlock):
        """LightClientAttackEvidence from a conflicting light block
        (types/evidence.go:193): byzantine validators are the conflicting
        commit's signers that are also in the COMMON-height set — full
        nodes verify the evidence against the common set
        (verify_light_client_attack), so the power snapshot and the
        byzantine list must come from that set or legitimate evidence
        is rejected whenever the valset rotated between the common and
        conflicting heights (evidence.go GetByzantineValidators)."""
        from cometbft_tpu_torch.types.evidence import (
            LightClientAttackEvidence,
        )

        commit = conflicting.signed_header.commit
        if commit is None:
            return None
        common = max(
            (h for h in self.store.heights() if h < verified.height),
            default=verified.height,
        )
        common_lb = self.store.get(common)
        common_vals = (common_lb.validator_set if common_lb is not None
                       else verified.validator_set)
        byz = []
        for cs in commit.signatures:
            if not cs.for_block():
                continue
            _, val = common_vals.get_by_address(cs.validator_address)
            if val is not None:
                byz.append(cs.validator_address)
        return LightClientAttackEvidence(
            conflicting_header_hash=conflicting.signed_header.header.hash(),
            conflicting_height=conflicting.height,
            common_height=common,
            byzantine_validators=byz,
            total_voting_power=common_vals.total_voting_power(),
            timestamp=conflicting.signed_header.header.time,
            # attach the proof so full nodes can re-verify the attack
            # (evidence pool -> verify_light_client_attack)
            conflicting_commit=commit,
        )

    # -- maintenance -------------------------------------------------------

    def prune_expired(self, now: Optional[Timestamp] = None) -> int:
        """Drop trusted blocks outside the trusting period."""
        now = now or Timestamp.now()
        dropped = 0
        for h in self.store.heights():
            lb = self.store.get(h)
            if lb and header_expired(
                lb.signed_header.header, self.trusting_period, now
            ):
                self.store.delete(h)
                dropped += 1
        return dropped
