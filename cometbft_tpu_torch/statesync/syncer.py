"""Statesync: bootstrap a fresh node from an application snapshot.

Reference: statesync/syncer.go — SyncAny (:145) discovers snapshots,
offers them to the app (:322 OfferSnapshot), downloads + applies chunks
(:358,:415), verifies the restored app hash against a light block, and
builds the post-restore State; stateprovider.go:40-76 embeds a light
client to fetch trusted headers/validator sets.

The snapshot/chunk transport is pluggable: the p2p reactor
(statesync/p2p_reactor.py) or any provider callable (tests).
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Dict, List, Optional

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.statesync import stats as ss_stats
from cometbft_tpu_torch.types.params import ConsensusParams

_log = logging.getLogger(__name__)


class StateSyncError(Exception):
    pass


class LightStateProvider:
    """stateprovider.go: trusted State + Commit via a light client.

    The light client verifies every header it hands out (bisection from
    a trusted root), so statesync inherits light-client security."""

    def __init__(self, light_client, now=None, params=None):
        self.lc = light_client
        self.now = now
        # ConsensusParams are consensus-critical (vote-extension
        # discipline) but not reconstructible from verified headers
        # (consensus_hash covers only block params) — the operator
        # supplies them from the genesis doc every node holds
        self.params = params or ConsensusParams()

    def state_at(self, height: int) -> State:
        """State after `height` is applied (stateprovider.go State):
        needs light blocks h, h+1, h+2 for last/current/next valsets."""
        lb_last = self.lc.verify_light_block_at_height(height, now=self.now)
        lb_cur = self.lc.verify_light_block_at_height(
            height + 1, now=self.now
        )
        lb_next = self.lc.verify_light_block_at_height(
            height + 2, now=self.now
        )
        hdr = lb_last.signed_header.header
        # the commit's BlockID carries the REAL PartSetHeader the network
        # committed under — a synthetic psh here would fail validate_block's
        # full-BlockID equality against every subsequent block's
        # header.last_block_id (execution.py:139)
        bid = lb_last.signed_header.commit.block_id
        if bid.hash != hdr.hash():
            raise StateSyncError("light block commit/header hash mismatch")
        return State(
            chain_id=hdr.chain_id,
            initial_height=1,
            last_block_height=height,
            last_block_id=bid,
            last_block_time=hdr.time,
            validators=lb_cur.validator_set.copy(),
            next_validators=lb_next.validator_set.copy(),
            last_validators=lb_last.validator_set.copy(),
            last_height_validators_changed=height + 1,
            consensus_params=self.params,
            app_hash=lb_cur.signed_header.header.app_hash,
            last_results_hash=lb_cur.signed_header.header.last_results_hash,
        )

    def commit_at(self, height: int):
        lb = self.lc.verify_light_block_at_height(height, now=self.now)
        return lb.signed_header.commit


class Syncer:
    """SyncAny (syncer.go:145) over pluggable snapshot sources.

    Chunks are fetched in parallel from EVERY peer offering the chosen
    snapshot (statesync/chunks.go engine): a slow or lying provider is
    timed out / punished and its slots re-requested from the others,
    and fetched chunks persist in cache_dir so a restart resumes
    instead of refetching."""

    def __init__(self, app: abci.Application, state_provider,
                 chunk_timeout: float = 10.0,
                 cache_dir: Optional[str] = None):
        self.app = app
        self.state_provider = state_provider
        self.chunk_timeout = chunk_timeout
        self.cache_dir = cache_dir
        # discovery: {(height, format): (snapshot, {provider_id: fetch})}
        self._snapshots: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()
        self._have = threading.Event()

    def add_snapshot(self, snapshot: abci.Snapshot,
                     fetch_chunk: Callable[[int], Optional[bytes]],
                     provider_id: Optional[str] = None) -> None:
        """Register a snapshot offer; multiple peers offering the same
        (height, format) become parallel chunk providers."""
        key = (snapshot.height, snapshot.format)
        with self._lock:
            snap, providers = self._snapshots.get(key, (snapshot, {}))
            providers = dict(providers)
            providers[provider_id or f"p{len(providers)}"] = fetch_chunk
            self._snapshots[key] = (snap, providers)
        self._have.set()

    def sync_any(self, discovery_time: float = 5.0) -> State:
        """Try the best discovered snapshot; on failure fall through to
        the next (syncer.go SyncAny retry loop)."""
        # the discovery deadline ages on the LEDGER clock (virtual
        # under simnet), not wall time — a wall-clock deadline here was
        # the PR 18 satellite bug that made bootstrap replays diverge
        deadline = tracing.monotonic_ns() + discovery_time * 1e9
        attempts: Dict[tuple, int] = {}
        while True:
            with self._lock:
                candidates = sorted(
                    self._snapshots.values(),
                    key=lambda t: -t[0].height,
                )
            for snapshot, providers in candidates:
                key = (snapshot.height, snapshot.format)
                try:
                    return self._sync_one(snapshot, providers)
                except Exception as e:  # noqa: BLE001 - ANY failure falls
                    # through to the next candidate: provider errors are
                    # often transient (e.g. the chain hasn't produced
                    # height+2 yet, which state_at needs), so each
                    # snapshot gets a few tries before being dropped.
                    # The chunk cache is NOT wiped here: _apply_chunks
                    # wipes it itself on content-rejection failures; a
                    # transient pre-fetch error must not throw away
                    # chunks a restarted node already holds.
                    attempts[key] = attempts.get(key, 0) + 1
                    _log.warning("snapshot h=%d failed (try %d): %s",
                                 snapshot.height, attempts[key], e)
                    if attempts[key] >= 3:
                        with self._lock:
                            self._snapshots.pop(key, None)
            if tracing.monotonic_ns() > deadline:
                raise StateSyncError(
                    "no usable snapshot discovered in time"
                )
            self._have.wait(timeout=0.5)
            self._have.clear()

    def _clear_cache(self, snapshot: abci.Snapshot) -> None:
        if not self.cache_dir:
            return
        import shutil

        shutil.rmtree(
            os.path.join(self.cache_dir,
                         f"{snapshot.height}-{snapshot.format}"),
            ignore_errors=True,
        )

    def _apply_chunks(self, snapshot, queue, fetcher, n_providers) -> None:
        """Apply chunks in order, steering by the app's result enum
        (syncer.go:415 applyChunks): RETRY refetches one chunk,
        RETRY_SNAPSHOT restarts the sequence with the suspect chunks
        refetched, ABORT/REJECT fail the snapshot."""
        i = retries = timeouts = rounds = 0
        max_timeouts = (n_providers + 2) * max(1, snapshot.chunks)
        while i < snapshot.chunks:
            chunk = queue.wait_for(i, self.chunk_timeout)
            if chunk is None:
                # a hung fetch must not pin its slot forever
                queue.reclaim_expired(self.chunk_timeout)
                ss_stats.bump("fetch_timeouts")
                timeouts += 1
                if not fetcher.has_providers() or timeouts > max_timeouts:
                    raise StateSyncError(
                        f"chunk {i} unavailable ({timeouts} timeouts)"
                    )
                continue
            sender = queue.sender_of(i) or ""
            resp = self.app.apply_snapshot_chunk(i, chunk, sender)
            if resp is True:
                resp = abci.ResponseApplySnapshotChunk()
            elif resp is False:
                resp = abci.ResponseApplySnapshotChunk(
                    result=abci.APPLY_CHUNK_RETRY
                )
            for s in resp.reject_senders:  # app-identified bad senders
                fetcher.punish(s)
                fetcher.punish(s)  # named rejection = instant drop
            if resp.result == abci.APPLY_CHUNK_ACCEPT:
                ss_stats.bump("chunks_applied")
                i += 1
                retries = 0
                continue
            if resp.result == abci.APPLY_CHUNK_RETRY:
                fetcher.punish(queue.retry(i))
                retries += 1
                if retries > n_providers + 1:
                    self._clear_cache(snapshot)
                    raise StateSyncError(f"app rejected chunk {i}")
                continue
            if resp.result == abci.APPLY_CHUNK_RETRY_SNAPSHOT:
                ss_stats.bump("retry_snapshot_rounds")
                rounds += 1
                if rounds > 3:
                    self._clear_cache(snapshot)
                    raise StateSyncError(
                        "snapshot kept failing verification"
                    )
                # senders of the refetched chunks are suspects (the hash
                # can't name the culprit) — ONE strike per provider per
                # round, or the honest peer that served most chunks
                # would be dropped before the one that poisoned one
                suspects = set()
                for idx in resp.refetch_chunks:
                    suspects.add(queue.retry(idx))
                for s in suspects:
                    fetcher.punish(s)
                if not self.app.offer_snapshot(snapshot):
                    self._clear_cache(snapshot)
                    raise StateSyncError("app closed the restore session")
                i = 0
                continue
            self._clear_cache(snapshot)
            raise StateSyncError(
                f"app aborted snapshot restore (result={resp.result})"
            )

    def _sync_one(self, snapshot: abci.Snapshot, providers) -> State:
        from cometbft_tpu_torch.statesync.chunks import ChunkFetcher, ChunkQueue

        if callable(providers):  # single bare fetch fn (test shims)
            providers = {"p0": providers}
        # trusted target state FIRST: the app hash to verify against
        # comes from the light client, never from the snapshot sender
        state = self.state_provider.state_at(snapshot.height)
        if not self.app.offer_snapshot(snapshot):
            raise StateSyncError("app rejected snapshot offer")
        ss_stats.bump("snapshots_offered")
        cache = None
        if self.cache_dir:
            cache = os.path.join(
                self.cache_dir, f"{snapshot.height}-{snapshot.format}"
            )
        queue = ChunkQueue(snapshot.chunks, cache_dir=cache)
        fetcher = ChunkFetcher(queue, providers,
                               chunk_timeout=self.chunk_timeout)
        fetcher.start()
        try:
            self._apply_chunks(snapshot, queue, fetcher, len(providers))
        finally:
            fetcher.stop()
        # verify the restored app (syncer.go verifyApp): height + hash
        # must match the light-client-trusted header
        info = self.app.info(abci.RequestInfo())
        if info.last_block_height != snapshot.height:
            raise StateSyncError(
                f"app restored height {info.last_block_height}, "
                f"want {snapshot.height}"
            )
        if info.last_block_app_hash != state.app_hash:
            raise StateSyncError(
                "restored app hash does not match trusted header"
            )
        ss_stats.bump("snapshots_restored")
        return state
