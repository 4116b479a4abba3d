"""Blocksync reactor: catch up by streaming historical blocks through the
fused batch verifier, then hand off to consensus.

Reference: blocksync/reactor.go — poolRoutine (:286) peeks consecutive
blocks, verifies the first via the second's LastCommit
(`VerifyCommitLight`, :463), applies through the BlockExecutor (:513),
bans peers serving bad blocks (:480-496), switches to consensus when
caught up (:391-401).

TPU restructuring: instead of one VerifyCommitLight per block, a RUN of
consecutive ready blocks is verified in one fused multi-commit device
pass (pipeline.StreamVerifier). Validator-set changes mid-run are
handled by re-verifying from the height where the set changed — the
optimistic batch is correct whenever the set is stable, which is the
overwhelmingly common case in replay.

The port's copy of the JAX package's blocksync/reactor.py. One seam
differs: with no stream_verifier given, runs verify in a StreamVerifier
on the card (the port's default device; a run under its min_device_sigs
rows on the host, as in the JAX package), where the JAX reactor defaults
to a StreamVerifier that does not use its Pallas kernel. A node hands its
own verifier in (node/node.py: its device, or the host for a host
node)."""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from cometbft_tpu_torch.blocksync.pipeline import CommitJob, StreamVerifier
from cometbft_tpu_torch.blocksync.pool import BlockPool
from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.store.blockstore import BlockStore
from cometbft_tpu_torch.types.block import Block

MAX_RUN = 64  # blocks fused per device pass (64 x 1k sigs fills a bucket)

fp.register("blocksync.process",
            "a run of verified-ready blocks about to be processed "
            "(raise = transient local verify/apply fault; the loop "
            "retries without banning the serving peers)")


class BlocksyncReactor(BaseService):
    def __init__(
        self,
        state: State,
        block_exec: BlockExecutor,
        block_store: BlockStore,
        stream_verifier: Optional[StreamVerifier] = None,
        on_caught_up: Optional[Callable[[State], None]] = None,
        poll_interval: float = 0.02,
    ):
        super().__init__("BlocksyncReactor")
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.pool = BlockPool(state.last_block_height + 1)
        self.verifier = stream_verifier or StreamVerifier()
        self.on_caught_up = on_caught_up
        self.poll_interval = poll_interval
        self.banned_peers: List[str] = []
        self.on_ban = None  # p2p hook: disconnect a banned peer
        # If no peer is ahead of us after this many seconds, declare
        # caught-up (reactor.go:391's switch-to-consensus timer): a fresh
        # network where everyone is at genesis must not wait forever.
        self.grace = 3.0
        self._thread: Optional[threading.Thread] = None

    # -- service -----------------------------------------------------------

    def on_start(self) -> None:
        self._thread = threading.Thread(
            target=self._pool_routine, daemon=True, name="blocksync"
        )
        self._thread.start()

    def on_stop(self) -> None:
        if self._thread:
            self._thread.join(timeout=5)

    # -- peer API (wired by p2p or tests) ----------------------------------

    def add_peer(self, peer_id: str, height: int,
                 request: Callable[[int], None]) -> None:
        self.pool.set_peer_range(peer_id, height, request)

    def receive_block(self, peer_id: str, block: Block) -> None:
        if tracing.enabled():
            tracing.instant("blocksync.block_received", cat="blocksync",
                            height=block.header.height, peer=peer_id)
        self.pool.add_block(peer_id, block)

    # -- the sync loop -----------------------------------------------------

    def _pool_routine(self) -> None:
        """poolRoutine (reactor.go:286)."""
        started = time.time()
        peerless_since = started
        while self.is_running():
            self.pool.make_requests()
            elapsed = time.time() - started
            if self.pool.num_peers() > 0:
                peerless_since = time.time()
                # peers known: caught up when nobody is ahead (after a
                # short grace so statuses can land)
                done = self.pool.is_caught_up() or (
                    elapsed > self.grace
                    and self.pool.max_peer_height()
                    <= self.state.last_block_height
                )
            else:
                # zero peers: wait longer before giving up — declaring
                # caught-up on an empty pool mid-handshake would strand
                # a lagging node in consensus (the lonely-node arm keeps
                # single-validator operation bootable). The clock runs
                # from when peers VANISHED, not reactor start (timeout
                # eviction can empty a mid-sync pool), and a node that
                # ever saw a higher advertised tip must not declare
                # done below it — wait for peers to re-register via
                # their next status instead.
                done = (
                    time.time() - peerless_since > max(self.grace, 10.0)
                    and self.state.last_block_height
                    >= self.pool.max_seen_height() - 1
                )
            if done:
                if self.on_caught_up:
                    self.on_caught_up(self.state)
                return
            # need blocks h..h+k AND h+k+1 (its LastCommit seals h+k)
            run = self.pool.peek_blocks(MAX_RUN + 1)
            if len(run) < 2:
                time.sleep(self.poll_interval)
                continue
            try:
                self._process_run(run)
            except Exception:  # noqa: BLE001 - local store/app failure
                import traceback

                traceback.print_exc()
                time.sleep(max(self.poll_interval, 0.25))  # retry, no ban

    def _process_run(self, run: List[Block]) -> None:
        """Verify blocks run[0..n-2] using each successor's LastCommit in
        one fused pass, then apply them in order."""
        fp.fail_point("blocksync.process")
        n = len(run) - 1
        jobs = []
        for i in range(n):
            first, second = run[i], run[i + 1]
            jobs.append(CommitJob(
                vals=self.state.validators,  # optimistic: stable valset
                block_id=first.block_id(),
                height=first.header.height,
                commit=second.last_commit,
                chain_id=self.state.chain_id,
            ))
        with tracing.span("blocksync.verify_run", cat="blocksync",
                          blocks=n, from_height=run[0].header.height):
            results = self.verifier.verify(jobs)
        # staleness marker: bumps exactly when a validator update lands
        # (state/execution.py _update_state). Once it moves, every
        # remaining job in the run was packed against a stale set and is
        # re-verified individually (epoch changes are rare in replay).
        pack_marker = self.state.last_height_validators_changed

        for i in range(n):
            first, second = run[i], run[i + 1]
            if self.state.last_height_validators_changed != pack_marker:
                redo = self.verifier.verify([CommitJob(
                    vals=self.state.validators,
                    block_id=first.block_id(),
                    height=first.header.height,
                    commit=second.last_commit,
                    chain_id=self.state.chain_id,
                )])
                results[i] = redo[0]
            if results[i] is not None:
                self._punish_pair(first.header.height)
                return  # stop the run; loop re-requests and retries
            try:
                self.block_exec.validate_block(self.state, first)
            except Exception:
                # validation failure = the peers fed us a bad block
                self._punish_pair(first.header.height)
                return
            # persistence/apply failures are LOCAL (disk errors, app
            # bugs): punishing the serving peers here would strip an
            # honest node of its sync peers (round-2 advisory). Let the
            # error surface; the run retries without banning.
            with tracing.span("blocksync.apply", cat="blocksync",
                              height=first.header.height):
                self.block_store.save_block(first, second.last_commit)
                self.state = self.block_exec.apply_block(
                    self.state, first.block_id(), first
                )
            self.pool.pop_block()

    def _punish_pair(self, height: int) -> None:
        """Either block of the failed (h, h+1) pair may be the bad one:
        the reference redoes and punishes BOTH sides
        (blocksync/reactor.go:480-496) — banning only h's server would let
        a malicious h+1 LastCommit get honest peers banned one by one."""
        peers = {self.pool.peer_of(height), self.pool.peer_of(height + 1)}
        self.pool.redo_block(height)
        self.pool.redo_block(height + 1)
        for peer in peers - {None}:
            self.pool.ban_peer(peer)
            self.banned_peers.append(peer)
            if self.on_ban is not None:
                self.on_ban(peer)

    # -- introspection -----------------------------------------------------

    def height(self) -> int:
        return self.state.last_block_height

    def wait_caught_up(self, timeout: float = 60.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.pool.is_caught_up() or not self.is_running():
                return True
            time.sleep(0.02)
        return False
