"""The Tendermint consensus state machine.

Reference: consensus/state.go — the single-threaded receiveRoutine
(:774-862) consuming peer/internal/timeout queues with WAL-write-before-
process (:820-828); step functions enterNewRound (:1042), enterPropose
(:1129), defaultDoPrevote (:1360), enterPrevote (:1311), enterPrecommit
(:1513), enterCommit (:1648), finalizeCommit (:1739); vote ingest
tryAddVote/addVote (:2110,:2161); own votes via signAddVote (:2452);
crash recovery catchupReplay (replay.go:94).

Prevote locking implements the full rule set including POL-based
unlocking (arXiv alg. lines 22-33; see _default_do_prevote). Messages
reach peers via a pluggable broadcast callback so the same machine runs
single-node, multi-node-in-process (in-memory hub), or over a real
transport.

The port's copy of the JAX package's consensus/state.py: the same step
machine, WAL records and failpoints. Its seams:

  * `device` goes to each height's HeightVoteSet: with no running
    verify plane, votes verify on that device (types/vote_set.py); None
    is the VoteSet's serial host path, as in the JAX package.
  * Three single signatures stay host verifies (PubKey.verify_signature,
    crypto/ed25519_ref for ed25519), as in the JAX package: the
    proposal's, one a height and round (_set_proposal); a straggler
    precommit's, at most one a validator a height (_note_straggler);
    and with vote extensions on, a peer precommit's vote and extension
    signatures before the app sees the extension, two a precommit
    (_try_add_vote).
  * A DeviceError out of VoteSet.add_vote (a device plane's faulting
    flush, an open breaker) is neither a ConflictingVoteError nor a
    VoteSetError: it reaches the receive routine's catch-all, which
    prints it, and the vote is not admitted. An unverified vote is not
    an invalid one; the JAX plane would have answered from the host
    (ROADMAP C1).
"""
from __future__ import annotations

import json
import logging
import queue
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from cometbft_tpu_torch.consensus import heightledger
from cometbft_tpu_torch.consensus import wal as walmod
from cometbft_tpu_torch.consensus.height_vote_set import HeightVoteSet
from cometbft_tpu_torch.libs import controller as controlplane
from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.libs import incidents
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.consensus.ticker import (
    ManualTicker,
    TimeoutInfo,
    TimeoutParams,
    TimeoutTicker,
)
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.store.blockstore import BlockStore
from cometbft_tpu_torch.types import canonical, serde
from cometbft_tpu_torch.types.block import Block
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.commit import Commit
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.types.vote_set import (
    ConflictingVoteError,
    VoteSetError,
)

_log = logging.getLogger(__name__)

# The WAL-write-before-process discipline (state.go:820) is exactly
# what crash recovery relies on — these points let the recovery matrix
# kill the node on either side of each durable write (libs/fail's
# call sites in the reference consensus state).
fp.register("consensus.wal.pre_vote", "before a vote is WAL-synced")
fp.register("consensus.wal.post_vote", "after a vote is WAL-synced")
fp.register("consensus.wal.pre_proposal",
            "before a proposal is WAL-synced")
fp.register("consensus.wal.post_proposal",
            "after a proposal is WAL-synced")
fp.register("consensus.pre_finalize",
            "decided block about to be persisted + applied")
fp.register("consensus.post_block_save",
            "block persisted, ENDHEIGHT not yet written")

# RoundStep* (consensus/types/round_state.go:12-24)
STEP_NEW_HEIGHT = 1
STEP_NEW_ROUND = 2
STEP_PROPOSE = 3
STEP_PREVOTE = 4
STEP_PREVOTE_WAIT = 5
STEP_PRECOMMIT = 6
STEP_PRECOMMIT_WAIT = 7
STEP_COMMIT = 8

STEP_NAMES = {
    STEP_NEW_HEIGHT: "new_height", STEP_NEW_ROUND: "new_round",
    STEP_PROPOSE: "propose", STEP_PREVOTE: "prevote",
    STEP_PREVOTE_WAIT: "prevote_wait", STEP_PRECOMMIT: "precommit",
    STEP_PRECOMMIT_WAIT: "precommit_wait", STEP_COMMIT: "commit",
}

# the height ledger keeps its own numeric copies of the step ids it
# stamps (import-lightness); they must never drift from this module's
assert heightledger.STEP_PREVOTE == STEP_PREVOTE
assert heightledger.STEP_PRECOMMIT == STEP_PRECOMMIT
assert heightledger.STEP_COMMIT == STEP_COMMIT


@dataclass
class ProposalMsg:
    proposal: Proposal
    block: Block  # whole block rides with the proposal in this slice


@dataclass
class VoteMsg:
    vote: Vote


class ConsensusState(BaseService):
    """One validator's consensus engine instance."""

    def __init__(
        self,
        state: State,
        block_exec: BlockExecutor,
        block_store: BlockStore,
        privval=None,
        wal_path: Optional[str] = None,
        broadcast: Optional[Callable] = None,
        manual_ticker: bool = False,
        timeouts: Optional[TimeoutParams] = None,
        device=None,
    ):
        super().__init__("ConsensusState")
        # where votes verify when no verify plane runs (None: the
        # VoteSet's serial host path)
        self.device = device
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.privval = privval
        self.broadcast = broadcast or (lambda msg: None)
        self.timeouts = timeouts or TimeoutParams()

        self.msg_queue: "queue.Queue" = queue.Queue(maxsize=1000)
        self.internal_queue: "queue.Queue" = queue.Queue(maxsize=1000)
        ticker_cls = ManualTicker if manual_ticker else TimeoutTicker
        self.ticker = ticker_cls(self._on_timeout)

        self.wal = walmod.WAL(wal_path) if wal_path else None
        self._wal_path = wal_path

        # round state (consensus/types/round_state.go)
        self.height = state.last_block_height + 1
        self.round = 0
        self.step = STEP_NEW_HEIGHT
        self.proposal: Optional[Proposal] = None
        self.proposal_block: Optional[Block] = None
        self.locked_round = -1
        self.locked_block: Optional[Block] = None
        self.valid_round = -1
        self.valid_block: Optional[Block] = None
        self.votes = self._new_height_vote_set(state, self.height)
        self.commit_round = -1
        self._triggered_precommit_wait = False
        self._thread: Optional[threading.Thread] = None

        # test override hooks (state.go:122-125 decideProposal/doPrevote)
        self.decide_proposal_fn = self._default_decide_proposal
        self.do_prevote_fn = self._default_do_prevote
        # reactor hook: fired on height/round/step changes so peers learn
        # our position (reactor.go:404 broadcastNewRoundStepMessage)
        self.on_step_change: Optional[Callable] = None
        # fired whenever a vote is ADDED to our sets (HasVote gossip)
        self.on_vote_added: Optional[Callable] = None
        # evidence wiring (node/node.go:369 evidence pool into consensus):
        # conflicting votes become DuplicateVoteEvidence; on_evidence lets
        # the evidence reactor gossip what we found locally
        self.evidence_pool = None
        self.on_evidence: Optional[Callable] = None
        # observability (consensus/metrics.go:24-91 analog); set by Node
        self.metrics = None
        # votes dropped by the cheap pre-WAL admission filter (the
        # garbage-flood shield; see _vote_prefilter)
        self.prefilter_drops = 0
        self._last_commit_walltime = 0.0
        self._step_entered_at = 0.0  # real-clock step-duration anchor
        # set when a SimulatedCrash failpoint killed the machine
        self.crashed = False
        # always-on per-height commit-latency ledger (/dump_heights);
        # written from _set_step transitions + finalize on the receive
        # routine, stamps on the ledger clock (virtual under simnet)
        self.height_ledger = heightledger.HeightLedger()

    # ---------------------------------------------------------------------
    # service lifecycle
    # ---------------------------------------------------------------------

    def on_start(self) -> None:
        # register as THE process height ledger (/dump_heights, metric
        # sampling, incident snapshots); the _LAST half of the pattern
        # keeps history served after stop, like the verify plane's
        heightledger.set_global_ledger(self.height_ledger)
        if self._wal_path:
            self._catchup_replay()
        self._thread = threading.Thread(
            target=self._receive_routine, daemon=True,
            name=f"consensus-h{self.height}",
        )
        self._thread.start()
        self._schedule_round0()

    def on_stop(self) -> None:
        heightledger.clear_global_ledger(self.height_ledger)
        self.ticker.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.wal:
            self.wal.close()

    def _schedule_round0(self) -> None:
        self.internal_queue.put(("start_round", self.height, 0))

    def _new_height_vote_set(self, state: State,
                             height: int) -> HeightVoteSet:
        hvs = HeightVoteSet(
            state.chain_id, height, state.validators,
            ext_enabled=state.consensus_params.extensions_enabled(height),
            device=self.device,
        )
        # flush-seq join: vote submissions that rode the verify plane
        # report the flush that served them, so /dump_heights can
        # attribute per-height verify-plane ms against /dump_flushes
        hvs.set_on_flush(self._note_plane_flush)
        return hvs

    def _note_plane_flush(self, seq: int) -> None:
        self.height_ledger.note_flush_seq(seq)

    def reset_to_state(self, state: State) -> None:
        """Adopt a state produced by a sync path (blocksync/statesync)
        BEFORE starting — the SwitchToConsensus seam (reactor.go:115)."""
        assert not self.is_running(), "reset only before start"
        self.state = state
        self.height = state.last_block_height + 1
        self.round = 0
        self.step = STEP_NEW_HEIGHT
        self.votes = self._new_height_vote_set(state, self.height)
        self.round_validators = state.validators
        self.commit_round = -1

    # ---------------------------------------------------------------------
    # message intake
    # ---------------------------------------------------------------------

    def receive_proposal(self, msg: ProposalMsg) -> None:
        self.msg_queue.put(("proposal", msg))

    def receive_vote(self, vote: Vote) -> None:
        self.msg_queue.put(("vote", VoteMsg(vote)))

    def receive_commit_block(self, block, commit) -> None:
        """Catch-up intake: a decided block + its +2/3 commit, pushed by a
        peer that saw us lagging (reactor.go gossipDataRoutine catch-up)."""
        self.msg_queue.put(("commit_block", block, commit))

    def _notify_step(self) -> None:
        if self.on_step_change is not None:
            try:
                self.on_step_change()
            except Exception:  # noqa: BLE001 - reactor must not kill us
                _log.exception("on_step_change hook failed")

    def _set_step(self, step: int) -> None:
        """Every step transition funnels through here: the OUTGOING
        step's wall duration feeds the per-step histogram (the round
        breakdown the paper's latency decomposition needs) and the
        transition lands in the trace. Durations use the real clock
        even under simnet — the trace timeline rides the trace clock,
        but step cost is host truth."""
        now = time.perf_counter()
        if self.metrics is not None and self._step_entered_at:
            self.metrics.step_duration.observe(
                now - self._step_entered_at,
                step=STEP_NAMES.get(self.step, str(self.step)),
            )
        self._step_entered_at = now
        self.step = step
        # always-on height ledger: stamp the stage this transition
        # enters (ledger clock — virtual under simnet) and anchor the
        # per-height WAL fsync attribution once per height; then poke
        # the incident watchdog (commit-stall/round-escalation checks
        # are a clock read + integer compares when nothing is wrong)
        self.height_ledger.on_step(self.height, self.round, step)
        if self.wal is not None:
            self.height_ledger.note_wal_fsync_base(self.wal.fsync_led_ns)
        incidents.poke(self.height, self.round)
        # self-tuning seam: the controller shares the incident
        # recorder's deterministic poke site (a counter bump when no
        # controller is mounted; count-based evaluation when one is)
        controlplane.poke(self.height, self.round)
        tracing.instant(
            "consensus.step", cat="consensus", height=self.height,
            round=self.round, step=STEP_NAMES.get(step, str(step)),
        )

    def proposer_for_round(self, round_: int):
        """The proposer a given round of the current height would elect
        (reactor-side proposal verification for rounds != self.round)."""
        vs = self.state.validators
        if round_ <= 0:
            return vs.get_proposer()
        return vs.copy_increment_proposer_priority(round_).get_proposer()

    def _on_timeout(self, ti: TimeoutInfo) -> None:
        self.internal_queue.put(("timeout", ti))

    # ---------------------------------------------------------------------
    # the receive routine (state.go:774)
    # ---------------------------------------------------------------------

    def _receive_routine(self) -> None:
        while self.is_running():
            item = self._next_msg()
            if item is None:
                continue
            try:
                self._handle(item, write_wal=True)
            except fp.SimulatedCrash as e:
                # the in-process stand-in for a process kill: halt the
                # machine dead (no graceful teardown) so the crash-
                # recovery tests can restart over the same home dir
                self._halt(str(e))
                return
            except Exception:  # noqa: BLE001 - engine must not die silently
                import traceback

                traceback.print_exc()

    def _halt(self, reason: str) -> None:
        """Kill the machine in place (crash simulation landing): marks
        the service stopped without the graceful on_stop path — the
        receive routine IS the current thread, so on_stop's join would
        deadlock. The WAL close is best-effort; a real crash would not
        even get that."""
        _log.error("consensus HALTED (simulated crash): %s", reason)
        self.crashed = True
        with self._lock:
            self._stopped = True
        self._quit.set()
        self.ticker.stop()
        if self.wal:
            try:
                self.wal.close()
            except Exception:  # noqa: BLE001 - crash path, best-effort
                pass

    def _next_msg(self, timeout: float = 0.1):
        try:
            return self.internal_queue.get_nowait()
        except queue.Empty:
            pass
        try:
            return self.msg_queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def _handle(self, item, write_wal: bool) -> None:
        kind = item[0]
        if kind == "vote" and not self._vote_prefilter(item[1].vote):
            self._note_straggler(item[1].vote)
            self._count_prefilter_drop(item[1].vote)
            # overload shield: a vote that fails the CHEAP stateless +
            # valset checks (unknown index, address mismatch, wrong
            # height, no signature) is dropped BEFORE the WAL write —
            # pre-filtered garbage must never cost an fsync. A flood of
            # forged votes otherwise turns the consensus WAL into a
            # disk-bandwidth DoS (the mempool_time hammer scenario:
            # ~6k garbage votes/sec × one fsync each starves real
            # consensus traffic on a 1-core host). Signature-valid
            # admission still happens in VoteSet.add_vote; this only
            # skips votes the handler would drop anyway.
            return
        if write_wal and self.wal:
            self._wal_write(item)
        if kind == "start_round":
            _, h, r = item
            if h == self.height:
                self._enter_new_round(h, r)
        elif kind == "proposal":
            self._set_proposal(item[1])
        elif kind == "vote":
            self._try_add_vote(item[1].vote)
        elif kind == "timeout":
            self._handle_timeout(item[1])
        elif kind == "commit_block":
            self._apply_commit_block(item[1], item[2])

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """state.go:934 handleTimeout."""
        if ti.height != self.height or ti.round < self.round:
            return
        if ti.step == STEP_PROPOSE and self.step == STEP_PROPOSE:
            self._enter_prevote(ti.height, ti.round)
        elif ti.step == STEP_PREVOTE_WAIT and self.step <= STEP_PREVOTE_WAIT:
            self._enter_precommit(ti.height, ti.round)
        elif ti.step == STEP_PRECOMMIT_WAIT \
                and self.step <= STEP_PRECOMMIT_WAIT:
            self._enter_precommit(ti.height, ti.round)
            self._enter_new_round(ti.height, ti.round + 1)
        elif ti.step == STEP_NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)

    # ---------------------------------------------------------------------
    # WAL
    # ---------------------------------------------------------------------

    def _wal_write(self, item) -> None:
        kind = item[0]
        if kind == "vote":
            fp.fail_point("consensus.wal.pre_vote")
            self.wal.write_sync(walmod.MSG_INFO, json.dumps(
                {"t": "vote", "v": serde.vote_to_j(item[1].vote)}
            ).encode())
            fp.fail_point("consensus.wal.post_vote")
        elif kind == "proposal":
            fp.fail_point("consensus.wal.pre_proposal")
            msg: ProposalMsg = item[1]
            self.wal.write_sync(walmod.MSG_INFO, json.dumps({
                "t": "proposal",
                "p": {
                    "height": msg.proposal.height,
                    "round": msg.proposal.round,
                    "pol_round": msg.proposal.pol_round,
                    "block_id": serde.bid_to_j(msg.proposal.block_id),
                    "ts": serde.ts_to_j(msg.proposal.timestamp),
                    "sig": msg.proposal.signature.hex(),
                },
                "b": json.loads(serde.block_to_json(msg.block)),
            }).encode())
            fp.fail_point("consensus.wal.post_proposal")
        elif kind == "timeout":
            ti: TimeoutInfo = item[1]
            self.wal.write(walmod.TIMEOUT_INFO, struct.pack(
                ">qii", ti.height, ti.round, ti.step
            ))

    def _catchup_replay(self) -> None:
        """replay.go:94 catchupReplay: re-handle messages logged after the
        last ENDHEIGHT(height-1)."""
        path = self._wal_path
        start = walmod.WAL.search_for_end_height(path, self.height - 1)
        if start is None:
            return
        for i, rec in enumerate(walmod.WAL.iter_records(path)):
            if i < start or rec.kind != walmod.MSG_INFO:
                continue
            # messages are WAL-logged BEFORE validation (state.go:820), so
            # a record the live path rejected must not brick the restart.
            # Only DECODE errors are tolerated here — the handlers below
            # swallow their own validation errors, and a genuine failure
            # inside commit finalization must abort startup, not leave the
            # node running on half-applied state.
            try:
                j = json.loads(rec.data.decode())
                if j["t"] == "vote":
                    vote = serde.vote_from_j(j["v"])
                elif j["t"] == "proposal":
                    p = j["p"]
                    prop = Proposal(
                        p["height"], p["round"], p["pol_round"],
                        serde.bid_from_j(p["block_id"]),
                        serde.ts_from_j(p["ts"]), bytes.fromhex(p["sig"]),
                    )
                    block = serde.block_from_json(json.dumps(j["b"]))
                else:
                    continue
            except Exception:  # noqa: BLE001 - corrupt record: skip
                import traceback

                traceback.print_exc()
                continue
            if j["t"] == "vote":
                if vote.height == self.height:
                    self._try_add_vote(vote, from_replay=True)
            elif prop.height == self.height:
                from cometbft_tpu_torch.types.proposal import ProposalError

                try:
                    self._set_proposal(ProposalMsg(prop, block))
                except (ValueError, ProposalError) as e:
                    # the live path rejected this proposal too
                    _log.warning("replay: dropped invalid proposal: %s", e)

    # ---------------------------------------------------------------------
    # step: new round / propose
    # ---------------------------------------------------------------------

    def _enter_new_round(self, height: int, round_: int) -> None:
        """state.go:1042: skip unless (height, round) advances us."""
        if height != self.height:
            return
        if round_ < self.round:
            return
        if round_ == self.round and self.step != STEP_NEW_HEIGHT:
            return
        # per-round proposer: a COPY of the height's validator set with
        # `round` extra priority increments (state.go:1058-1062) — the
        # canonical state.validators is never mutated mid-height
        if round_ == 0:
            self.round_validators = self.state.validators
        else:
            self.round_validators = \
                self.state.validators.copy_increment_proposer_priority(
                    round_
                )
        self.round = round_
        self._set_step(STEP_NEW_ROUND)
        self._triggered_precommit_wait = False
        if round_ > 0:
            self.proposal = None
            self.proposal_block = None
        self.votes.set_round(round_)
        self._notify_step()
        self._enter_propose(height, round_)

    def _proposer(self):
        vs = getattr(self, "round_validators", None) or self.state.validators
        return vs.get_proposer()

    def is_proposer(self) -> bool:
        if self.privval is None:
            return False
        return (
            self._proposer().address == self.privval.pub_key().address()
        )

    def _enter_propose(self, height: int, round_: int) -> None:
        """state.go:1129."""
        self._set_step(STEP_PROPOSE)
        self.ticker.schedule(TimeoutInfo(
            height, round_, STEP_PROPOSE,
            self.timeouts.propose_timeout(round_),
        ))
        if self.is_proposer():
            self.decide_proposal_fn(height, round_)
        # a complete proposal may already be present (replay / gossip race)
        if self._proposal_complete():
            self._enter_prevote(height, round_)

    def _default_decide_proposal(self, height: int, round_: int) -> None:
        """state.go:1180 defaultDecideProposal."""
        if self.valid_block is not None:
            block = self.valid_block
        else:
            ext_commit = None
            if height > self.state.initial_height and \
                    self.state.consensus_params.extensions_enabled(
                        height - 1):
                ext_commit = self.block_store.load_extended_commit(
                    height - 1
                )
            block = self.block_exec.create_proposal_block(
                height, self.state,
                self._load_last_commit(height),
                self.privval.pub_key().address(),
                extended_commit=ext_commit,
            )
        bid = block.block_id()
        prop = Proposal(height, round_, self.valid_round, bid,
                        Timestamp.now())
        prop.signature = self.privval.sign_proposal(
            self.state.chain_id, height, round_, prop.pol_round, bid,
            prop.timestamp,
        )
        msg = ProposalMsg(prop, block)
        self.internal_queue.put(("proposal", msg))
        self.broadcast(("proposal", msg))

    def _load_last_commit(self, height: int) -> Optional[Commit]:
        if height == self.state.initial_height:
            return Commit(height - 1, 0, BlockID(), [])
        return self.block_store.load_seen_commit(height - 1)

    def _proposal_complete(self) -> bool:
        return self.proposal is not None and self.proposal_block is not None

    def _set_proposal(self, msg: ProposalMsg) -> None:
        """state.go:1890 defaultSetProposal + addProposalBlockPart.

        The signature is verified on BOTH the live and replay paths: the
        WAL logs proposals before validation, so a replay that skipped
        verification would turn a live-rejected forgery into the accepted
        proposal after restart."""
        # Block recovery at commit step (round-2 advisory): once a +2/3
        # precommit majority decided a block we don't hold, ANY proposal
        # carrying that block must be accepted regardless of its round —
        # the block content is authenticated by its hash matching the
        # majority, not by the proposal signature (the reference re-seeds
        # ProposalBlockParts from the commit BlockID in enterCommit).
        if self.commit_round >= 0 and self.proposal_block is None:
            maj = self.votes.precommits(
                self.commit_round
            ).two_thirds_majority()
            if (maj is not None and not maj.is_nil()
                    and msg.block.hash() == maj.hash):
                # the header hash matching +2/3 precommits authenticates
                # the HEADER; the body must still validate against it
                # (data_hash etc.) or an attacker could pair the real
                # header with tampered txs
                try:
                    self.block_exec.validate_block(self.state, msg.block)
                except Exception as e:  # noqa: BLE001
                    _log.warning("commit-recovery block rejected: %s", e)
                    return
                self.proposal_block = msg.block
                self._try_finalize_commit(self.height)
                return
        if self.proposal is not None:
            return
        p = msg.proposal
        if p.height != self.height or p.round != self.round:
            return
        p.validate_basic()
        proposer = self._proposer()
        if not p.verify(self.state.chain_id, proposer.pub_key):
            raise ValueError("invalid proposal signature")
        if msg.block.hash() != p.block_id.hash:
            raise ValueError("proposal block hash mismatch")
        self.proposal = p
        self.proposal_block = msg.block
        if self.step == STEP_PROPOSE and self._proposal_complete():
            self._enter_prevote(self.height, self.round)
        elif self.step >= STEP_COMMIT:
            self._try_finalize_commit(self.height)

    # ---------------------------------------------------------------------
    # step: prevote / precommit
    # ---------------------------------------------------------------------

    def _enter_prevote(self, height: int, round_: int) -> None:
        """state.go:1311."""
        if height != self.height or self.step >= STEP_PREVOTE:
            return
        self._set_step(STEP_PREVOTE)
        self._notify_step()
        self.do_prevote_fn(height, round_)
        self._check_vote_quorums()

    def _default_do_prevote(self, height: int, round_: int) -> None:
        """state.go:1360 defaultDoPrevote, incl. POL-based unlocking
        (arXiv Tendermint alg. lines 22-33): a locked node prevotes a
        DIFFERENT proposal iff the proposal carries a proof-of-lock round
        vr with locked_round <= vr < round and +2/3 prevoted that block
        at vr — evidence the lock is stale and the network moved on."""
        if self.proposal_block is None:
            self._sign_add_vote(canonical.PREVOTE_TYPE, BlockID())
            return
        try:
            self.block_exec.validate_block(self.state, self.proposal_block)
            ok = self.block_exec.process_proposal(
                self.proposal_block, self.state
            )
        except Exception:
            ok = False
        if not ok:
            self._sign_add_vote(canonical.PREVOTE_TYPE, BlockID())
            return
        bid = self.proposal_block.block_id()
        # unlocked, or proposal IS the locked block: prevote it (line 23:
        # valid(v) ∧ (lockedRound = −1 ∨ lockedValue = v))
        if self.locked_block is None or \
                self.proposal_block.hash() == self.locked_block.hash():
            self._sign_add_vote(canonical.PREVOTE_TYPE, bid)
            return
        # locked on something else: only a proof-of-lock unlocks us
        # (line 29: valid(v) ∧ (lockedRound ≤ vr ∨ lockedValue = v), with
        # the 2f+1 PREVOTE(h, vr, id(v)) trigger checked in our own sets)
        pol = self.proposal.pol_round if self.proposal is not None else -1
        if 0 <= pol < round_ and self.locked_round <= pol:
            maj = self.votes.prevotes(pol).two_thirds_majority()
            if maj is not None and not maj.is_nil() \
                    and self.proposal_block.hash() == maj.hash:
                # the lock itself is NOT cleared here — if this block gains
                # +2/3 prevotes this round, enterPrecommit re-locks on it
                self._sign_add_vote(canonical.PREVOTE_TYPE, bid)
                return
        self._sign_add_vote(canonical.PREVOTE_TYPE, BlockID())

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        if height != self.height or round_ != self.round \
                or self.step >= STEP_PREVOTE_WAIT:
            return
        self._set_step(STEP_PREVOTE_WAIT)
        self.ticker.schedule(TimeoutInfo(
            height, round_, STEP_PREVOTE_WAIT,
            self.timeouts.prevote_timeout(round_),
        ))

    def _enter_precommit(self, height: int, round_: int) -> None:
        """state.go:1513."""
        # height+round guard (state.go:1515): a stale height/round
        # majority must not make us sign a precommit in the current one
        if height != self.height or round_ != self.round \
                or self.step >= STEP_PRECOMMIT:
            return
        self._set_step(STEP_PRECOMMIT)
        self._notify_step()
        maj = self.votes.prevotes(round_).two_thirds_majority()
        if maj is None:
            self._sign_add_vote(canonical.PRECOMMIT_TYPE, BlockID())
            return
        if maj.is_nil():
            # +2/3 prevoted nil: unlock (state.go:1570)
            self.locked_round = -1
            self.locked_block = None
            self._sign_add_vote(canonical.PRECOMMIT_TYPE, BlockID())
            return
        if self.proposal_block is not None and \
                self.proposal_block.hash() == maj.hash:
            self.locked_round = round_
            self.locked_block = self.proposal_block
            self.valid_round = round_
            self.valid_block = self.proposal_block
            self._sign_add_vote(canonical.PRECOMMIT_TYPE, maj)
            return
        if self.locked_block is not None and \
                self.locked_block.hash() == maj.hash:
            self.locked_round = round_
            self._sign_add_vote(canonical.PRECOMMIT_TYPE, maj)
            return
        # 2/3 for a block we don't have: precommit nil, remember valid
        self.locked_round = -1
        self.locked_block = None
        self._sign_add_vote(canonical.PRECOMMIT_TYPE, BlockID())

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        # one-shot per round (state.go TriggeredTimeoutPrecommit): without
        # the guard every straggling precommit restarts the timer,
        # stretching stalled rounds indefinitely. The step is NOT advanced
        # — precommit-wait can be triggered from any step once +2/3-any
        # precommits exist for the round.
        if height != self.height or round_ != self.round \
                or self._triggered_precommit_wait:
            return
        self._triggered_precommit_wait = True
        self.ticker.schedule(TimeoutInfo(
            height, round_, STEP_PRECOMMIT_WAIT,
            self.timeouts.precommit_timeout(round_),
        ))

    # ---------------------------------------------------------------------
    # votes
    # ---------------------------------------------------------------------

    def _sign_add_vote(self, vote_type: int, block_id: BlockID) -> None:
        """state.go:2452 signAddVote."""
        if self.privval is None:
            return
        addr = self.privval.pub_key().address()
        idx, _ = self.state.validators.get_by_address(addr)
        if idx < 0:
            return
        vote = Vote(
            vote_type=vote_type,
            height=self.height,
            round=self.round,
            block_id=block_id,
            timestamp=Timestamp.now(),
            validator_address=addr,
            validator_index=idx,
        )
        sign_ext = (
            vote_type == canonical.PRECOMMIT_TYPE
            and not block_id.is_nil()
            and self.state.consensus_params.extensions_enabled(self.height)
        )
        if sign_ext:
            # app extends the precommit (execution.go:318 ExtendVote);
            # the privval signs both the vote and the extension — the
            # extension signature is REQUIRED even when the app returns
            # an empty extension
            vote.extension = self.block_exec.extend_vote(
                self.height, self.round, block_id.hash
            )
        vote.signature = self.privval.sign_vote(
            self.state.chain_id, vote, sign_extension=sign_ext
        )
        # own votes ride the internal queue so they are WAL-logged before
        # being processed (state.go:2452 signAddVote -> sendInternalMessage)
        self.internal_queue.put(("vote", VoteMsg(vote)))
        self.broadcast(("vote", vote))

    # prefilter drop bookkeeping: under a garbage flood the per-vote
    # warning itself is overload (log handlers + pytest capture cost
    # more than the drop) — log a rate-limited summary instead
    _PREFILTER_LOG_EVERY = 512

    def _vote_prefilter(self, vote: Vote) -> bool:
        """Cheap admission: False = drop before any WAL/verify cost.
        Only rejects votes _try_add_vote/VoteSet would reject anyway —
        wrong height, structurally empty signature, unknown validator
        index, or index/address mismatch against this height's valset.
        No signature verification happens here. Runs on the receive
        routine; reads of height/valset race benignly with round
        transitions (a misjudged vote is re-gossiped/retransmitted)."""
        try:
            if vote.height != self.height:
                return False
            if not vote.signature or vote.validator_index < 0:
                return False
            vals = self.round_validators or self.state.validators
            val = vals.get_by_index(vote.validator_index)
            if val is None or val.address != vote.validator_address:
                return False
            return True
        except Exception:  # noqa: BLE001 - racing state: let it through
            return True

    def _note_straggler(self, vote: Vote) -> None:
        """Late-signer attribution for precommits that lost the height
        race: the reference folds height-1 precommits into the next
        LastCommit; this implementation drops them — which made the
        height ledger's `late` rows structurally near-empty (finalize
        is atomic with quorum, so with the block in hand nothing can
        arrive 'after quorum' at the same height). The straggler path
        closes that: a precommit for the JUST-finalized height and its
        commit round is signature-verified against last_validators
        (cost-bounded: wants_straggler gates to at most one verify per
        validator per height, MAX_STRAGGLERS total — forged floods
        stay cheap to shed) and folded into the finalized record with
        the same net/sign split and hop join."""
        try:
            if (vote.vote_type != canonical.PRECOMMIT_TYPE
                    or vote.height != self.height - 1
                    or not vote.signature
                    or vote.validator_index < 0):
                return
            led = self.height_ledger
            if not led.wants_straggler(vote.height, vote.round,
                                       vote.validator_index):
                return
            lv = self.state.last_validators
            val = lv.get_by_index(vote.validator_index) \
                if lv is not None else None
            if val is None or val.address != vote.validator_address:
                return
            try:
                vote.verify(self.state.chain_id, val.pub_key)
            except Exception:  # noqa: BLE001 - forged straggler
                # burn the slot: the per-validator-per-height one-
                # verify bound must hold for INVALID signatures too,
                # or a forged flood buys unbounded verifies on the
                # consensus thread (review finding)
                led.burn_straggler(vote.height, vote.round,
                                   vote.validator_index)
                return
            net_ns = 0
            if not vote.timestamp.is_zero():
                net_ns = Timestamp.now().to_ns() \
                    - vote.timestamp.to_ns()
            led.note_straggler(vote.height, vote.round,
                               vote.validator_index, net_ns)
        except Exception:  # noqa: BLE001 - attribution must never
            pass           # stall the receive routine

    def _count_prefilter_drop(self, vote: Vote) -> None:
        self.prefilter_drops += 1
        if self.metrics is not None:
            self.metrics.invalid_votes.inc()
        if self.prefilter_drops % self._PREFILTER_LOG_EVERY == 1:
            _log.warning(
                "vote prefilter dropped %d invalid votes so far "
                "(latest: h=%d from %s; summary log, rate-limited)",
                self.prefilter_drops, vote.height,
                vote.validator_address.hex()[:12],
            )

    def _try_add_vote(self, vote: Vote, from_replay: bool = False) -> None:
        """state.go:2110 tryAddVote -> addVote (:2161)."""
        if vote.height != self.height:
            return
        # app-level extension check for peers' precommits (state.go
        # addVote -> blockExec.VerifyVoteExtension); our own extension
        # came from the app and skips the round trip. Signature-level
        # verification happens inside VoteSet.add_vote.
        if (vote.vote_type == canonical.PRECOMMIT_TYPE
                and not vote.block_id.is_nil()
                and self.state.consensus_params.extensions_enabled(
                    self.height)
                and not from_replay
                and (self.privval is None
                     or vote.validator_address
                     != self.privval.pub_key().address())):
            # authenticate BEFORE the app round trip: the ABCI call may
            # cross a process boundary, and the app must never see
            # extensions from spoofed validators (the p2p reactor has
            # already sig-checked reactor-delivered votes; this covers
            # every other intake path)
            val = self.state.validators.get_by_index(vote.validator_index)
            if val is None or val.address != vote.validator_address:
                return
            try:
                vote.verify(self.state.chain_id, val.pub_key)
                vote.verify_extension(self.state.chain_id, val.pub_key)
            except Exception:  # noqa: BLE001 - forged: drop silently
                _log.warning("dropped precommit w/ bad signature(s) "
                             "before extension verify h=%d", vote.height)
                return
            try:
                ok = self.block_exec.verify_vote_extension(vote)
            except Exception:  # noqa: BLE001 - app failure != bad vote
                _log.exception("VerifyVoteExtension app call failed")
                ok = False
            if not ok:
                _log.warning(
                    "dropped precommit with app-rejected extension "
                    "h=%d r=%d from %s", vote.height, vote.round,
                    vote.validator_address.hex()[:12],
                )
                return
        try:
            added = self.votes.add_vote(vote, verify=True)
        except ConflictingVoteError as e:
            self._submit_equivocation(e)
            return
        except VoteSetError as e:
            # invalid vote (bad sig, unknown validator): logged-and-dropped
            # in the reference too (state.go:2110 tryAddVote error arm) —
            # and replay must tolerate records the live path rejected
            _log.warning("dropped invalid vote h=%d r=%d from %s: %s",
                         vote.height, vote.round,
                         vote.validator_address.hex()[:12], e)
            return
        if added:
            if vote.vote_type == canonical.PRECOMMIT_TYPE:
                # late-signer attribution: the validator's FIRST
                # precommit arrival of each round, stamped BEFORE the
                # quorum transitions below so the quorum-crossing vote
                # itself never reads as late. net_ns = receive instant
                # minus the vote's own signing timestamp, both on
                # Timestamp.now()'s clock (virtual under simnet, wall
                # time live) — the in-flight half of the net_ms vs
                # sign_ms late-signer split; clock skew between
                # validators clamps at the ledger
                net_ns = 0
                if not vote.timestamp.is_zero():
                    net_ns = Timestamp.now().to_ns() \
                        - vote.timestamp.to_ns()
                self.height_ledger.note_vote(vote.round,
                                             vote.validator_index,
                                             net_ns)
            if self.on_vote_added is not None:
                try:
                    # reactor hook: broadcast HasVote so peers stop
                    # re-sending this vote (reactor.go:404 broadcastHasVote)
                    self.on_vote_added(vote)
                except Exception:  # noqa: BLE001 - gossip must not stall
                    _log.exception("on_vote_added hook failed")
            self._check_vote_quorums(vote.round)

    def _submit_equivocation(self, e: ConflictingVoteError) -> None:
        """Conflicting votes -> DuplicateVoteEvidence -> pool (+ gossip).
        Reference: consensus/state.go:2161 addVote's evidence arm."""
        if self.evidence_pool is None:
            return
        from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence

        _, val = self.state.validators.get_by_address(
            e.new.validator_address
        )
        if val is None:
            return
        ev = DuplicateVoteEvidence.from_votes(
            e.existing, e.new, self.state.last_block_time,
            self.state.validators.total_voting_power(), val.voting_power,
        )
        try:
            if self.evidence_pool.add_evidence(ev) and self.on_evidence:
                self.on_evidence(ev)
        except Exception as ex:  # noqa: BLE001 - evidence must not stall us
            _log.warning("equivocation evidence rejected: %s", ex)

    def _check_vote_quorums(self, vr: Optional[int] = None) -> None:
        """Quorum-driven step transitions (state.go addVote tail), keyed on
        the VOTE's round: a quorum can complete in a round other than the
        one this node is currently in (e.g. we timed out into round r+1
        just before the last round-r precommit arrived).

        Every transition is pinned to the height at ENTRY: a nested call
        (quorum -> commit -> finalize) advances self.height under us, and
        continuing with the new height would push the fresh height into
        phantom steps off the old height's majorities (found by the
        rollback-restart replay test — the machine wedged at COMMIT of
        H+1 with H's precommit majority)."""
        h = self.height
        if vr is None:
            vr = self.round
        prevotes = self.votes.prevotes(vr)
        if vr == self.round and \
                self.step in (STEP_PREVOTE, STEP_PREVOTE_WAIT):
            if prevotes.has_two_thirds_majority():
                self._enter_precommit(h, vr)
            elif prevotes.has_two_thirds_any():
                self._enter_prevote_wait(h, vr)
        elif vr > self.round and prevotes.has_two_thirds_any():
            # round skip (state.go:2260): the network has moved on
            self._enter_new_round(h, vr)

        if h != self.height:
            return  # a nested transition finalized this height
        precommits = self.votes.precommits(vr)
        maj = precommits.two_thirds_majority()
        if maj is not None:
            # state.go addVote: enterNewRound -> enterPrecommit ->
            # enterCommit/enterPrecommitWait — our own precommit must be
            # signed (and lock bookkeeping done) even when the majority
            # formed before we reached STEP_PRECOMMIT ourselves
            self._enter_new_round(h, vr)  # no-op unless vr > round
            self._enter_precommit(h, vr)
            if not maj.is_nil():
                self._enter_commit(h, vr)
            else:
                self._enter_precommit_wait(h, vr)
        elif vr >= self.round and precommits.has_two_thirds_any():
            self._enter_new_round(h, vr)
            self._enter_precommit_wait(h, vr)

    # ---------------------------------------------------------------------
    # step: commit / finalize
    # ---------------------------------------------------------------------

    def _enter_commit(self, height: int, round_: int) -> None:
        """state.go:1648."""
        if height != self.height or self.step >= STEP_COMMIT:
            return
        self._set_step(STEP_COMMIT)
        self.commit_round = round_
        self._notify_step()
        self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        """state.go:1709."""
        maj = self.votes.precommits(self.commit_round).two_thirds_majority()
        if maj is None or maj.is_nil():
            return
        block = self.proposal_block
        if block is None or block.hash() != maj.hash:
            # wait for the block to arrive via gossip
            return
        self._finalize_commit(height, maj, block)

    def _finalize_commit(self, height: int, block_id: BlockID,
                         block: Block) -> None:
        """state.go:1739: persist, apply through ABCI, move to next height."""
        with tracing.span("consensus.finalize", cat="consensus",
                          height=height, round=self.commit_round):
            self._finalize_commit_inner(height, block_id, block)

    def _finalize_commit_inner(self, height: int, block_id: BlockID,
                               block: Block) -> None:
        fp.fail_point("consensus.pre_finalize")
        self.height_ledger.on_commit(height)  # t_commit: persist begins
        precommits = self.votes.precommits(self.commit_round)
        ext_commit = None
        if self.state.consensus_params.extensions_enabled(height):
            ext_commit = precommits.make_extended_commit()
            seen_commit = ext_commit.to_commit()
        else:
            seen_commit = precommits.make_commit()
        self.block_store.save_block(block, seen_commit,
                                    extended_commit=ext_commit)
        fp.fail_point("consensus.post_block_save")
        if self.wal:
            self.wal.write_end_height(height)
        new_state = self.block_exec.apply_block(
            self.state, block_id, block
        )
        self.state = new_state
        self._update_metrics(block)
        self._record_height(height, block, seen_commit,
                            heightledger.VIA_CONSENSUS)
        self._advance_to_height(new_state)

    def _apply_commit_block(self, block: Block, commit: Commit) -> None:
        """Fast-forward from a peer's catch-up push: verify the +2/3
        commit over our validator set, then persist + apply. Not WAL-
        logged as a consensus message — a crash mid-apply restarts at the
        old height and the catch-up push simply recurs.

        Reference analog: blocksync's verify-then-apply step
        (blocksync/reactor.go:463-513) applied to a single pushed block
        inside consensus."""
        from cometbft_tpu_torch.types import validation as tv

        if commit is None or block is None:
            return
        if commit.height != self.height:
            return
        if block.hash() != commit.block_id.hash:
            _log.warning("catch-up block/commit hash mismatch at h=%d",
                         commit.height)
            return
        try:
            tv.verify_commit_light(
                self.state.chain_id, self.state.validators,
                commit.block_id, commit.height, commit,
                batch_fn=getattr(self.block_exec, "batch_fn", None),
            )
        except tv.VerificationError as e:
            _log.warning("catch-up commit rejected at h=%d: %s",
                         commit.height, e)
            return
        # full block validation BEFORE anything is persisted: the commit
        # authenticates only the header; a tampered body must not reach
        # the store or the app (code-review finding, round 3)
        try:
            self.block_exec.validate_block(self.state, block)
        except Exception as e:  # noqa: BLE001
            _log.warning("catch-up block invalid at h=%d: %s",
                         commit.height, e)
            return
        self.block_store.save_block(block, commit)
        if self.wal:
            self.wal.write_end_height(commit.height)
        new_state = self.block_exec.apply_block(
            self.state, commit.block_id, block, validate=False
        )
        self.state = new_state
        self._update_metrics(block)
        self._record_height(commit.height, block, commit,
                            heightledger.VIA_CATCHUP)
        self._advance_to_height(new_state)

    def _record_height(self, height: int, block: Block, commit,
                       via: str) -> None:
        """Close the height in the ledger (stage timeline, late-signer
        offsets + absent bitmap from the commit, plane/WAL joins) and
        re-arm the incident watchdog's commit-stall timer. Failure-
        isolated: observability must never halt finalization."""
        try:
            self.height_ledger.record_height(
                height,
                commit_round=getattr(commit, "round", self.commit_round),
                proposer_hex=block.header.proposer_address.hex()[:12],
                n_txs=len(block.data.txs),
                block_bytes=sum(len(t) for t in block.data.txs),
                commit_sigs=commit.signatures,
                fsync_led_ns=self.wal.fsync_led_ns if self.wal else 0,
                via=via,
            )
        except Exception:  # noqa: BLE001 - ledger bug != consensus halt
            _log.exception("height ledger record failed at h=%d", height)
        incidents.note_commit(height)

    def _update_metrics(self, block: Optional[Block]) -> None:
        m = self.metrics
        if m is None:
            return
        now = time.monotonic()
        if self._last_commit_walltime:
            m.block_interval.observe(now - self._last_commit_walltime)
        self._last_commit_walltime = now
        m.height.set(self.state.last_block_height)
        m.rounds.set(self.round)
        m.validators.set(len(self.state.validators))
        if block is not None:
            n_txs = len(block.data.txs)
            m.num_txs.set(n_txs)
            m.total_txs.inc(n_txs)
            # tx payload bytes — avoids re-serializing the whole block in
            # the commit hot path just for a gauge
            m.block_size.set(sum(len(t) for t in block.data.txs))

    def _advance_to_height(self, new_state: State) -> None:
        """updateToState (state.go:2005) + scheduleRound0."""
        self.height = new_state.last_block_height + 1
        self.round = 0
        self._set_step(STEP_NEW_HEIGHT)
        self.proposal = None
        self.proposal_block = None
        self.locked_round = -1
        self.locked_block = None
        self.valid_round = -1
        self.valid_block = None
        self.votes = self._new_height_vote_set(new_state, self.height)
        self.round_validators = new_state.validators
        self.commit_round = -1
        self._triggered_precommit_wait = False
        self.ticker.schedule(TimeoutInfo(
            self.height, 0, STEP_NEW_HEIGHT, self.timeouts.commit,
        ))
        self._notify_step()

    # ---------------------------------------------------------------------
    # test / observer helpers
    # ---------------------------------------------------------------------

    def wait_for_height(self, height: int, timeout: float = 30.0) -> bool:
        """Block until the chain reaches `height` (tests/drivers)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.state.last_block_height >= height:
                return True
            time.sleep(0.01)
        return False

    def round_state_json(self) -> dict:
        """RoundState introspection for the consensus_state /
        dump_consensus_state RPCs (consensus/types/round_state.go
        RoundStateSimple + rpc/core/consensus.go). Read without the
        receive routine's serialization — a snapshot for operators, not
        a consensus input."""
        def ba_str(ba) -> str:
            return "".join(
                "x" if ba.get_index(i) else "_" for i in range(ba.bits)
            )

        def votes_j(vs):
            if vs is None:
                return None
            maj = vs.two_thirds_majority()
            return {
                "count": vs.size(),
                "bit_array": ba_str(vs.bit_array()),
                "two_thirds_majority": maj.hash.hex() if maj else None,
            }

        votes = self.votes
        rounds = []
        for r in range(self.round + 1):
            rounds.append({
                "round": r,
                "prevotes": votes_j(votes.prevotes(r)),
                "precommits": votes_j(votes.precommits(r)),
            })
        return {
            "height": self.height,
            "round": self.round,
            "step": self.step,
            "proposal": (self.proposal.block_id.hash.hex()
                         if self.proposal else None),
            "proposal_block": (self.proposal_block.hash().hex()
                               if self.proposal_block else None),
            "locked_round": self.locked_round,
            "locked_block": (self.locked_block.hash().hex()
                             if self.locked_block else None),
            "valid_round": self.valid_round,
            "valid_block": (self.valid_block.hash().hex()
                            if self.valid_block else None),
            "height_vote_set": rounds,
        }
