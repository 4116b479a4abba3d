"""Consensus reactor: gossips proposals and votes over the p2p switch.

Reference: consensus/reactor.go — channels State/Data/Vote 0x20-0x22
(:28-31), Receive demux (:241), per-peer gossip routines (:569,:737),
NewRoundStep announcements (:404 broadcastNewRoundStepMessage) and
PeerState height/round/step + vote bitarray tracking (peer_state.go).

Vote distribution is LACK-BASED, not flooded (reactor.go:737
gossipVotesRoutine + :404 broadcastHasVote): every added vote triggers
a tiny HasVote announcement; each peer's PeerState keeps per-(round,
type) bitarrays of what that peer holds, and the gossip routine sends a
peer only votes it lacks — so a vote crosses each link ~once, bounding
traffic at O(votes x links) instead of flood's O(votes x links x
degree). Periodic VoteSetMaj23 announcements make peers answer with
VoteSetBits (their bitarray for that majority), healing bitmaps that
lost HasVote messages and pulling round-lagged peers forward
(reactor.go:896-960). Messages are verified BEFORE any relay or
enqueue — a forged vote costs the sender its connection and goes no
further. Catch-up for height-lagged peers pushes the decided block +
seen commit (the gossipDataRoutine catch-up arm, reactor.go:569).
"""
from __future__ import annotations

import json
import logging
import threading
import time
from typing import List, Optional

from cometbft_tpu_torch.consensus.state import ConsensusState, ProposalMsg
from cometbft_tpu_torch.p2p import peerledger as plmod
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.p2p.switch import Peer, Reactor
from cometbft_tpu_torch.types import part_set as psmod
from cometbft_tpu_torch.types import serde
from cometbft_tpu_torch.types.proposal import Proposal

_log = logging.getLogger(__name__)

STATE_CHANNEL = 0x20  # NewRoundStep (reactor.go StateChannel)
DATA_CHANNEL = 0x21   # proposals + block parts + catch-up commits
VOTE_CHANNEL = 0x22   # votes (reactor.go VoteChannel)

MAX_ORPHAN_PARTS = 128  # parts buffered before their proposal arrives
# DoS caps on attacker-chosen values (round-3 review findings):
MAX_ROUND_AHEAD = 16     # proposals for rounds further ahead are dropped
                         # (proposer_for_round costs O(round x validators))
MAX_BLOCK_PARTS = 1024   # 64 MiB of wire form; >> any sane max_bytes


class PeerState:
    """Last-known consensus position of one peer (peer_state.go),
    including per-(round, type) bitarrays of the votes it holds."""

    def __init__(self):
        self.height = 0
        self.round = -1
        self.step = 0
        self.last_update = 0.0
        self.last_pushed_height = 0   # catch-up dedup
        self.last_push_time = 0.0
        # (height, round) of the proposals sent to this peer when it
        # reached our height (one send each)
        self.proposals_sent: set = set()
        # (round, vote_type) -> BitArray of held votes, current height
        self._has: dict = {}

    def reset_votes(self) -> None:
        self._has.clear()

    def has_bits(self, round_: int, vtype: int, n: int):
        from cometbft_tpu_torch.libs.bits import BitArray

        ba = self._has.get((round_, vtype))
        if ba is None or ba.bits != n:
            ba = BitArray(n)
            self._has[(round_, vtype)] = ba
        return ba

    def mark_vote(self, round_: int, vtype: int, index: int,
                  n: int) -> None:
        # bound rogue-round dict growth, but never refuse an EXISTING
        # key — a full dict that stopped marking would make gossip
        # re-send the same votes every tick forever
        if 0 <= index < n and ((round_, vtype) in self._has
                               or len(self._has) < 64):
            self.has_bits(round_, vtype, n).set_index(index, True)


class ConsensusReactor(Reactor):
    def __init__(self, cs: ConsensusState, catchup_interval: float = 0.25,
                 gossip_interval: float = 0.02):
        super().__init__("CONSENSUS")
        self.cs = cs
        cs.broadcast = self._broadcast_own
        cs.on_step_change = self._announce_step
        cs.on_vote_added = self._on_vote_added
        self._seen_votes = set()
        self._seen_proposals = set()
        self._peer_states = {}  # peer -> PeerState
        self._gossip_interval = gossip_interval
        self._maj23_every = max(1, int(1.0 / max(gossip_interval, 1e-3)))
        self._gossip_tick = 0
        # observability: duplicate-delivery accounting (tests assert the
        # lack-based gossip bounds redundant traffic)
        self.votes_received = 0
        self.votes_duplicate = 0
        self.votes_sent = 0
        # (height, round, type, index) -> first-seen time: fresh votes
        # are NOT gossiped for a grace period — the origin's direct
        # broadcast + the HasVote announcements are in flight, and
        # gossiping before they land triple-delivers every vote
        self._vote_first_seen = {}
        # part reassembly (state.go ProposalBlockParts analog, kept
        # reactor-side so the state machine stays whole-block):
        # (height, round) -> {"prop": Proposal, "ps": PartSet}
        self._builders = {}
        # parts that arrived before their proposal: (h, r) -> [Part]
        self._orphan_parts = {}
        self._lock = threading.Lock()
        self._catchup_interval = catchup_interval
        self._catchup_thread = None
        self._stop = threading.Event()

    def channel_descriptors(self) -> List[ChannelDescriptor]:
        return [
            ChannelDescriptor(STATE_CHANNEL, priority=6,
                              send_queue_capacity=100),
            ChannelDescriptor(DATA_CHANNEL, priority=10,
                              send_queue_capacity=100),
            ChannelDescriptor(VOTE_CHANNEL, priority=7,
                              send_queue_capacity=2000),
        ]

    # -- peer lifecycle ----------------------------------------------------

    def add_peer(self, peer: Peer) -> None:
        with self._lock:
            self._peer_states[peer] = PeerState()
        # tell the newcomer where we are (broadcastNewRoundStep on join)
        peer.send(STATE_CHANNEL, self._step_bytes())
        if self._catchup_thread is None:
            self._catchup_thread = threading.Thread(
                target=self._catchup_routine, daemon=True,
                name="cs-catchup",
            )
            self._catchup_thread.start()

    def remove_peer(self, peer: Peer, reason: str) -> None:
        with self._lock:
            self._peer_states.pop(peer, None)

    # -- outbound ----------------------------------------------------------

    def _broadcast_own(self, msg) -> None:
        kind, payload = msg
        if self.switch is None:
            return
        if kind == "vote":
            # own votes go straight to every peer (latency matters for
            # liveness); the per-peer bitarrays are marked optimistically
            # so the gossip routine doesn't resend them
            vote = payload
            n = len(self.cs.state.validators)
            with self._lock:
                peers = list(self._peer_states.items())
            data = _vote_bytes(vote)
            for peer, ps in peers:
                ok = peer.send(VOTE_CHANNEL, data)
                self.votes_sent += 1
                # mark ONLY delivered sends (reference SetHasVote runs
                # only when Send succeeds) — a false "has it" bit would
                # withhold the vote from that peer forever
                if ok is not False and ps.height == vote.height:
                    ps.mark_vote(vote.round, vote.vote_type,
                                 vote.validator_index, n)
        elif kind == "proposal":
            # proposal metadata first, then every part — the block never
            # rides whole (reactor.go:569 gossipDataRoutine; parts allow
            # blocks larger than one MConnection message and parallel
            # relay of independent chunks)
            pm: ProposalMsg = payload
            ps = pm.block.make_part_set()
            h, r = pm.proposal.height, pm.proposal.round
            with self._lock:
                # seed our own bookkeeping so the echo of our proposal
                # (relayed back by a neighbor) dedupes instead of creating
                # an empty builder and re-flooding every returning part
                self._seen_proposals.add(
                    (h, r, pm.proposal.signature)
                )
                self._builders[(h, r)] = {"prop": pm.proposal, "ps": ps}
            self.switch.broadcast(DATA_CHANNEL, _proposal_bytes(pm))
            for i in range(ps.total()):
                self.switch.broadcast(
                    DATA_CHANNEL, _part_bytes(h, r, ps.get_part(i))
                )

    def _step_bytes(self) -> bytes:
        cs = self.cs
        return json.dumps({
            "t": "step", "h": cs.height, "r": cs.round, "s": cs.step,
        }).encode()

    def _announce_step(self) -> None:
        if self.switch is not None:
            self.switch.broadcast(STATE_CHANNEL, self._step_bytes())

    GOSSIP_GRACE = 0.3  # seconds before a fresh vote becomes gossipable

    def _on_vote_added(self, vote) -> None:
        """broadcastHasVote (reactor.go:404): a tiny announcement that we
        hold vote (h, r, type, index) — peers mark their picture of us
        and stop queueing that vote for us."""
        with self._lock:
            fs = self._vote_first_seen
            fs.setdefault(
                (vote.height, vote.round, vote.vote_type,
                 vote.validator_index), time.time(),
            )
            if len(fs) > 4096:
                h = self.cs.height
                for k in [k for k in fs if k[0] < h]:
                    del fs[k]
        if self.switch is None:
            return
        self.switch.broadcast(STATE_CHANNEL, json.dumps({
            "t": "has_vote", "h": vote.height, "r": vote.round,
            "vt": vote.vote_type, "i": vote.validator_index,
        }).encode())

    # -- catch-up (gossipDataRoutine's lagging-peer arm) -------------------

    GOSSIP_BATCH = 8  # votes per peer per tick

    def _catchup_routine(self) -> None:
        """The per-peer gossip pump: lack-based vote sends every tick,
        catch-up pushes and maj23 announcements at a slower cadence
        (reactor.go gossipVotesRoutine + queryMaj23Routine folded into
        one thread — per-peer goroutines don't pay on a 1-core host)."""
        last_catchup = 0.0
        while not self._stop.is_set():
            time.sleep(self._gossip_interval)
            if self.switch is None:
                continue
            self._gossip_votes()
            self._gossip_tick += 1
            if self._gossip_tick % self._maj23_every == 0:
                self._announce_maj23()
            now = time.time()
            if now - last_catchup < self._catchup_interval:
                continue
            last_catchup = now
            with self._lock:
                peers = list(self._peer_states.items())
            our_h = self.cs.height
            for peer, ps in peers:
                if 0 < ps.height < our_h:
                    self._push_catchup(peer, ps, now)

    def _push_catchup(self, peer: Peer, ps: PeerState, now: float) -> None:
        """Push the peer's height once; re-push only after a timeout in
        case the first one was lost (avoids re-serializing the same
        block 4x/second at a slow peer)."""
        with self._lock:
            h = ps.height
            if ps.last_pushed_height == h and \
                    now - ps.last_push_time < 2.0:
                return
            ps.last_pushed_height = h
            ps.last_push_time = now
        self._send_catchup(peer, h)

    def _vote_sets(self, round_: int):
        from cometbft_tpu_torch.types import canonical

        votes = self.cs.votes
        return ((canonical.PREVOTE_TYPE, votes.prevotes(round_)),
                (canonical.PRECOMMIT_TYPE, votes.precommits(round_)))

    def _gossip_votes(self) -> None:
        """Send each same-height peer up to GOSSIP_BATCH votes it lacks
        (reactor.go:737 gossipVotesRoutine's pickSendVote, bitarray
        difference + random pick)."""
        cs = self.cs
        h, our_round = cs.height, cs.round
        n = len(cs.state.validators)
        if n == 0:
            return
        with self._lock:
            peers = list(self._peer_states.items())
        import random

        now = time.time()
        with self._lock:
            fs = dict(self._vote_first_seen)
        for peer, ps in peers:
            if ps.height != h:
                continue
            budget = self.GOSSIP_BATCH
            for r in range(our_round, -1, -1):
                if budget <= 0:
                    break
                for vtype, vs in self._vote_sets(r):
                    if vs is None or budget <= 0:
                        continue
                    ours = vs.bit_array()
                    if ours.is_empty():
                        continue
                    # bitmap reads/writes under the reactor lock — the
                    # receive path mutates the same PeerState dicts
                    with self._lock:
                        lacking = ours.sub(ps.has_bits(r, vtype, n))
                    idxs = lacking.true_indices()
                    if not idxs:
                        continue
                    random.shuffle(idxs)
                    for idx in idxs:
                        if budget <= 0:
                            break
                        seen = fs.get((h, r, vtype, idx))
                        if seen is not None and \
                                now - seen < self.GOSSIP_GRACE:
                            continue  # direct send/HasVote still in flight
                        vote = vs.get_by_index(idx)
                        if vote is None:
                            continue
                        ok = peer.send(VOTE_CHANNEL, _vote_bytes(vote))
                        self.votes_sent += 1
                        if ok is not False:
                            # relay stamp: first-seen -> first-relay is
                            # OUR forwarding latency for this vote (the
                            # hop cost /dump_peers attributes)
                            if self.switch is not None:
                                self.switch.peer_ledger \
                                    .note_vote_relayed(
                                        (h, r, vtype, idx))
                            with self._lock:
                                ps.mark_vote(r, vtype, idx, n)
                        budget -= 1

    def _announce_maj23(self) -> None:
        """Broadcast VoteSetMaj23 for any 2/3 majority we have seen;
        receivers answer with VoteSetBits (reactor.go:896
        queryMaj23Routine)."""
        cs = self.cs
        h, r = cs.height, cs.round
        for vtype, vs in self._vote_sets(r):
            if vs is None:
                continue
            maj = vs.two_thirds_majority()
            if maj is None:
                continue
            self.switch.broadcast(STATE_CHANNEL, json.dumps({
                "t": "maj23", "h": h, "r": r, "vt": vtype,
                "bid": serde.bid_to_j(maj),
            }).encode())

    def _send_catchup(self, peer: Peer, height: int) -> None:
        """Push the decided block + its seen commit for the peer's height
        so it can finalize and advance (reactor.go:569 catch-up arm)."""
        try:
            block = self.cs.block_store.load_block(height)
            commit = self.cs.block_store.load_seen_commit(height)
        except Exception:  # noqa: BLE001 - store closing during shutdown
            return
        if block is None or commit is None:
            return
        # block rides as its serialized string: one encode here, one
        # decode on receive (not four)
        peer.send(DATA_CHANNEL, json.dumps({
            "t": "commit_block",
            "b": serde.block_to_json(block),
            "c": serde.commit_to_j(commit),
        }).encode())

    def _send_proposals(self, peer: Peer, ps: PeerState,
                        height: int) -> None:
        """A peer that reaches our height after its proposal went out
        dropped it (a proposal for another height is ignored), and
        without it the peer can only follow by catch-up pushes: send it
        each proposal we hold for the height and the parts we have, once
        (upstream's gossipDataRoutine sends a same-height peer the parts
        it lacks). Parts still missing here reach it by relay."""
        with self._lock:
            todo = sorted(((k, b) for k, b in self._builders.items()
                           if k[0] == height
                           and k not in ps.proposals_sent),
                          key=lambda kb: kb[0])
            for k, _ in todo:
                ps.proposals_sent.add(k)
            for k in [k for k in ps.proposals_sent if k[0] < height]:
                ps.proposals_sent.discard(k)
        for (h, r), b in todo:
            peer.send(DATA_CHANNEL,
                      _proposal_bytes(ProposalMsg(b["prop"], None)))
            parts = b["ps"]
            for i in range(parts.total()):
                part = parts.get_part(i)
                if part is not None:
                    peer.send(DATA_CHANNEL, _part_bytes(h, r, part))

    def stop_routines(self) -> None:
        self._stop.set()

    # -- inbound -----------------------------------------------------------

    def receive(self, chan_id: int, peer: Peer, msg: bytes) -> None:
        try:
            if chan_id == STATE_CHANNEL:
                self._receive_step(peer, msg)
            elif chan_id == VOTE_CHANNEL:
                self._receive_vote(peer, msg)
            elif chan_id == DATA_CHANNEL:
                self._receive_data(peer, msg)
        except _PeerMisbehavior as e:
            self.switch.stop_peer_for_error(peer, str(e))
        except Exception as e:  # noqa: BLE001 - undecodable peer message
            self.switch.stop_peer_for_error(peer, f"bad consensus msg: {e}")

    def _receive_step(self, peer: Peer, msg: bytes) -> None:
        j = json.loads(msg.decode())
        t = j.get("t")
        if t == "step":
            with self._lock:
                ps = self._peer_states.setdefault(peer, PeerState())
                new_h = int(j["h"])
                arrived = new_h != ps.height
                if arrived:
                    ps.reset_votes()  # bitarrays are per-height
                ps.height = new_h
                ps.round = int(j["r"])
                ps.step = int(j["s"])
                ps.last_update = time.time()
            if arrived:
                our_h = self.cs.height
                if new_h == our_h:
                    self._send_proposals(peer, ps, new_h)
                elif 0 < new_h < our_h:
                    # a lagging peer that just applied a height takes the
                    # next one now, not at the next catch-up tick: it
                    # catches up faster than the chain moves
                    self._push_catchup(peer, ps, time.time())
            return
        if t == "has_vote":
            # peer announces it holds one vote (reactor.go HasVote)
            if int(j["h"]) != self.cs.height:
                return
            r = int(j["r"])
            if not 0 <= r <= self.cs.round + MAX_ROUND_AHEAD:
                return  # rogue rounds must not grow the bitmap dict
            n = len(self.cs.state.validators)
            with self._lock:
                ps = self._peer_states.setdefault(peer, PeerState())
                ps.mark_vote(r, int(j["vt"]), int(j["i"]), n)
            return
        if t == "maj23":
            self._receive_maj23(peer, j)
            return
        if t == "vsb":
            self._receive_vsb(peer, j)
            return
        raise ValueError("bad state-channel message")

    def _receive_maj23(self, peer: Peer, j: dict) -> None:
        """Peer saw a 2/3 majority: record it and answer with OUR
        bitarray for that (h, r, type, blockID) so the peer learns what
        we lack (reactor.go:241 VoteSetMaj23 arm -> VoteSetBits)."""
        cs = self.cs
        h, r, vt = int(j["h"]), int(j["r"]), int(j["vt"])
        if h != cs.height or not 0 <= r <= cs.round + MAX_ROUND_AHEAD:
            return
        bid = serde.bid_from_j(j["bid"])
        vs = dict(self._vote_sets(r)).get(vt)
        if vs is None:
            return
        try:
            vs.set_peer_maj23(getattr(peer, "peer_id", str(id(peer))), bid)
        except Exception as e:  # noqa: BLE001 - conflicting maj23 claims
            _log.debug("peer maj23 rejected: %s", e)
        ours = vs.bit_array_by_block_id(bid) or vs.bit_array()
        peer.send(STATE_CHANNEL, json.dumps({
            "t": "vsb", "h": h, "r": r, "vt": vt,
            "bits": _bits_hex(ours),
        }).encode())

    def _receive_vsb(self, peer: Peer, j: dict) -> None:
        """VoteSetBits: the peer's holdings for one (h, r, type) — OR
        into its PeerState so the gossip routine fills its gaps."""
        cs = self.cs
        h, r, vt = int(j["h"]), int(j["r"]), int(j["vt"])
        if h != cs.height:
            return
        n = len(cs.state.validators)
        bits = _bits_from_hex(j.get("bits", ""), n)
        with self._lock:
            ps = self._peer_states.setdefault(peer, PeerState())
            for i in bits:
                ps.mark_vote(r, vt, i, n)

    def _receive_vote(self, peer: Peer, msg: bytes) -> None:
        vote = serde.vote_from_j(json.loads(msg.decode()))
        cs = self.cs
        n = len(cs.state.validators)
        key = (vote.height, vote.round, vote.vote_type,
               vote.validator_address, vote.signature)
        # gossip observatory: first-seen stamp + delivering peer for
        # the height ledger's net/sign late-signer join; duplicate
        # receipts counted per vote AND per delivering peer
        led = self.switch.peer_ledger if self.switch else None
        vkey = (vote.height, vote.round, vote.vote_type,
                vote.validator_index)
        rec = getattr(peer, "ledger_rec", None)
        self.votes_received += 1
        if key in self._seen_votes:
            # duplicate delivery: mark the sender as holding it (it
            # clearly does) — no relay, no re-verify. The key includes
            # the signature, so a dup here is a redelivery of already-
            # VERIFIED bytes: safe to count into the route table.
            self.votes_duplicate += 1
            if led is not None:
                led.note_vote_seen(vkey, peer.peer_id[:12])
            if rec is not None:
                plmod.note_dup_vote(rec)
            with self._lock:
                ps = self._peer_states.setdefault(peer, PeerState())
                if vote.height == cs.height:
                    ps.mark_vote(vote.round, vote.vote_type,
                                 vote.validator_index, n)
            return
        if vote.height != cs.height:
            # stale or future vote: neither verifiable against the current
            # set nor useful to the state machine; catch-up channels (the
            # commit push above / blocksync) cover lagging nodes. Not a
            # punishable offence — honest peers race height transitions.
            # No route stamping for arbitrary heights: attacker-chosen
            # far-future keys would fill the bounded vote-route table
            # with entries prune_votes never reaches (review finding).
            from cometbft_tpu_torch.types import canonical

            if vote.height == cs.height - 1 \
                    and vote.vote_type == canonical.PRECOMMIT_TYPE \
                    and 0 <= vote.round <= cs.round + MAX_ROUND_AHEAD:
                # straggler for the JUST-finalized height: stamp the
                # route (bounded: one height back, sane rounds — the
                # entry prunes at the next finalize) and forward for
                # late-signer attribution — the consensus prefilter
                # verifies it against last_validators, stamps the
                # height ledger's net/sign late row, and drops it
                # pre-WAL (ConsensusState._note_straggler)
                if led is not None:
                    led.note_vote_seen(vkey, peer.peer_id[:12])
                cs.receive_vote(vote)
            return
        # synchronous verification BEFORE enqueue: a forged vote must
        # cost the sender its connection and go no further
        val = cs.state.validators.get_by_index(vote.validator_index)
        if val is None or val.address != vote.validator_address:
            # benign race: the consensus thread may have advanced the
            # height (and swapped validator sets) between our height
            # check and this lookup — only punish when the heights still
            # agree, i.e. the peer really sent a bogus index
            if vote.height != cs.height:
                return
            raise _PeerMisbehavior("vote with bogus validator index")
        try:
            vote.verify(cs.state.chain_id, val.pub_key)  # raises on forgery
        except Exception as e:
            raise _PeerMisbehavior(f"invalid vote signature: {e}") from e
        # route stamping AFTER the verify: a forged vote racing the
        # honest gossip must not poison the first-seen hop attribution
        # (its sender is disconnected above; review finding)
        if led is not None:
            led.note_vote_seen(vkey, peer.peer_id[:12])
        if rec is not None:
            plmod.note_vote_rx(rec)
        self._seen_votes.add(key)
        if len(self._seen_votes) > 50000:
            self._seen_votes.clear()
        with self._lock:
            ps = self._peer_states.setdefault(peer, PeerState())
            ps.mark_vote(vote.round, vote.vote_type,
                         vote.validator_index, n)
        cs.receive_vote(vote)
        # NO flood relay: on_vote_added broadcasts a HasVote and the
        # lack-based gossip routine delivers the vote itself only to
        # peers that still lack it (reactor.go:737)

    def _receive_data(self, peer: Peer, msg: bytes) -> None:
        j = json.loads(msg.decode())
        if j.get("t") == "commit_block":
            # catch-up push: a decided block + its +2/3 seen commit.
            # Reactor-side gate BEFORE the expensive consensus-thread
            # verification: structural consistency (punishable) and a
            # per-peer rate limit so a forged-commit loop can't starve
            # the consensus queue with full VerifyCommitLight runs.
            block = serde.block_from_json(j["b"])
            commit = serde.commit_from_j(j["c"])
            if commit is None or block is None or \
                    block.hash() != commit.block_id.hash or \
                    block.header.height != commit.height:
                raise _PeerMisbehavior("inconsistent commit_block push")
            if commit.height != self.cs.height:
                return  # stale push (height raced forward): ignore
            with self._lock:
                ps = self._peer_states.setdefault(peer, PeerState())
                now = time.time()
                if commit.height == getattr(ps, "last_commit_block_h", 0) \
                        and now - getattr(ps, "last_commit_block", 0.0) \
                        < 0.5:
                    # rate limit: at most 2 pushes/sec/peer for one
                    # height; the next height's push is not held back
                    # (our height advances only through a valid commit)
                    return
                ps.last_commit_block = now
                ps.last_commit_block_h = commit.height
            self.cs.receive_commit_block(block, commit)
            return
        if j.get("t") == "part":
            self._receive_part(peer, j, msg)
            return
        p = _proposal_from_bytes(j)
        key = (p.height, p.round, p.signature)
        if key in self._seen_proposals:
            return
        cs = self.cs
        if p.height != cs.height:
            return
        # cheap structural checks BEFORE the O(round x validators)
        # proposer-priority walk and signature verify — both run on
        # attacker-chosen input
        p.validate_basic()
        if p.round > cs.round + MAX_ROUND_AHEAD:
            return  # not punishable: we may genuinely lag
        if p.block_id.part_set_header.total > MAX_BLOCK_PARTS:
            raise _PeerMisbehavior("absurd part count in proposal")
        # verify the proposer's signature for the proposal's own round
        # before relaying (late rounds are still relayable — peers may be
        # ahead of us)
        proposer = cs.proposer_for_round(p.round)
        if proposer is None:
            return
        if not p.verify(cs.state.chain_id, proposer.pub_key):
            raise _PeerMisbehavior("invalid proposal signature")
        self._seen_proposals.add(key)
        if len(self._seen_proposals) > 1000:
            self._seen_proposals.clear()
        orphans = []
        with self._lock:
            self._gc_builders(cs.height)
            bkey = (p.height, p.round)
            if bkey not in self._builders:
                self._builders[bkey] = {
                    "prop": p,
                    "ps": psmod.PartSet.from_header(
                        p.block_id.part_set_header
                    ),
                }
                orphans = self._orphan_parts.pop(bkey, [])
        self.switch.broadcast(DATA_CHANNEL, msg, except_peer=peer)
        for part in orphans:
            # buffered parts were never proof-checked and their sender is
            # long gone: verify, and relay the ones that belong (a part
            # that raced ahead of its proposal must still reach peers
            # whose only path goes through us)
            self._add_part(None, p.height, p.round, part,
                           relay=_part_bytes(p.height, p.round, part))

    def _receive_part(self, peer: Peer, j: dict, msg: bytes) -> None:
        h, r = int(j["h"]), int(j["r"])
        cs = self.cs
        if h != cs.height:
            return
        try:
            part = psmod.Part.from_j(j["part"])
            # size/index caps BEFORE buffering: orphan parts are held
            # un-proof-checked, so the 64KiB part cap is the only bound
            # on attacker-controlled memory here
            part.validate_basic()
        except Exception as e:  # noqa: BLE001 - malformed part payload
            raise _PeerMisbehavior(f"malformed block part: {e}") from e
        with self._lock:
            known = (h, r) in self._builders
            if not known:
                # parts can outrun their proposal via a third-party relay;
                # buffer a bounded number until the proposal lands
                buf = self._orphan_parts.setdefault((h, r), [])
                if len(buf) < MAX_ORPHAN_PARTS and \
                        not any(q.index == part.index for q in buf):
                    buf.append(part)
                if len(self._orphan_parts) > 8:  # rounds are few; cap rot
                    self._orphan_parts.pop(
                        next(iter(self._orphan_parts)), None
                    )
                return
        self._add_part(peer, h, r, part, relay=msg)

    def _add_part(self, peer: Optional[Peer], h: int, r: int,
                  part, relay) -> None:
        """Proof-check a part against the proposal's PartSetHeader, relay
        it if fresh, deliver the proposal when the set completes.

        Proof mismatch is NOT punished: under an equivocating proposer two
        honest nodes hold builders for different proposals at the same
        (h, r), and each would see the other's honestly-relayed parts fail
        verification — punishing would let one byzantine proposer
        disconnect the honest overlay from itself."""
        with self._lock:
            b = self._builders.get((h, r))
        if b is None:
            return
        ps: psmod.PartSet = b["ps"]
        try:
            fresh = ps.add_part(part)
        except psmod.PartSetError as e:
            _log.debug("dropped block part h=%d r=%d i=%d: %s",
                       h, r, part.index, e)
            return
        if not fresh:
            return
        if relay is not None and self.switch is not None:
            self.switch.broadcast(DATA_CHANNEL, relay, except_peer=peer)
        if not ps.is_complete():
            return
        prop: Proposal = b["prop"]
        try:
            block = serde.block_from_json(ps.assemble().decode())
            ok = block.hash() == prop.block_id.hash
        except Exception:  # noqa: BLE001 - bytes proven, decode not
            ok = False
        if not ok:
            # the parts merkle-match the proposal's PartSetHeader but the
            # content decodes badly or hashes elsewhere: the PROPOSER
            # lied; the relaying peer proved nothing wrong. Drop the
            # builder so a later round can proceed.
            _log.warning("proposal h=%d r=%d: parts match header but "
                         "block is invalid (byzantine proposer?)", h, r)
            with self._lock:
                self._builders.pop((h, r), None)
            return
        self.cs.receive_proposal(ProposalMsg(prop, block))

    def _gc_builders(self, height: int) -> None:
        """Drop reassembly state for finished heights (lock held)."""
        for key in [k for k in self._builders if k[0] < height]:
            del self._builders[key]
        for key in [k for k in self._orphan_parts if k[0] < height]:
            del self._orphan_parts[key]


class _PeerMisbehavior(Exception):
    pass


def _bits_hex(ba) -> str:
    """BitArray -> hex (LSB-first bytes) for the VoteSetBits wire."""
    out = bytearray((ba.bits + 7) // 8)
    for i in range(ba.bits):
        if ba.get_index(i):
            out[i // 8] |= 1 << (i % 8)
    return bytes(out).hex()


def _bits_from_hex(s: str, n: int):
    """hex -> indices of set bits, bounded to n."""
    try:
        raw = bytes.fromhex(s)
    except ValueError:
        return []
    return [
        i for i in range(min(n, len(raw) * 8))
        if raw[i // 8] >> (i % 8) & 1
    ]


def _vote_bytes(vote) -> bytes:
    return json.dumps(serde.vote_to_j(vote)).encode()


def _proposal_bytes(pm: ProposalMsg) -> bytes:
    p = pm.proposal
    return json.dumps({
        "t": "proposal",
        "p": {
            "height": p.height, "round": p.round,
            "pol_round": p.pol_round,
            "block_id": serde.bid_to_j(p.block_id),
            "ts": serde.ts_to_j(p.timestamp),
            "sig": p.signature.hex(),
        },
    }).encode()


def _part_bytes(height: int, round_: int, part) -> bytes:
    return json.dumps({
        "t": "part", "h": height, "r": round_, "part": part.to_j(),
    }).encode()


def _proposal_from_bytes(j: dict) -> Proposal:
    p = j["p"]
    return Proposal(
        p["height"], p["round"], p["pol_round"],
        serde.bid_from_j(p["block_id"]),
        serde.ts_from_j(p["ts"]), bytes.fromhex(p["sig"]),
    )
