"""Deterministic in-process network simulator for Byzantine testing.

The real e2e harness (tests/test_e2e.py; CometBFT's test/e2e/runner/
perturb.go) spawns OS processes and perturbs them with kill/disconnect —
too slow and too nondeterministic for a unit-test run. The
simnet replaces the wall clock, the thread scheduler, and the TCP stack
with ONE seeded, single-threaded discrete-event loop:

  * N real ``node``/``consensus`` stacks (full Node: stores, WAL,
    BlockExecutor, evidence pool, ABCI app) run unmodified — but their
    consensus receive routines are PUMPED by the scheduler instead of
    running as threads, their TimeoutTicker is a :class:`SimTicker`
    mapping timeouts onto simulated time, and ``Timestamp.now()`` reads
    the simulated clock (types/timestamp.set_now_source).
  * messages travel over :class:`SimTransport`/:class:`SimConn` — the
    in-memory analog of the p2p seams (p2p/transport.py Transport:
    listen/dial/on_conn; p2p/conn/connection.py MConnection:
    send(chan_id, msg)/on_receive) — through per-directed-link fault
    state: partition, probabilistic drop, latency+jitter, duplication
    and reordering, all drawn from ONE seeded RNG.
  * every node owns a private failpoint registry
    (libs/failpoints.fresh_registry); the scheduler swaps it in around
    that node's execution, so a schedule can arm ``consensus.wal.*``
    faults on node 2 without touching node 0. The isolation covers
    seams evaluated ON the scheduler thread (consensus, WAL, stores,
    evidence) — seams evaluated on background threads (e.g.
    ``verifyplane.dispatch`` on a shared plane's dispatcher) read the
    process-global registry (the swap is the scheduler thread's own)
    and are armed there. A fired ``crash`` action halts the
    node in place; a ``restart`` op later rebuilds the Node over the
    same home dir and exercises the REAL WAL recovery path (consensus
    catchup_replay + store-into-app handshake replay).

Because every event (delivery, timeout, schedule op) executes at a
deterministic (time, seq) and all randomness flows from the seed, two
runs of the same (seed, schedule) produce byte-identical chains —
commit hashes match at every height on every node, which is what makes
a failing schedule replayable.

Wire formats and channel IDs are IMPORTED from the real reactors
(consensus/reactor._vote_bytes / _proposal_from_bytes,
evidence/reactor evidence_to_j, the commit_block catch-up push), so a
reactor format change is automatically what the simnet exercises. The
one divergence: proposals ride whole (the reactor's proposal dict plus
the serialized block) instead of as PartSet chunks — part-level gossip
is a transport concern the fault model already covers with
drop/reorder of whole messages.

The port's copy of the JAX package's simnet/core.py, over the port's
modules, with one structural difference: every Node the net builds (at
start and on every restart) gets the net's `device` and `batch_fn`.
`device=None` is the card, and raises DeviceError without one;
`device="cpu"` runs the kernels' plain versions; a batch_fn marked
`on_host` (validation.oracle_batch_fn()) makes host nodes that resolve
no device. There is no silent CPU path: a simnet built with the default
on a machine without a card fails at its first node.

Determinism with a device plane: the scheduler thread blocks inside
VoteSet.add_vote until its vote's flush settles on the plane's
dispatcher thread, so commits do not depend on flush timing, but the
flush ledger's stage times do. Compare a card run's ledger only by its
verdict fields (path, rows, verdicts), never by its times. A
`verifyplane.dispatch` fault on a device plane fails the flush's futures
with DeviceError and the votes are not admitted (the JAX package answers
them from the host): the vote retransmission and the sync tick resend
them, so the run reaches its height, but its commits need not equal a
host run's.
"""
from __future__ import annotations

import heapq
import json
import logging
import random
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

from cometbft_tpu_torch.consensus.reactor import (
    DATA_CHANNEL,
    VOTE_CHANNEL,
    _proposal_from_bytes,
    _vote_bytes,
)
from cometbft_tpu_torch.consensus.state import ProposalMsg
from cometbft_tpu_torch.consensus.ticker import TimeoutInfo
from cometbft_tpu_torch.evidence.reactor import EVIDENCE_CHANNEL
from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.p2p import peerledger
from cometbft_tpu_torch.types import serde
from cometbft_tpu_torch.types.evidence import (
    EvidenceError,
    evidence_from_j,
    evidence_to_j,
)
from cometbft_tpu_torch.types.timestamp import Timestamp, set_now_source

_log = logging.getLogger(__name__)

SIM_EPOCH_SECONDS = 1_700_000_000  # simulated time zero (fixed, seedable)


class Link:
    """Directed-link fault state (src -> dst). All probabilities are
    evaluated against the simnet's single seeded RNG at SEND time."""

    __slots__ = ("up", "drop", "delay", "jitter", "dup", "reorder",
                 "reorder_window")

    def __init__(self):
        self.up = True
        self.drop = 0.0        # P(message silently lost)
        self.delay = 0.01      # base latency, sim seconds
        self.jitter = 0.0      # uniform extra latency
        self.dup = 0.0         # P(delivered twice)
        self.reorder = 0.0     # P(extra delay >> jitter, so later msgs pass)
        self.reorder_window = 0.25


class SimConn:
    """One direction of an established sim connection — the MConnection
    seam (`send(chan_id, msg) -> bool`, `on_receive(chan_id, msg)`).
    Channel IDs are the real reactors'; the fault model applies per
    send. Carries the src node's peer-ledger record for the dst peer —
    the SAME p2p/peerledger.py seam the real MConnection writes, so a
    scheduled partition's drops are attributed per peer and the ledger
    replays byte-identically (stamps ride the virtual clock)."""

    def __init__(self, net: "SimNetwork", src: int, dst: int,
                 outbound: bool = True):
        self.net = net
        self.src = src
        self.dst = dst
        self.closed = False
        self.rec = net.nodes[src].peer_ledger.open_peer(
            f"n{dst}", outbound=outbound)

    def send(self, chan_id: int, msg: bytes, block: bool = True) -> bool:
        if self.closed:
            return False
        return self.net._send(self.src, self.dst, chan_id, msg,
                              rec=self.rec)

    def close(self) -> None:
        if not self.closed:
            self.net.nodes[self.src].peer_ledger.drop_peer(
                self.rec, "closed")
        self.closed = True


class SimTransport:
    """The Transport seam (p2p/transport.py: listen/dial/on_conn) over
    the hub. `dial` establishes both directions synchronously and hands
    each side its SimConn via on_conn — the in-memory analog of the
    upgrade handshake (identity is the node index; there is nothing to
    forge inside one process)."""

    def __init__(self, net: "SimNetwork", idx: int,
                 on_conn: Callable[[SimConn], None]):
        self.net = net
        self.idx = idx
        self.on_conn = on_conn
        self.listening = False

    def listen(self) -> int:
        self.listening = True
        return self.idx

    def dial(self, peer_idx: int) -> SimConn:
        peer = self.net.nodes[peer_idx]
        if not peer.transport.listening:
            raise ConnectionError(f"sim node {peer_idx} not listening")
        ours = SimConn(self.net, self.idx, peer_idx)
        theirs = SimConn(self.net, peer_idx, self.idx, outbound=False)
        self.on_conn(ours)
        peer.transport.on_conn(theirs)
        return ours

    def close(self) -> None:
        self.listening = False


class SimTicker:
    """TimeoutTicker over simulated time, with the reference's override
    semantics (consensus/ticker.py TimeoutTicker: one live timer; a
    newer (height, round, step) replaces it; older/equal schedules are
    ignored)."""

    def __init__(self, net: "SimNetwork", node: "SimNode"):
        self.net = net
        self.node = node
        self._current: Optional[Tuple[TimeoutInfo, list]] = None

    def schedule(self, ti: TimeoutInfo) -> None:
        if self._current is not None:
            cur, alive = self._current
            if (ti.height, ti.round, ti.step) <= (
                cur.height, cur.round, cur.step
            ):
                return
            alive[0] = False  # cancel the displaced timer
        alive = [True]
        self._current = (ti, alive)
        self.net.schedule(ti.duration,
                          lambda: self._fire(ti, alive),
                          label=f"timeout n{self.node.idx}")

    def _fire(self, ti: TimeoutInfo, alive: list) -> None:
        if not alive[0] or not self.node.alive:
            return
        alive[0] = False
        cs = self.node.node.consensus
        cs.internal_queue.put(("timeout", ti))
        self.net._pump(self.node)

    def stop(self) -> None:
        if self._current is not None:
            self._current[1][0] = False


class SimNode:
    """One simulated validator: a real Node plus its sim plumbing.

    Byzantine knobs (armed by schedule ops / simnet.actors):
      equivocate_budget — next K own votes are double-signed: the real
        vote goes out AND a conflicting vote for a fabricated block ID,
        signed with the raw private key (bypassing FilePV's double-sign
        guard, as a real byzantine signer would).
      garbage_budget — next K own votes go out with garbage signatures
        (the real vote still enters the node's own sets; peers must
        reject the forgery without breaking their verify plane).
    """

    def __init__(self, net: "SimNetwork", idx: int, app_factory, priv,
                 home: str, group: int = 0):
        self.net = net
        self.idx = idx
        # which chain group this node validates (multi-chain simnet:
        # group g runs chain net.chain_ids[g]; meshes never cross)
        self.group = group
        self.app_factory = app_factory
        self.priv = priv
        self.home = home
        self.registry = fp.fresh_registry(fp.simulated_crash)
        self.transport = SimTransport(net, idx, self._on_conn)
        self.conns: Dict[int, SimConn] = {}  # peer idx -> outbound conn
        # gossip observatory: one per node, surviving restarts — the
        # same always-on ledger a real Switch carries, on the virtual
        # clock (byte-identical across replays)
        self.peer_ledger = peerledger.PeerLedger()
        self.node = None
        self.alive = False
        self.crashed = False
        self.restarts = 0
        self.equivocate_budget = 0
        self.garbage_budget = 0
        # height -> committed block hash, recorded as the chain grows
        # (survives kills: read from the store before it closes)
        self.commit_hashes: Dict[int, bytes] = {}
        # recent own votes (real, as signed) for sync-tick retransmission
        self._own_votes: deque = deque(maxlen=8)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Build the real Node and bring its consensus up WITHOUT the
        receive-routine thread — node/node.py on_start minus every
        thread, so the scheduler owns all execution."""
        from cometbft_tpu_torch.node.node import Node
        from cometbft_tpu_torch.privval.file_pv import FilePV

        with self.net._node_scope(self):
            # apps that persist (the bootstrap soak's KV-with-snapshots)
            # get the node's home dir so a restart reopens THEIR state;
            # plain factories (KVStoreApplication) take no kwargs
            try:
                app = self.app_factory(home=self.home)
            except TypeError:
                app = self.app_factory()
            self.node = Node(
                app, self.net.geneses[self.group].copy(),
                privval=FilePV(self.priv), home=self.home,
                broadcast=self._broadcast, timeouts=self.net.timeouts,
                device=self.net.device, batch_fn=self.net.batch_fn,
            )
            cs = self.node.consensus
            cs.ticker = SimTicker(self.net, self)
            cs.on_evidence = self._gossip_own_evidence
            # on_start is bypassed (the scheduler owns execution), so
            # register the height ledger here: incident snapshots and
            # /dump_heights read the module global — last-started node
            # wins, which is deterministic under the scheduler
            from cometbft_tpu_torch.consensus import heightledger

            heightledger.set_global_ledger(cs.height_ledger)
            # the net/sign late-signer join + last-started-wins global
            # registration (incident snapshots, replay-blob tails)
            cs.height_ledger.peer_ledger = self.peer_ledger
            peerledger.set_global_ledger(self.peer_ledger)
            # mark the service running without spawning its thread: the
            # scheduler pumps the queues the thread would have drained
            with cs._lock:
                cs._started = True
            self.alive = True
            self.crashed = False
            if cs._wal_path:
                cs._catchup_replay()
            cs.internal_queue.put(("start_round", cs.height, 0))
        self.transport.listen()

    def _on_conn(self, conn: SimConn) -> None:
        self.conns[conn.dst] = conn

    def connect_full_mesh(self) -> None:
        """Full mesh WITHIN this node's chain group: independent chains
        share the process (and the verify plane) but never a link."""
        for j, other in enumerate(self.net.nodes):
            if j != self.idx and other.group == self.group \
                    and other.alive and j not in self.conns:
                self.transport.dial(j)

    def halt(self, reason: str) -> None:
        """Crash landing: no graceful teardown beyond releasing file
        handles (sqlite commits are already durable; the WAL close is
        the same best-effort close consensus._halt performs)."""
        if not self.alive:
            return
        _log.warning("simnet node %d halted: %s", self.idx, reason)
        tracing.instant("simnet.halt", cat="simnet", node=self.idx)
        self._record_commits()
        self.alive = False
        self.crashed = True
        cs = self.node.consensus
        with cs._lock:
            cs._stopped = True
        cs.ticker.stop()
        for c in self.conns.values():
            c.close()
        self.conns.clear()
        try:
            if cs.wal:
                cs.wal.close()
        except Exception:  # noqa: BLE001 - crash path, best-effort
            pass
        self._close_stores()

    def restart(self) -> None:
        """Rebuild over the same home dir: handshake replay feeds the
        stores back into a fresh app, consensus catchup-replays its WAL
        — the crash-recovery path, driven mid-simulation."""
        assert not self.alive, "restart of a live node"
        self.restarts += 1
        tracing.instant("simnet.restart", cat="simnet", node=self.idx)
        self.start()
        self.connect_full_mesh()
        for other in self.net.nodes:
            if other.idx != self.idx and other.alive:
                other.connect_full_mesh()
        self.net._pump(self)

    def stop(self) -> None:
        """Graceful teardown at end of run."""
        if not self.alive:
            return
        self._record_commits()
        self.alive = False
        cs = self.node.consensus
        with cs._lock:
            cs._stopped = True
        cs.ticker.stop()
        if cs.wal:
            cs.wal.close()
        self._close_stores()

    def _close_stores(self) -> None:
        n = self.node
        try:
            n.indexer_service.stop()
        except Exception:  # noqa: BLE001 - service thread may be gone
            pass
        for closer in (n.block_store.close, n.state_store.close,
                       n.tx_indexer.close, n.block_indexer.close):
            try:
                closer()
            except Exception:  # noqa: BLE001 - already closed
                pass

    # -- chain observation -------------------------------------------------

    def height(self) -> int:
        if self.node is None:
            return 0
        return self.node.consensus.state.last_block_height

    def _record_commits(self) -> None:
        """Record committed block hashes while the store is open."""
        if self.node is None:
            return
        h = self.height()
        start = max(1, max(self.commit_hashes, default=0) + 1)
        for hh in range(start, h + 1):
            try:
                blk = self.node.block_store.load_block(hh)
            except Exception:  # noqa: BLE001 - store closing
                return
            if blk is not None:
                self.commit_hashes[hh] = blk.hash()

    # -- outbound ----------------------------------------------------------

    def _broadcast(self, msg) -> None:
        """ConsensusState's broadcast seam; runs inside a pump."""
        kind, payload = msg
        if kind == "vote":
            self._own_votes.append(payload)  # the REAL vote, as signed
            for data in self._vote_wire_msgs(payload):
                self._send_all(VOTE_CHANNEL, data)
        elif kind == "proposal":
            self._send_all(DATA_CHANNEL, _proposal_bytes(payload))

    def retransmit_votes(self) -> None:
        """Re-send current-height own votes (the gossipVotesRoutine
        analog, reactor.go:737): one-shot transmissions lost to drops,
        partitions, or a garbage-signing phase must eventually be
        replaced by the stored REAL votes, or rounds wedge forever with
        every validator waiting on votes nobody will resend. Goes back
        through the actor pipeline, so an active garbage budget garbles
        retransmissions too — recovery starts when the budget runs dry,
        exactly like a byzantine phase ending."""
        if not self.alive:
            return
        h = self.node.consensus.height
        for vote in list(self._own_votes):
            if vote.height != h:
                continue
            for data in self._vote_wire_msgs(vote):
                self._send_all(VOTE_CHANNEL, data)

    def _vote_wire_msgs(self, vote) -> List[bytes]:
        """Apply byzantine actor knobs to one outgoing own-vote."""
        from cometbft_tpu_torch.simnet import actors

        if self.garbage_budget > 0:
            self.garbage_budget -= 1
            return [_vote_bytes(actors.garbage_sign(vote, self.net.rng))]
        out = [_vote_bytes(vote)]
        if self.equivocate_budget > 0 and not vote.block_id.is_nil():
            self.equivocate_budget -= 1
            out.append(_vote_bytes(actors.conflicting_vote(
                vote, self.priv, self.net.chain_ids[self.group]
            )))
        return out

    def _send_all(self, chan_id: int, data: bytes,
                  except_peer: Optional[int] = None) -> None:
        for j, conn in self.conns.items():
            if j != except_peer:
                conn.send(chan_id, data)

    def _gossip_own_evidence(self, ev) -> None:
        """consensus.on_evidence: push locally-discovered evidence
        (evidence/reactor.py broadcast_evidence analog)."""
        self._send_all(EVIDENCE_CHANNEL,
                       json.dumps(evidence_to_j(ev)).encode())


class SimNetwork:
    """The hub: event queue, links, clock, and N SimNodes.

    Multi-chain hosting (`n_chains` > 1): the net carries K independent
    chain groups of `n_nodes` validators each — per-group chain_id,
    genesis, and keys; full mesh within a group, no links across — all
    pumped by the ONE scheduler. The groups share the process, which
    means they share a process-global verify plane when a test mounts
    one: K chains' signature work coalescing into single fused flushes
    is exactly the multi-tenant hosting story verifyplane/tenants.py
    implements, and group g is key-identical to a solo net seeded
    seed+g so its commits can be diffed against a solo run.

    Epoch-scale churn (`extra_validators` > 0): beyond the N running
    node-validators, the network carries a deterministic POOL of
    passive tail validators — pubkey-only members (hash-derived 32-byte
    keys; they never vote, so no curve math is ever paid for them) with
    stake weights. A proportional election (simnet/actors.py, the
    arXiv 2004.12990 rule) seats `committee_size` of them at genesis
    and the ``epoch`` schedule op re-elects K% of that committee per
    epoch through kvstore ``val:`` txs — i.e. through the REAL
    ABCI -> update_with_change_set -> state/execution.py rotation
    path on every node. Node-validators hold a supermajority of power
    by construction (checked at init), so the passive tail can churn
    freely without wedging quorum — exactly the production shape where
    a handful of big operators stay while the long tail re-elects."""

    def __init__(self, n_nodes: int, seed: int, basedir: str,
                 app_factory=None, timeouts=None, chain_id: str = "simnet",
                 power: int = 10, extra_validators: int = 0,
                 committee_size: Optional[int] = None,
                 n_chains: int = 1, device=None, batch_fn=None):
        import hashlib
        import os

        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
        from cometbft_tpu_torch.consensus.ticker import TimeoutParams
        from cometbft_tpu_torch.crypto.keys import PrivKey, PubKey
        from cometbft_tpu_torch.state.state import State
        from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

        # multi-chain simnet (the appchain-hosting shape): K chain
        # groups of n_nodes each, every group a fully independent chain
        # — own chain_id, own genesis, own validator keys, links only
        # within the group — all driven by ONE scheduler in ONE process,
        # so a process-global verify plane coalesces their signature
        # work exactly like a hosting pod would. n_nodes is PER CHAIN.
        self.n_chains = max(1, int(n_chains))
        self.n_per_chain = n_nodes
        if self.n_chains > 1 and extra_validators:
            raise ValueError(
                "extra_validators (epoch churn) supports single-chain "
                "simnets only — the tail pool and election state are "
                "per-network, not per-group")
        self.seed = seed
        # every Node this net builds gets these two (module docstring)
        self.device = device
        self.batch_fn = batch_fn
        self.rng = random.Random(seed)
        self.now = 0.0
        self._seq = 0
        self.events: list = []  # heap of (time, seq, fn, label)
        self.chain_id = chain_id
        self.chain_ids = ([chain_id] if self.n_chains == 1 else
                          [f"{chain_id}-{g}"
                           for g in range(self.n_chains)])
        # Sim seconds are free; REAL work per height (WAL fsyncs, sqlite
        # commits, host-path signature verifies) is not. The commit
        # timeout paces the chain relative to schedule windows — 0.25
        # keeps a height comfortably longer than the default link delay
        # while preventing schedules measured in sim-seconds from
        # burning dozens of wall-clock-expensive heights.
        self.timeouts = timeouts or TimeoutParams(
            propose=1.0, propose_delta=0.25,
            prevote=0.5, prevote_delta=0.25,
            precommit=0.5, precommit_delta=0.25,
            commit=0.25,
        )
        # chain g's keys derive from (seed + g, local index): group g
        # of a K-chain net is KEY-IDENTICAL to a solo single-chain net
        # built with seed seed+g — which is what lets the coalescing
        # acceptance compare a chain's commits on the shared plane
        # against the same chain run alone, byte for byte. n_chains=1
        # reduces to the original derivation exactly.
        self.privs = [
            PrivKey.generate(
                (((seed + i // n_nodes) % 2**32)
                 .to_bytes(4, "big"))              # seeds are arbitrary
                + bytes([i % n_nodes + 1]) + b"\x51" * 27  # replay blobs
            )
            for i in range(n_nodes * self.n_chains)
        ]
        val_lists = [
            [Validator(p.pub_key(), power)
             for p in self.privs[g * n_nodes:(g + 1) * n_nodes]]
            for g in range(self.n_chains)
        ]
        val_list = val_lists[0]
        # passive tail pool + proportional genesis committee (the
        # epoch-rotation surface; see the class docstring)
        self.tail_pubs: List[bytes] = []
        self.tail_stakes: Dict[int, tuple] = {}
        self.epoch_state: Optional[Dict] = None
        if extra_validators > 0:
            from cometbft_tpu_torch.simnet import actors

            self.tail_pubs = [
                hashlib.sha256(
                    b"simnet-tail-%d-%d" % (seed % 2**32, i)
                ).digest()
                for i in range(extra_validators)
            ]
            self.tail_stakes = {
                i: (self.tail_pubs[i], 1 + i % 7)
                for i in range(extra_validators)
            }
            size = min(committee_size or max(1, extra_validators // 2),
                       extra_validators)
            total_stake = sum(s for _, s in self.tail_stakes.values())
            if n_nodes * power <= 2 * total_stake:
                raise ValueError(
                    f"node power {n_nodes}x{power} must exceed 2x the "
                    f"tail stake total {total_stake}: the passive tail "
                    f"never votes, so it must never hold a blocking "
                    f"1/3 — raise `power` (the churn tests use 10^5+)"
                )
            ranked = sorted(
                range(extra_validators),
                key=lambda i: actors.election_score(
                    seed, 0, *self.tail_stakes[i]),
                reverse=True,
            )
            committee = sorted(ranked[:size])
            self.epoch_state = {
                "epoch": 0, "size": size,
                "committee": committee,
                "standby": sorted(ranked[size:]),
            }
            val_list += [
                Validator(PubKey(self.tail_pubs[i], "ed25519"),
                          self.tail_stakes[i][1])
                for i in committee
            ]
        self.geneses = [
            State.make_genesis(
                self.chain_ids[g], ValidatorSet(val_lists[g]),
                genesis_time=Timestamp(SIM_EPOCH_SECONDS, 0),
            )
            for g in range(self.n_chains)
        ]
        self.genesis = self.geneses[0]  # single-chain callers' alias
        total = n_nodes * self.n_chains
        app_factory = app_factory or KVStoreApplication
        self.nodes = [
            SimNode(self, i, app_factory, self.privs[i],
                    os.path.join(basedir, f"n{i}"), group=i // n_nodes)
            for i in range(total)
        ]
        self.links: Dict[Tuple[int, int], Link] = {
            (i, j): Link()
            for i in range(total) for j in range(total) if i != j
        }
        self.sync_interval = 0.5  # catch-up push cadence, sim seconds
        self._clock_installed = False

    def group_nodes(self, g: int) -> List[SimNode]:
        """The SimNodes validating chain group g (chain_ids[g])."""
        return [n for n in self.nodes if n.group == g]

    # -- clock + scheduler -------------------------------------------------

    def _sim_now(self) -> Timestamp:
        ns = int(round(self.now * 1_000_000_000))
        return Timestamp(SIM_EPOCH_SECONDS + ns // 1_000_000_000,
                         ns % 1_000_000_000)

    def _install_clock(self) -> None:
        if not self._clock_installed:
            set_now_source(self._sim_now)
            # traces run on the virtual clock too: every span/instant
            # timestamp is Timestamp.now().to_ns() = a deterministic
            # function of the schedule, so the same (seed, schedule)
            # exports an IDENTICAL trace
            tracing.set_clock(lambda: Timestamp.now().to_ns())
            self._clock_installed = True

    def _uninstall_clock(self) -> None:
        if self._clock_installed:
            set_now_source(None)
            tracing.set_clock(None)
            self._clock_installed = False

    def schedule(self, delay: float, fn: Callable[[], None],
                 label: str = "") -> None:
        self._seq += 1
        heapq.heappush(self.events,
                       (self.now + max(0.0, delay), self._seq, fn, label))

    @contextmanager
    def _node_scope(self, node: SimNode):
        """Execute with `node`'s failpoint registry installed (and the
        sim clock active)."""
        self._install_clock()
        old = fp.swap_registry(node.registry)
        try:
            yield
        finally:
            fp.swap_registry(old)

    # -- run loop ----------------------------------------------------------

    def start(self) -> None:
        self._install_clock()
        for n in self.nodes:
            n.start()
        for n in self.nodes:
            n.connect_full_mesh()
        for n in self.nodes:
            # first pump AFTER the mesh exists, so round-0 proposals and
            # votes actually reach peers
            self.schedule(0.0, lambda n=n: self._pump(n),
                          f"boot n{n.idx}")
        self.schedule(self.sync_interval, self._sync_tick, "sync")

    def run_until(self, cond: Optional[Callable[[], bool]] = None,
                  max_time: float = 120.0) -> bool:
        """Pop events until `cond()` holds or ABSOLUTE simulated time
        `max_time` is reached. Returns whether cond was met (True when
        cond is None and the loop ran out the clock)."""
        self._install_clock()
        while True:
            if cond is not None and cond():
                return True
            if not self.events:
                break
            t, _seq, fn, _label = self.events[0]
            if t > max_time:
                break
            heapq.heappop(self.events)
            self.now = max(self.now, t)
            fn()
        self.now = max(self.now, max_time)
        return cond() if cond is not None else True

    def close(self) -> None:
        for n in self.nodes:
            try:
                n.stop()
            except Exception:  # noqa: BLE001 - teardown best-effort
                _log.exception("simnet node %d teardown failed", n.idx)
        self._uninstall_clock()

    # -- transport ---------------------------------------------------------

    def _send(self, src: int, dst: int, chan_id: int,
              payload: bytes, rec=None) -> bool:
        link = self.links[(src, dst)]
        if not link.up:
            # the partition is VISIBLE in the ledger: the lost message
            # is attributed to the partitioned peer, which is what the
            # chaos-soak acceptance asserts
            if rec is not None:
                peerledger.note_link_drop(rec)
            return False
        r = self.rng
        if link.drop > 0.0 and r.random() < link.drop:
            if rec is not None:
                peerledger.note_inj_drop(rec)
            return True  # accepted for delivery, silently lost
        if rec is not None:
            peerledger.note_sent(rec, chan_id, len(payload))
        delay = link.delay
        if link.jitter > 0.0:
            delay += link.jitter * r.random()
        if link.reorder > 0.0 and r.random() < link.reorder:
            # push far enough back that later sends overtake this one
            delay += link.reorder_window * (0.5 + r.random())
            if rec is not None:
                peerledger.note_inj_delay(rec)
        self.schedule(delay,
                      lambda: self._deliver(dst, chan_id, payload, src),
                      f"deliver {src}->{dst}")
        if link.dup > 0.0 and r.random() < link.dup:
            self.schedule(delay + link.delay,
                          lambda: self._deliver(dst, chan_id, payload,
                                                src),
                          f"dup {src}->{dst}")
        return True

    def _deliver(self, dst: int, chan_id: int, payload: bytes,
                 src: Optional[int] = None) -> None:
        node = self.nodes[dst]
        if not node.alive:
            return
        if src is not None:
            rec = node.peer_ledger.rec_for(f"n{src}")
            if rec is not None:
                peerledger.note_recv(rec, chan_id, len(payload))
        crash = None
        with self._node_scope(node):
            try:
                self._route(node, chan_id, payload, src)
            except fp.SimulatedCrash as e:
                crash = str(e)
            except Exception:  # noqa: BLE001 - hostile payload, log only
                _log.exception("simnet node %d dropped message on %#x",
                               dst, chan_id)
        if crash is not None:
            node.halt(crash)
            return
        self._pump(node)

    def _route(self, node: SimNode, chan_id: int, payload: bytes,
               src: Optional[int] = None) -> None:
        """Inbound demux — the reactors' receive() analog, minus the
        per-peer bookkeeping the flood model doesn't need."""
        cs = node.node.consensus
        j = json.loads(payload.decode())
        if chan_id == VOTE_CHANNEL:
            # the reactor's bare vote_to_j wire form
            vote = serde.vote_from_j(j)
            # vote-propagation attribution: first-seen stamp + the
            # delivering hop (duplicate deliveries — link.dup faults,
            # retransmissions — count as dup receipts), same seam as
            # ConsensusReactor._receive_vote; gated to the two heights
            # the ledger ever joins so junk keys can't pin the table
            if cs.height - 1 <= vote.height <= cs.height:
                node.peer_ledger.note_vote_seen(
                    (vote.height, vote.round, vote.vote_type,
                     vote.validator_index),
                    f"n{src}" if src is not None else "?")
            cs.receive_vote(vote)
        elif chan_id == DATA_CHANNEL:
            if j.get("t") == "commit_block":
                cs.receive_commit_block(
                    serde.block_from_json(j["b"]),
                    serde.commit_from_j(j["c"]),
                )
            else:
                prop = _proposal_from_bytes(j)
                block = serde.block_from_json(j["b"])
                cs.receive_proposal(ProposalMsg(prop, block))
        elif chan_id == EVIDENCE_CHANNEL:
            ev = evidence_from_j(j)
            try:
                fresh = node.node.evidence_pool.add_evidence(ev)
            except EvidenceError as e:
                _log.warning("simnet node %d rejected evidence: %s",
                             node.idx, e)
                return
            if fresh:
                # relay exactly like evidence/reactor.py receive():
                # everyone EXCEPT the peer it came from
                node._send_all(EVIDENCE_CHANNEL, payload,
                               except_peer=src)
        else:
            raise ValueError(f"unknown sim channel {chan_id:#x}")

    # -- the pump ----------------------------------------------------------

    def _pump(self, node: SimNode) -> None:
        """Drain the node's consensus queues — the receive routine's
        loop body (consensus/state.py _receive_routine), executed
        synchronously under the scheduler."""
        if not node.alive:
            return
        cs = node.node.consensus
        crash = None
        with self._node_scope(node):
            while crash is None:
                item = self._next_item(cs)
                if item is None:
                    break
                try:
                    cs._handle(item, write_wal=True)
                except fp.SimulatedCrash as e:
                    crash = str(e)
                except Exception:  # noqa: BLE001 - engine must not die
                    _log.exception("simnet node %d handler failed",
                                   node.idx)
        node._record_commits()
        if crash is not None:
            node.halt(crash)

    @staticmethod
    def _next_item(cs):
        import queue as _q

        try:
            return cs.internal_queue.get_nowait()
        except _q.Empty:
            pass
        try:
            return cs.msg_queue.get_nowait()
        except _q.Empty:
            return None

    # -- catch-up ----------------------------------------------------------

    def _sync_tick(self) -> None:
        """Periodic catch-up pushes: any node ahead of a connected,
        reachable peer pushes the decided block + seen commit for the
        peer's next height (consensus/reactor.py _send_catchup). This is
        what restores liveness after partitions heal and after node
        restarts — the votes for old heights are gone, the blocks are
        not. Same-height recovery rides the vote retransmission pass."""
        for src in self.nodes:
            src.retransmit_votes()
        for i, src in enumerate(self.nodes):
            if not src.alive:
                continue
            for jdx, conn in list(src.conns.items()):
                dst = self.nodes[jdx]
                if not dst.alive or not self.links[(i, jdx)].up:
                    continue
                want = dst.node.consensus.height
                if src.height() < want:
                    continue
                try:
                    block = src.node.block_store.load_block(want)
                    commit = src.node.block_store.load_seen_commit(want)
                except Exception:  # noqa: BLE001 - store mid-close
                    continue
                if block is None or commit is None:
                    continue
                conn.send(DATA_CHANNEL, json.dumps({
                    "t": "commit_block",
                    "b": serde.block_to_json(block),
                    "c": serde.commit_to_j(commit),
                }).encode())
        self.schedule(self.sync_interval, self._sync_tick, "sync")


# -- wire helpers ----------------------------------------------------------
# votes reuse the reactor's _vote_bytes verbatim (imported above); the
# proposal message is the reactor's proposal dict plus the whole block
# embedded as its pre-serialized string — one encode here, one decode on
# receive, exactly like the commit_block push (the reactor ships the
# block as PartSet chunks instead; see the module docstring)


def _proposal_bytes(pm: ProposalMsg) -> bytes:
    from cometbft_tpu_torch.consensus import reactor as creactor

    j = json.loads(creactor._proposal_bytes(pm).decode())
    j["b"] = serde.block_to_json(pm.block)
    return json.dumps(j).encode()
