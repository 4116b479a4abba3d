"""Gossip observatory: the always-on per-peer traffic ledger.

The flush ledger (/dump_flushes) explains where a FLUSH's milliseconds
went and the height ledger (/dump_heights) explains where a BLOCK's
commit latency went — but the p2p layer both depend on was a black box:
the height ledger's late-signer table could not say whether validator X
was late because it SIGNED late or because its precommit crawled
through a backed-up send queue, exactly the network-vs-crypto
decomposition PAPERS.md "Performance of EdDSA and BLS Signatures in
Committee-Based Consensus" shows dominates committee-scale commit
latency. This module is that instrument.

Design rules (the FlushLedger discipline, restated for p2p):

  * ALWAYS ON and cheap enough to never turn off: one scratch list per
    peer (allocated at connect, mutated in place by the send/recv
    routines) that BECOMES the drop-ring slot when the peer goes away —
    no per-message allocation beyond a first-touch channel slot. The
    per-message budget is < 10 us with tracing off
    (``bench.peer_ledger_bookkeeping_us``, asserted in tier-1).
  * Every stamp rides :func:`tracing.monotonic_ns` — the trace clock
    when tracing is on, the simnet's virtual clock under simulation —
    so the same (seed, schedule) replays a byte-identical peer ledger
    (asserted in tests/test_simnet.py + the chaos soak).
  * ONE instrumentation seam shared by the real stack
    (``MConnection``/``Peer``/``Switch``) and simnet's ``SimConn``: the
    per-message hooks are module functions over the record list, so the
    two transports cannot drift apart.
  * Bounded everywhere: live peers, the dropped-peer ring, the
    lifecycle event ring, and the vote-route table all carry hard caps.

Per peer x channel it records msgs/bytes sent+received; per peer it
records send-queue depth + high-water, blocked-put and full-queue-drop
counts, flow-control throttle stalls, ping RTT (the pong is stamped for
real — see MConnection._recv_routine), link-down drops (a simnet
partition is VISIBLE here, attributed to the partitioned peers), and
injected faults (p2p/fuzz.py + simnet drop/delay ops attribute
themselves instead of blaming the network). Peer lifecycle
(dial/handshake/drop with a structured reason) rides the event ring.

Vote propagation attribution: a bounded route table keyed on (height,
round, type, validator_index) records the FIRST-seen stamp + delivering
peer, relay stamps (when we forwarded it), and duplicate receipts.
``consensus/heightledger.py`` joins it at finalize so each late-signer
row splits into ``net_ms`` vs ``sign_ms`` and names the delivering hop.

Served as GET ``/dump_peers`` + the ``dump_peers`` JSON-RPC route;
summary counters are sampled into /metrics at scrape time; the compact
``tail()`` rides incident snapshots and simnet replay blobs.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from cometbft_tpu_torch.libs import incidents, tracing

# bounds: a 10k-validator mesh must never grow an unbounded dict here
MAX_LIVE_PEERS = 256       # live per-peer records tracked
DROP_RING_CAPACITY = 128   # dropped-peer history ring
EVENT_RING_CAPACITY = 256  # lifecycle events (dial/handshake/drop)
MAX_CHANNELS = 32          # per-peer channel-split slots
MAX_VOTE_KEYS = 8192       # vote route table entries (pruned per height)
RTT_TOP_K = 32             # per-peer RTT series sampled into /metrics

# lifecycle events (interned consts — the ledger never builds strings
# on the hot path; drop REASONS are caller-provided and bounded)
EV_DIAL = "dial"
EV_DIAL_FAIL = "dial_fail"
EV_UP = "up"
EV_DROP = "drop"

STATE_UP = "up"
STATE_DROPPED = "dropped"

# Record-field indices. One list per peer, FIELDS order, mutated in
# place by the send/recv routines; internal slots past the FIELDS
# window (ping-send stamp + clock generation) never leak into a dump.
(_P_PEER, _P_DIR, _P_BORN, _P_STATE, _P_REASON,
 _P_MTX, _P_BTX, _P_MRX, _P_BRX,
 _P_QDEPTH, _P_QHI, _P_BLOCKED, _P_FULLDROP,
 _P_THROTTLE, _P_THROTTLE_MS,
 _P_PINGS, _P_RTT, _P_RTT_MAX,
 _P_LINKDROP, _P_INJDROP, _P_INJDELAY,
 _P_VOTES, _P_DUPVOTES, _P_DROP_MS, _P_CHANS) = range(25)
_P_PING_NS, _P_GEN = 25, 26

# vote-route slots: [first_seen_ns, from_peer, dups, relays,
#                    first_relay_ns]
_V_SEEN, _V_FROM, _V_DUPS, _V_RELAYS, _V_RELAY_NS = range(5)

# record columns folded into the retired-totals accumulator when the
# drop ring evicts a record: summary() totals (and the /metrics
# counters sampled from them) must stay MONOTONE — a counter that goes
# backwards reads as a reset and fabricates rate spikes downstream
_TOTAL_IDXS = (_P_MTX, _P_BTX, _P_MRX, _P_BRX, _P_BLOCKED, _P_FULLDROP,
               _P_THROTTLE, _P_LINKDROP, _P_INJDROP, _P_INJDELAY,
               _P_VOTES, _P_DUPVOTES)


def _ms(ns: int) -> float:
    return round(ns / 1e6, 3)


# --------------------------------------------------------------------------
# the per-message seam: module functions over the record list, shared
# verbatim by MConnection (real p2p) and SimConn (simnet) — a few int
# stores each, well under the 10 us/message budget
# --------------------------------------------------------------------------


def detached_record(peer: str = "?", outbound: bool = False) -> list:
    """A record tracked by no ledger — keeps the seam unconditional for
    callers built without a ledger (tests, bare MConnections)."""
    t = tracing.monotonic_ns()
    return [peer, "out" if outbound else "in", _ms(t), STATE_UP, "",
            0, 0, 0, 0,
            0, 0, 0, 0,
            0, 0.0,
            0, 0.0, 0.0,
            0, 0, 0,
            0, 0, 0.0, {},
            0, tracing.clock_gen()]


def _chan_slot(rec: list, chan_id: int) -> Optional[list]:
    chans = rec[_P_CHANS]
    slot = chans.get(chan_id)
    if slot is None:
        if len(chans) >= MAX_CHANNELS:
            return None
        slot = [0, 0, 0, 0]  # m_tx, b_tx, m_rx, b_rx
        chans[chan_id] = slot
    return slot


def note_sent(rec: list, chan_id: int, nbytes: int) -> None:
    """One outbound message (wire bytes, all packets included)."""
    rec[_P_MTX] += 1
    rec[_P_BTX] += nbytes
    slot = _chan_slot(rec, chan_id)
    if slot is not None:
        slot[0] += 1
        slot[1] += nbytes


def note_recv(rec: list, chan_id: int, nbytes: int,
              eof: bool = True) -> None:
    """One inbound packet; ``eof`` marks message completion (bytes
    count per packet, msgs per completed message)."""
    rec[_P_BRX] += nbytes
    slot = _chan_slot(rec, chan_id)
    if slot is not None:
        slot[3] += nbytes
    if eof:
        rec[_P_MRX] += 1
        if slot is not None:
            slot[2] += 1


def note_queue_depth(rec: list, depth: int) -> None:
    rec[_P_QDEPTH] = depth
    if depth > rec[_P_QHI]:
        rec[_P_QHI] = depth


def note_blocked_put(rec: list) -> None:
    """A blocking send had to WAIT on a full channel queue — the
    backed-up-send-queue signal the late-signer split attributes."""
    rec[_P_BLOCKED] += 1
    incidents.note_peer_stall(1)


def note_full_drop(rec: list) -> None:
    """A message was dropped on a full queue (non-blocking send, or a
    blocking send that timed out) — starvation, counted into the
    ``peer_starvation`` incident window."""
    rec[_P_FULLDROP] += 1
    incidents.note_peer_stall(1)


def note_throttle(rec: list, stall_ms: float) -> None:
    """Flow-control (send-rate token bucket) stalled the send routine."""
    rec[_P_THROTTLE] += 1
    rec[_P_THROTTLE_MS] = round(rec[_P_THROTTLE_MS] + stall_ms, 3)


def note_ping_sent(rec: list) -> None:
    rec[_P_PING_NS] = tracing.monotonic_ns()
    rec[_P_GEN] = tracing.clock_gen()


def note_pong(rec: list) -> None:
    """Pong received: compute the RTT against the matching ping stamp
    (clock-generation guarded — a tracing toggle mid-flight must not
    record a cross-domain garbage duration)."""
    sent = rec[_P_PING_NS]
    if not sent or tracing.clock_gen() != rec[_P_GEN]:
        return
    rec[_P_PING_NS] = 0
    rtt = _ms(tracing.monotonic_ns() - sent)
    rec[_P_PINGS] += 1
    rec[_P_RTT] = rtt
    if rtt > rec[_P_RTT_MAX]:
        rec[_P_RTT_MAX] = rtt


def note_link_drop(rec: list) -> None:
    """The link itself ate the message (simnet partition / dead TCP
    write) — attributed to THIS peer, which is what makes a scheduled
    partition visible in /dump_peers."""
    rec[_P_LINKDROP] += 1


def note_inj_drop(rec: list) -> None:
    """An injected fault (p2p/fuzz.py, simnet drop probability) lost
    the message — chaos runs attribute themselves, not the network."""
    rec[_P_INJDROP] += 1


def note_inj_delay(rec: list) -> None:
    rec[_P_INJDELAY] += 1


def note_vote_rx(rec: list) -> None:
    rec[_P_VOTES] += 1


def note_dup_vote(rec: list) -> None:
    rec[_P_DUPVOTES] += 1


class PeerLedger:
    """Bounded per-peer traffic ledger + vote-route table + lifecycle
    event ring. One per Switch (real p2p) / per SimNode (simnet);
    module-global registration serves /dump_peers with the _LAST
    pattern (history survives stop)."""

    FIELDS = ("peer", "dir", "born_ms", "state", "reason",
              "msgs_tx", "bytes_tx", "msgs_rx", "bytes_rx",
              "q_depth", "q_hiwater", "blocked_puts", "full_drops",
              "throttle_stalls", "throttle_ms",
              "pings", "rtt_ms", "rtt_max_ms",
              "link_drops", "inj_drops", "inj_delays",
              "votes_rx", "dup_votes", "drop_ms", "chans")

    __slots__ = ("_live", "_ring", "_events", "_votes", "_lock",
                 "peers_opened", "peers_dropped", "votes_seen",
                 "votes_dup", "votes_relayed", "votes_dropped",
                 "_retired", "_retired_throttle_ms", "_retired_qhi")

    def __init__(self, capacity: int = DROP_RING_CAPACITY):
        # peer label -> live record (insertion-ordered for eviction)
        self._live: Dict[str, list] = {}
        self._ring: deque = deque(maxlen=max(16, int(capacity)))
        self._events: deque = deque(maxlen=EVENT_RING_CAPACITY)
        # totals of records the ring has evicted (summary() adds them
        # back so the exposed counters never decrease)
        self._retired: Dict[int, int] = dict.fromkeys(_TOTAL_IDXS, 0)
        self._retired_throttle_ms = 0.0
        self._retired_qhi = 0
        # (height, round, type, vidx) -> route slots
        self._votes: Dict[tuple, list] = {}
        self._lock = threading.Lock()
        self.peers_opened = 0
        self.peers_dropped = 0
        self.votes_seen = 0
        self.votes_dup = 0
        self.votes_relayed = 0
        self.votes_dropped = 0  # route table at capacity

    def __len__(self) -> int:
        with self._lock:
            return len(self._live)

    # -- peer lifecycle (switch/transport threads; lock-guarded) -----------

    def open_peer(self, peer: str, outbound: bool) -> list:
        """Register a connected peer; returns the record the send/recv
        seams mutate. A still-live record under the same label (a
        reconnect racing its drop) is retired to the ring first."""
        rec = detached_record(peer, outbound)
        with self._lock:
            old = self._live.pop(peer, None)
            if old is not None:
                self._finalize(old, "replaced")
            if len(self._live) >= MAX_LIVE_PEERS:
                # bound: retire the oldest live record (insertion order)
                victim = next(iter(self._live))
                self._finalize(self._live.pop(victim), "ledger_cap")
            self._live[peer] = rec
            self.peers_opened += 1
            self._events.append([_ms(tracing.monotonic_ns()), EV_UP,
                                 peer, "out" if outbound else "in"])
        return rec

    def _finalize(self, rec: list, reason: str) -> None:
        # lock held; the live scratch list BECOMES the ring slot
        rec[_P_STATE] = STATE_DROPPED
        rec[_P_REASON] = reason
        rec[_P_DROP_MS] = _ms(tracing.monotonic_ns())
        if len(self._ring) == self._ring.maxlen:
            # manual eviction so the evicted record's traffic folds
            # into the retired totals instead of vanishing from the
            # summary counters
            old = self._ring.popleft()
            retired = self._retired
            for i in _TOTAL_IDXS:
                retired[i] += old[i]
            self._retired_throttle_ms = round(
                self._retired_throttle_ms + old[_P_THROTTLE_MS], 3)
            if old[_P_QHI] > self._retired_qhi:
                self._retired_qhi = old[_P_QHI]
        self._ring.append(rec)
        self.peers_dropped += 1

    def drop_peer(self, rec: list, reason: str) -> None:
        """Peer gone: finalize the record into the drop ring with a
        structured reason and log the lifecycle event."""
        with self._lock:
            if self._live.get(rec[_P_PEER]) is rec:
                del self._live[rec[_P_PEER]]
            elif rec[_P_STATE] == STATE_DROPPED:
                return  # already retired (replaced/capacity race)
            self._finalize(rec, reason[:80])
            self._events.append([rec[_P_DROP_MS], EV_DROP,
                                 rec[_P_PEER], reason[:80]])

    def lifecycle(self, event: str, peer: str, detail: str = "") -> None:
        """Dial/handshake events that never produced a record."""
        with self._lock:
            self._events.append([_ms(tracing.monotonic_ns()), event,
                                 peer, detail[:80]])

    def rec_for(self, peer: str) -> Optional[list]:
        return self._live.get(peer)

    # -- vote propagation attribution (reactor/simnet receive seams) -------

    def note_vote_seen(self, key: tuple, peer: str) -> bool:
        """First-seen stamp + delivering peer for one vote message;
        repeat sightings count as duplicate receipts. Returns True on
        first sight."""
        with self._lock:
            slot = self._votes.get(key)
            if slot is not None:
                slot[_V_DUPS] += 1
                self.votes_dup += 1
                return False
            if len(self._votes) >= MAX_VOTE_KEYS:
                self.votes_dropped += 1
                return False
            self._votes[key] = [tracing.monotonic_ns(), peer, 0, 0, 0]
            self.votes_seen += 1
            return True

    def note_vote_relayed(self, key: tuple) -> None:
        """We forwarded this vote to a lacking peer (the gossip hop):
        first relay stamped, repeats counted."""
        with self._lock:
            slot = self._votes.get(key)
            if slot is None:
                return
            if not slot[_V_RELAYS]:
                slot[_V_RELAY_NS] = tracing.monotonic_ns()
            slot[_V_RELAYS] += 1
            self.votes_relayed += 1

    def vote_route(self, height: int, round_: int, vtype: int,
                   vidx: int) -> Optional[Tuple[str, int, float]]:
        """The height ledger's join: (delivering peer, duplicate
        receipts, our first-seen -> first-relay forwarding ms) for one
        vote, or None when this node never saw it over the network
        (its own vote, or a hub without peer attribution)."""
        with self._lock:
            slot = self._votes.get((height, round_, vtype, vidx))
            if slot is None:
                return None
            relay_ms = 0.0
            if slot[_V_RELAYS] and slot[_V_RELAY_NS] >= slot[_V_SEEN]:
                relay_ms = _ms(slot[_V_RELAY_NS] - slot[_V_SEEN])
            return (slot[_V_FROM], slot[_V_DUPS], relay_ms)

    def prune_votes(self, below_height: int) -> None:
        """Drop route entries for finalized heights (called by the
        height ledger once per finalize — the table stays a few heights
        deep, never MAX_VOTE_KEYS)."""
        with self._lock:
            stale = [k for k in self._votes if k[0] <= below_height]
            for k in stale:
                del self._votes[k]

    # -- readers (dump/scrape time; dict construction never rides the
    # message path) --------------------------------------------------------

    def _snapshot(self) -> Tuple[List[list], List[list], List[list]]:
        with self._lock:
            return (list(self._live.values()), list(self._ring),
                    list(self._events))

    def records(self) -> List[dict]:
        """Live + dropped records as dicts, live first (zip stops at
        the FIELDS window; the channel split becomes a nested dict)."""
        live, ring, _ = self._snapshot()
        out = []
        for r in live + ring:
            d = dict(zip(self.FIELDS, r))
            d["chans"] = {
                f"{cid:#04x}": {"msgs_tx": s[0], "bytes_tx": s[1],
                                "msgs_rx": s[2], "bytes_rx": s[3]}
                for cid, s in sorted(r[_P_CHANS].items())
            }
            out.append(d)
        return out

    def events(self) -> List[dict]:
        _, _, evs = self._snapshot()
        return [{"at_ms": e[0], "event": e[1], "peer": e[2],
                 "detail": e[3]} for e in evs]

    def rtt_rows(self, k: int = RTT_TOP_K) -> List[Tuple[str, float]]:
        """(peer, last RTT ms) for live peers with a measured RTT —
        the bounded per-peer /metrics series, worst RTT first so the
        top-K cut keeps the peers an operator actually cares about."""
        live, _, _ = self._snapshot()
        rows = [(r[_P_PEER], r[_P_RTT]) for r in live if r[_P_PINGS]]
        rows.sort(key=lambda pr: -pr[1])
        return rows[:k]

    def tail(self, n: int = 8) -> List[str]:
        """Compact per-peer lines — small enough to ride an incident
        snapshot or a simnet replay blob."""
        live, ring, _ = self._snapshot()
        out = []
        for r in (ring + live)[-n:]:
            out.append(
                f"{r[_P_PEER]} {r[_P_DIR]} {r[_P_STATE]}"
                + (f"({r[_P_REASON]})" if r[_P_REASON] else "")
                + f" tx={r[_P_MTX]}/{r[_P_BTX]}B"
                f" rx={r[_P_MRX]}/{r[_P_BRX]}B"
                f" q={r[_P_QDEPTH]}/{r[_P_QHI]}"
                + (f" blocked={r[_P_BLOCKED]}" if r[_P_BLOCKED] else "")
                + (f" drops={r[_P_FULLDROP]}" if r[_P_FULLDROP] else "")
                + (f" link_drops={r[_P_LINKDROP]}"
                   if r[_P_LINKDROP] else "")
                + (f" inj={r[_P_INJDROP]}d/{r[_P_INJDELAY]}s"
                   if r[_P_INJDROP] or r[_P_INJDELAY] else "")
                + (f" rtt={r[_P_RTT]}ms" if r[_P_PINGS] else "")
                + (f" dup_votes={r[_P_DUPVOTES]}"
                   if r[_P_DUPVOTES] else "")
            )
        return out

    def summary(self) -> dict:
        """Aggregates over live + dropped records plus the retired
        totals of ring-evicted records (read time only) — the counter
        surfaces here are monotone for the life of the ledger."""
        live, ring, _ = self._snapshot()
        recs = live + ring
        rtts = sorted(r[_P_RTT] for r in recs if r[_P_PINGS])
        retired = self._retired

        def total(idx):
            return int(sum(r[idx] for r in recs)) + retired[idx]

        from cometbft_tpu_torch.libs.quantiles import nearest_rank

        with self._lock:
            votes = {"seen": self.votes_seen, "dups": self.votes_dup,
                     "relayed": self.votes_relayed,
                     "tracked": len(self._votes),
                     "dropped": self.votes_dropped}
        return {
            "peers_live": len(live),
            "peers_dropped": self.peers_dropped,
            "msgs_tx": total(_P_MTX), "bytes_tx": total(_P_BTX),
            "msgs_rx": total(_P_MRX), "bytes_rx": total(_P_BRX),
            "q_hiwater": max(
                max((r[_P_QHI] for r in recs), default=0),
                self._retired_qhi),
            "blocked_puts": total(_P_BLOCKED),
            "full_drops": total(_P_FULLDROP),
            "throttle_stalls": total(_P_THROTTLE),
            "throttle_ms": round(
                sum(r[_P_THROTTLE_MS] for r in recs)
                + self._retired_throttle_ms, 3),
            "link_drops": total(_P_LINKDROP),
            "inj_drops": total(_P_INJDROP),
            "inj_delays": total(_P_INJDELAY),
            "rtt_ms": {"p50": nearest_rank(rtts, 0.5),
                       "p90": nearest_rank(rtts, 0.9),
                       "max": rtts[-1]} if rtts else None,
            "dup_votes": total(_P_DUPVOTES),
            "votes": votes,
        }

    def dump(self) -> dict:
        """The /dump_peers document."""
        return {"summary": self.summary(), "peers": self.records(),
                "events": self.events()}


# --------------------------------------------------------------------------
# the process-global ledger (_GLOBAL/_LAST — the FlushLedger pattern:
# /dump_peers reads history after the owning switch stopped)
# --------------------------------------------------------------------------

_GLOBAL: Optional[PeerLedger] = None
_LAST: Optional[PeerLedger] = None
_GLOBAL_LOCK = threading.Lock()


def set_global_ledger(led: Optional[PeerLedger]) -> None:
    global _GLOBAL, _LAST
    with _GLOBAL_LOCK:
        _GLOBAL = led
        if led is not None:
            _LAST = led


def clear_global_ledger(led: PeerLedger) -> None:
    """Unregister `led` iff it is the current global — one stopping
    switch must not tear down another's registration."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is led:
            _GLOBAL = None


def global_ledger() -> Optional[PeerLedger]:
    return _GLOBAL or _LAST


def dump_peers() -> dict:
    """The peer ledger of the current (or last) registered switch —
    history survives stop, like /dump_flushes."""
    led = _GLOBAL or _LAST
    if led is None:
        return {"summary": {"peers_live": 0, "peers_dropped": 0},
                "peers": [], "events": []}
    return led.dump()


def ledger_tail(n: int = 8) -> List[str]:
    led = _GLOBAL or _LAST
    return [] if led is None else led.tail(n)


def ledger_mark() -> tuple:
    """Position marker (which ledger, how much traffic) — consumers
    that only want THIS window's activity (simnet replay blobs) mark at
    start and attach the tail only when the ledger moved."""
    led = _GLOBAL or _LAST
    if led is None:
        return (None, -1)
    s = led.summary()
    return (id(led), s["msgs_tx"] + s["msgs_rx"] + led.peers_dropped)


def ledger_advanced(mark: tuple) -> bool:
    return ledger_mark() != mark
