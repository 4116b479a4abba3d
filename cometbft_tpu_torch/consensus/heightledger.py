"""Always-on per-height commit-latency ledger — the consensus-level
analog of the verify plane's FlushLedger.

/dump_flushes (PR 6) explains where a FLUSH's milliseconds went;
nothing explained where a BLOCK's commit latency goes: proposal
propagation vs prevote quorum vs precommit quorum vs persist+apply —
or WHICH validators drag the quorum instants. The multi-host DCN round
(ROADMAP item 2) and the BLS-vs-ed25519 decision (item 3, PAPERS.md
"Performance of EdDSA and BLS Signatures in Committee-Based
Consensus") both turn on exactly that per-height stage attribution.

Design rules (FlushLedger's, restated for consensus):

  * ALWAYS ON, and cheap enough to never turn off: one scratch list
    per height (allocated at height entry, mutated in place, and the
    very same list becomes the ring slot), raw ``tracing.monotonic_ns``
    ints stamped per step transition — no dicts, spans, or strings on
    the step path. ``bench.py`` measures the per-transition cost
    (``height_ledger_bookkeeping_us``, the cfg7-style row); budget is
    < 10 us with tracing OFF.
  * Every stamp rides :func:`tracing.monotonic_ns` — the trace clock
    when tracing is on, the simnet's virtual clock under simulation —
    so the same (seed, schedule) replays a byte-identical height
    ledger (asserted in tests/test_simnet.py).
  * Bounded: a 512-entry ring, read at dump/scrape time only. Served
    by GET ``/dump_heights`` + the ``dump_heights`` JSON-RPC route;
    stage percentiles are sampled into /metrics at scrape time
    (``consensus_height_stage_ms{stage,q}``).

Late-signer attribution: per height, each validator's FIRST precommit
arrival in the deciding round is stamped; at finalize the offsets
against the precommit-quorum instant (positive = arrived AFTER the
quorum — this validator did not help commit the block) and the absent
bitmap from the commit itself are folded into the record AND a bounded
chronically-late table (top-K served in /dump_heights, sampled as
``consensus_late_signer_heights_total{val,kind}``). This is the column
the DCN round will use to tell slow HOSTS from slow curves.

The network-vs-crypto split (ISSUE 14): each late offset decomposes
into ``net_ms`` (time the precommit spent in flight — receive instant
minus the vote's own signing timestamp, both on ``Timestamp.now()``'s
clock: the simnet's virtual clock under simulation, wall time live)
and ``sign_ms`` (the remainder: the vote was already late when it was
SIGNED). Joined against the gossip observatory
(``p2p/peerledger.py``), each late row also names the delivering hop
and its duplicate-receipt count, so /dump_heights says not just WHO
was late but WHERE the milliseconds went — the decomposition PAPERS.md
"Performance of EdDSA and BLS Signatures in Committee-Based Consensus"
shows dominates committee-scale commit latency.

The port's copy of the JAX package's consensus/heightledger.py: the same
record layout and dumps; a height's flush seqs join the port's verify
plane ledger (verifyplane.flush_stats_for_seqs).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from cometbft_tpu_torch.libs import tracing

HEIGHT_LEDGER_CAPACITY = 512

# how many validators the chronic late/absent aggregation tracks (a
# 10k-validator set must not grow an unbounded dict on the commit path)
MAX_TRACKED_SIGNERS = 4096
# how many per-height arrival stamps are kept (rounds x validators is
# unbounded under round escalation; past the cap arrivals are dropped,
# never the votes themselves)
MAX_ARRIVALS = 16384
# top-K rows served in /dump_heights and sampled into /metrics
TOP_K_LATE = 16
# post-commit stragglers folded into a finalized record (one per
# validator; the bound also caps the per-height signature-verify cost
# the straggler admission pays on the consensus thread)
MAX_STRAGGLERS = 64

# record paths (interned consts, FlushLedger's PATH_* discipline)
VIA_CONSENSUS = "consensus"   # the normal step machine decided it
VIA_CATCHUP = "catchup"       # peer catch-up push (_apply_commit_block)

# Record-field indices. One list per height, FIELDS order, plus
# internal slots (scratch state) past the FIELDS window that readers
# never see — the finalize step overwrites the stage slots (raw ns
# while the height is live) with cumulative ms-from-height-start.
(_H_HEIGHT, _H_TS, _H_ROUNDS, _H_PROP, _H_VIA, _H_PROPOSAL, _H_PREVOTE,
 _H_PRECOMMIT, _H_COMMIT, _H_APPLY, _H_PLANE, _H_PLANE_N, _H_TXS,
 _H_BYTES, _H_FSYNC, _H_COLD, _H_LATE, _H_ABSENT, _H_BITMAP) = range(19)
# internal slots: height-entry ns, clock generation at entry, the WAL
# ledger-clock fsync accumulator at entry, the arrival-stamp dict, and
# the flush-seq set joined against the verify plane's ledger
_H_T0NS, _H_GEN, _H_FSYNC0, _H_ARRIVALS, _H_SEQS = 19, 20, 21, 22, 23

# consensus step ids -> the stage slot that step's ENTRY stamps
# (imported numerically to keep this module import-light; the values
# are consensus.state's STEP_* constants, asserted there)
STEP_PREVOTE = 4
STEP_PRECOMMIT = 6
STEP_COMMIT = 8
# types/canonical.PRECOMMIT_TYPE, numerically for the same reason —
# the peer-ledger vote-route join keys on it
PRECOMMIT_TYPE = 2
_STEP_SLOT = {
    STEP_PREVOTE: _H_PROPOSAL,     # proposal phase over (quorum forming)
    STEP_PRECOMMIT: _H_PREVOTE,    # +2/3 prevotes (or prevote timeout)
    STEP_COMMIT: _H_PRECOMMIT,     # +2/3 precommits on a block
}


class HeightLedger:
    """Bounded ring of per-height commit-latency records.

    Record fields (``FIELDS``): height, commit timestamp (ms on the
    ledger clock), rounds taken, proposer (hex prefix), the via path,
    the stage timeline as CUMULATIVE ms from height entry —
    proposal_ms (first prevote entry of the deciding round),
    prevote_quorum_ms (precommit entry), precommit_quorum_ms (commit
    entry), commit_ms (finalize start), apply_ms (block persisted +
    applied) — verify-plane ms attributed by joining the flush-ledger
    seqs that served this height's votes (plane_ms work time +
    plane_flushes joined), tx count, block tx bytes, WAL fsync ms on
    the ledger clock, the cold-table flag (a joined fused flush paid a
    valset table build inline), the late list ([validator_index,
    offset_ms, net_ms, sign_ms, via] rows — offset > 0 = precommit
    arrived AFTER the quorum instant, split into in-flight net_ms vs
    signed-late sign_ms, ``via`` naming the delivering peer when the
    gossip observatory saw the hop), absent precommit count, and the
    absent bitmap (hex, validator-index order). Written by the
    consensus receive routine; read by /dump_heights, scrape-time
    /metrics percentiles, incident snapshots, and simnet replay
    blobs."""

    FIELDS = ("height", "ts_ms", "rounds", "proposer", "via",
              "proposal_ms", "prevote_quorum_ms", "precommit_quorum_ms",
              "commit_ms", "apply_ms", "plane_ms", "plane_flushes",
              "txs", "block_bytes", "wal_fsync_ms", "cold_tables",
              "late", "absent", "absent_bitmap")

    STAGES = ("proposal", "prevote_quorum", "precommit_quorum",
              "commit", "apply")

    __slots__ = ("_ring", "_cur", "_late_heights", "_late_dropped",
                 "peer_ledger", "_last_commit")

    def __init__(self, capacity: int = HEIGHT_LEDGER_CAPACITY):
        self._ring = deque(maxlen=max(16, int(capacity)))
        self._cur: Optional[list] = None
        # straggler anchor for the JUST-finalized height:
        # [height, raw quorum ns, clock gen, commit round, ring record,
        #  vidx-seen set] — precommits that arrive after the node moved
        # on are folded into the finalized record post-hoc
        self._last_commit: Optional[list] = None
        # vidx -> [late_heights, absent_heights, net_ms, sign_ms]
        # (bounded; the chronic table — net/sign sums are what tell a
        # slow HOST from a slow SIGNER across heights)
        self._late_heights: Dict[int, list] = {}
        self._late_dropped = 0
        # the gossip observatory of the owning node (p2p/peerledger.py
        # PeerLedger), wired by Node/SimNode; None = no hop attribution
        self.peer_ledger = None

    def __len__(self) -> int:
        return len(self._ring)

    # -- the hot path (consensus receive routine) --------------------------

    def on_step(self, height: int, round_: int, step: int) -> None:
        """One step transition: open the height scratch on first sight
        of a new height, ratchet the round count, stamp the stage slot
        (LAST-wins — under round escalation the deciding round's
        timeline is the one that explains the commit latency). Budget:
        one clock read + a dict lookup + two list stores."""
        t = tracing.monotonic_ns()
        cur = self._cur
        if cur is None or cur[_H_HEIGHT] != height:
            cur = self._open(height, t)
        if round_ > cur[_H_ROUNDS]:
            cur[_H_ROUNDS] = round_
        slot = _STEP_SLOT.get(step)
        if slot is not None:
            cur[slot] = t

    def _open(self, height: int, t: int) -> list:
        # the one allocation per height: this list IS the ring slot
        cur = [height, 0.0, 0, "", VIA_CONSENSUS,
               0, 0, 0, 0, 0,          # stage slots hold raw ns while live
               0.0, 0, 0, 0, 0.0, 0, (), 0, "",
               t, tracing.clock_gen(), -1.0, {}, set()]
        self._cur = cur
        return cur

    def note_vote(self, round_: int, vidx: int,
                  net_ns: int = 0) -> None:
        """First precommit arrival stamp for (round, validator). Called
        by the receive routine AFTER a precommit was admitted.
        ``net_ns`` is the vote's in-flight time (receive instant minus
        its signing timestamp, both on Timestamp.now()'s clock) — the
        network half of the late-signer split."""
        cur = self._cur
        if cur is None:
            return
        arrivals = cur[_H_ARRIVALS]
        key = (round_, vidx)
        if key not in arrivals and len(arrivals) < MAX_ARRIVALS:
            arrivals[key] = (tracing.monotonic_ns(), net_ns)

    def wants_straggler(self, height: int, round_: int,
                        vidx: int) -> bool:
        """Cheap predicate the consensus straggler admission runs
        BEFORE paying a signature verify: True iff a precommit for
        (height, round, vidx) would actually be folded — the height is
        the last finalized one, the round is its commit round, the
        validator has no late row yet, and the bound has room."""
        lc = self._last_commit
        return bool(lc is not None and lc[0] == height and lc[1]
                    and lc[3] == round_ and vidx not in lc[5]
                    and len(lc[4][_H_LATE]) < MAX_STRAGGLERS)

    def burn_straggler(self, height: int, round_: int,
                       vidx: int) -> None:
        """Mark a straggler slot consumed WITHOUT folding a row — the
        consensus admission calls this when the signature verify
        FAILED, so a forged flood for one validator costs exactly one
        verify per height (the docstring bound on wants_straggler) at
        the price of that validator's attribution for the height."""
        lc = self._last_commit
        if lc is not None and lc[0] == height and lc[3] == round_:
            lc[5].add(vidx)

    def note_straggler(self, height: int, round_: int, vidx: int,
                       net_ns: int = 0) -> None:
        """A verified precommit for the JUST-FINALIZED height arrived
        after the node moved on: fold its lateness into the finalized
        record (same net/sign split + hop join as pre-finalize late
        rows). Runs on the receive routine — single writer, like every
        other ledger mutation."""
        lc = self._last_commit
        if lc is None or lc[0] != height or lc[3] != round_:
            return
        h, q_ns, gen, _cr, rec, seen = lc
        if not q_ns or vidx in seen \
                or tracing.clock_gen() != gen \
                or len(rec[_H_LATE]) >= MAX_STRAGGLERS:
            return
        off = (tracing.monotonic_ns() - q_ns) / 1e6
        if off <= 0.0:
            return
        seen.add(vidx)
        net_ms = min(off, max(0.0, net_ns / 1e6))
        via = ""
        pled = self.peer_ledger
        if pled is not None:
            route = pled.vote_route(height, round_, PRECOMMIT_TYPE,
                                    vidx)
            if route is not None:
                via = route[0]
                if route[1]:
                    via += f"+{route[1]}dup"
        row = [vidx, round(off, 3), round(net_ms, 3),
               round(off - net_ms, 3), via]
        # the ring record is the SAME list object — the appended row is
        # visible to every later dump/summary read; re-sort so the
        # documented validator-index order survives straggler folds
        rec[_H_LATE].append(row)
        rec[_H_LATE].sort()
        self._fold_chronic([row], [])

    def note_flush_seq(self, seq: int) -> None:
        """A verify-plane flush (by ledger seq) served one of this
        height's votes — the join key against /dump_flushes."""
        cur = self._cur
        if cur is not None and len(cur[_H_SEQS]) < 512:
            cur[_H_SEQS].add(seq)

    def note_wal_fsync_base(self, fsync_led_ns: int) -> None:
        """Anchor the per-height WAL fsync attribution: the consensus
        engine passes its WAL's ledger-clock fsync accumulator once the
        height opens (the first WAL write of the height)."""
        cur = self._cur
        if cur is not None and cur[_H_FSYNC0] < 0:
            cur[_H_FSYNC0] = fsync_led_ns

    def on_commit(self, height: int) -> None:
        """Finalize started (block + commit in hand, about to persist)."""
        cur = self._cur
        if cur is not None and cur[_H_HEIGHT] == height:
            cur[_H_COMMIT] = tracing.monotonic_ns()

    # -- finalize (once per height) ----------------------------------------

    def record_height(self, height: int, commit_round: int,
                      proposer_hex: str, n_txs: int, block_bytes: int,
                      commit_sigs=None, fsync_led_ns: int = 0,
                      via: str = VIA_CONSENSUS) -> Optional[dict]:
        """Close the height: convert stamps to cumulative ms, join the
        verify-plane flush seqs, compute late-signer offsets against
        the precommit-quorum instant and the absent bitmap from the
        commit, fold the chronic table, and append the ring slot.
        Runs once per height on the receive routine — allocation here
        is off the step-transition budget."""
        t_apply = tracing.monotonic_ns()
        cur = self._cur
        if cur is None or cur[_H_HEIGHT] != height:
            # catch-up heights can land with no step history at all
            cur = self._open(height, t_apply)
        self._cur = None
        cur[_H_VIA] = via
        cur[_H_PROP] = proposer_hex
        cur[_H_TXS] = int(n_txs)
        cur[_H_BYTES] = int(block_bytes)

        t0 = cur[_H_T0NS]
        same_gen = tracing.clock_gen() == cur[_H_GEN]

        def rel_ms(ns: int) -> float:
            # 0 = stage never stamped (or clock domain changed mid-
            # height — the FlushLedger clock_gen hazard; the record
            # stays, the durations do not lie)
            if not ns or not same_gen:
                return 0.0
            return round((ns - t0) / 1e6, 3)

        q_ns = cur[_H_PRECOMMIT]  # precommit-quorum instant (raw ns)
        cur[_H_TS] = round(t_apply / 1e6, 3) if same_gen else 0.0
        cur[_H_PROPOSAL] = rel_ms(cur[_H_PROPOSAL])
        cur[_H_PREVOTE] = rel_ms(cur[_H_PREVOTE])
        cur[_H_PRECOMMIT] = rel_ms(cur[_H_PRECOMMIT])
        cur[_H_COMMIT] = rel_ms(cur[_H_COMMIT])
        cur[_H_APPLY] = rel_ms(t_apply)

        # WAL fsync attribution (ledger clock: virtual => 0 under
        # simnet, real fsync cost on a production node)
        if fsync_led_ns and cur[_H_FSYNC0] >= 0:
            cur[_H_FSYNC] = round(
                max(0, fsync_led_ns - cur[_H_FSYNC0]) / 1e6, 3)

        # verify-plane join: which flushes served this height's votes,
        # what they cost, and whether any paid a cold table build
        seqs = cur[_H_SEQS]
        if seqs:
            from cometbft_tpu_torch import verifyplane

            join = verifyplane.flush_stats_for_seqs(seqs)
            cur[_H_PLANE] = join["ms"]
            cur[_H_PLANE_N] = join["flushes"]
            cur[_H_COLD] = join["cold"]

        # late-signer offsets: the deciding round's precommit arrivals
        # vs the quorum instant, each split net_ms vs sign_ms and
        # joined against the gossip observatory for the delivering hop;
        # absent bitmap from the commit itself
        late: List[list] = []
        arrivals = cur[_H_ARRIVALS]
        pled = self.peer_ledger
        if q_ns and same_gen and arrivals:
            for (r, vidx), (t_ns, net_ns) in arrivals.items():
                if r != commit_round:
                    continue
                off = (t_ns - q_ns) / 1e6
                if off <= 0.0:
                    continue
                # the split: lateness explained by flight time first
                # (a backed-up send queue shows up HERE), remainder =
                # the vote was already late when it was signed
                net_ms = min(off, max(0.0, net_ns / 1e6))
                via = ""
                if pled is not None:
                    route = pled.vote_route(height, commit_round,
                                            PRECOMMIT_TYPE, vidx)
                    if route is not None:
                        via = route[0]
                        if route[1]:
                            via += f"+{route[1]}dup"
                late.append([vidx, round(off, 3), round(net_ms, 3),
                             round(off - net_ms, 3), via])
            late.sort()
        cur[_H_LATE] = late
        # arm the straggler path: precommits for THIS height arriving
        # after the node advances still attribute against its quorum
        # instant (the reference folds them into the next LastCommit;
        # this implementation drops them — but their lateness is the
        # single most valuable late-signer signal, so the ledger
        # stamps them into the finalized record post-hoc)
        self._last_commit = [height, q_ns if same_gen else 0,
                             cur[_H_GEN], commit_round, cur,
                             {row[0] for row in late}]
        if pled is not None:
            # prune one height BEHIND: the just-finalized height's
            # routes must survive for the straggler join
            pled.prune_votes(height - 1)
        absent_idx: List[int] = []
        if commit_sigs is not None:
            bits = bytearray((len(commit_sigs) + 7) // 8)
            for i, cs in enumerate(commit_sigs):
                if cs.is_absent():
                    absent_idx.append(i)
                    bits[i >> 3] |= 1 << (i & 7)
            cur[_H_ABSENT] = len(absent_idx)
            cur[_H_BITMAP] = bytes(bits).hex() if absent_idx else ""

        self._fold_chronic(late, absent_idx)
        self._ring.append(cur)
        return None

    def _fold_chronic(self, late: List[list],
                      absent_idx: List[int]) -> None:
        table = self._late_heights
        for vidx, _off, net_ms, sign_ms, _via in late:
            slot = table.get(vidx)
            if slot is None:
                if len(table) >= MAX_TRACKED_SIGNERS:
                    self._late_dropped += 1
                    continue
                slot = table[vidx] = [0, 0, 0.0, 0.0]
            slot[0] += 1
            slot[2] = round(slot[2] + net_ms, 3)
            slot[3] = round(slot[3] + sign_ms, 3)
        for vidx in absent_idx:
            slot = table.get(vidx)
            if slot is not None:
                slot[1] += 1
            elif len(table) < MAX_TRACKED_SIGNERS:
                table[vidx] = [0, 1, 0.0, 0.0]
            else:
                self._late_dropped += 1

    # -- readers (dump/scrape time) ----------------------------------------

    def records(self) -> List[dict]:
        """The ring as dicts, oldest first (dict construction at READ
        time — never on the step path). zip stops at the FIELDS window
        so scratch slots never leak; the live (unfinalized) height's
        scratch is excluded by construction (only record_height
        appends)."""
        return [dict(zip(self.FIELDS, r)) for r in list(self._ring)]

    def tail(self, n: int = 8) -> List[str]:
        """Compact last-n-heights strings — small enough to ride an
        incident snapshot or a simnet replay blob."""
        out = []
        for r in list(self._ring)[-n:]:
            out.append(
                f"h{r[_H_HEIGHT]} r{r[_H_ROUNDS]} {r[_H_VIA]} "
                f"prop={r[_H_PROPOSAL]}ms pv={r[_H_PREVOTE]}ms "
                f"pc={r[_H_PRECOMMIT]}ms commit={r[_H_COMMIT]}ms "
                f"apply={r[_H_APPLY]}ms"
                + (f" plane={r[_H_PLANE]}ms" if r[_H_PLANE_N] else "")
                + (f" late={len(r[_H_LATE])}" if r[_H_LATE] else "")
                + (f" absent={r[_H_ABSENT]}" if r[_H_ABSENT] else "")
                + (" cold" if r[_H_COLD] else "")
            )
        return out

    def top_late_signers(self, k: int = TOP_K_LATE) -> List[dict]:
        """The chronically-late table: validators ranked by how many
        heights they arrived late or absent, with the cumulative
        net-vs-sign split (the DCN round's slow-host-vs-slow-curve
        column: a big net_ms says the HOP is slow, a big sign_ms says
        the SIGNER is)."""
        rows = [{"val": vidx, "late_heights": late, "absent_heights": ab,
                 "net_ms": net, "sign_ms": sign, "total": late + ab}
                for vidx, (late, ab, net, sign)
                in list(self._late_heights.items())]
        rows.sort(key=lambda r: (-r["total"], r["val"]))
        return rows[:k]

    def summary(self) -> dict:
        """Percentile summary over the ring (computed at read time)."""
        recs = list(self._ring)
        if not recs:
            return {"heights": 0}
        from cometbft_tpu_torch.libs.quantiles import nearest_rank

        def pcts(xs):
            s = sorted(xs)
            return {"p50": nearest_rank(s, 0.5),
                    "p90": nearest_rank(s, 0.9),
                    "p99": nearest_rank(s, 0.99), "max": s[-1]}

        stage_cols = {
            "proposal": [r[_H_PROPOSAL] for r in recs],
            "prevote_quorum": [r[_H_PREVOTE] for r in recs],
            "precommit_quorum": [r[_H_PRECOMMIT] for r in recs],
            "commit": [r[_H_COMMIT] for r in recs],
            "apply": [r[_H_APPLY] for r in recs],
        }
        return {
            "heights": len(recs),
            "first_height": recs[0][_H_HEIGHT],
            "last_height": recs[-1][_H_HEIGHT],
            "rounds_max": max(r[_H_ROUNDS] for r in recs),
            "multi_round_heights": sum(
                1 for r in recs if r[_H_ROUNDS] > 0),
            # cumulative-timeline percentiles per stage; apply_ms IS
            # the commit latency (height entry -> block applied)
            "stage_ms": {k: pcts(v) for k, v in stage_cols.items()},
            "commit_latency_ms": pcts([r[_H_APPLY] for r in recs]),
            "txs": int(sum(r[_H_TXS] for r in recs)),
            "plane_ms": round(sum(r[_H_PLANE] for r in recs), 3),
            "plane_flushes": int(sum(r[_H_PLANE_N] for r in recs)),
            "wal_fsync_ms": round(sum(r[_H_FSYNC] for r in recs), 3),
            "cold_table_heights": sum(1 for r in recs if r[_H_COLD]),
            "late_votes": int(sum(len(r[_H_LATE]) for r in recs)),
            # the network-vs-crypto decomposition over every late
            # arrival in the window: where the late milliseconds went
            "late_net_ms": round(sum(
                row[2] for r in recs for row in r[_H_LATE]), 3),
            "late_sign_ms": round(sum(
                row[3] for r in recs for row in r[_H_LATE]), 3),
            "absent_votes": int(sum(r[_H_ABSENT] for r in recs)),
            "catchup_heights": sum(
                1 for r in recs if r[_H_VIA] == VIA_CATCHUP),
            "late_signers_tracked": len(self._late_heights),
            "late_signers_dropped": self._late_dropped,
        }

    def dump(self) -> dict:
        """The /dump_heights document."""
        return {
            "summary": self.summary(),
            "late_signers": self.top_late_signers(),
            "heights": self.records(),
        }


# --------------------------------------------------------------------------
# the process-global ledger (_GLOBAL/_LAST — the FlushLedger pattern:
# /dump_heights reads history after the owning consensus stopped)
# --------------------------------------------------------------------------

_GLOBAL: Optional[HeightLedger] = None
_LAST: Optional[HeightLedger] = None
_GLOBAL_LOCK = threading.Lock()


def set_global_ledger(led: Optional[HeightLedger]) -> None:
    global _GLOBAL, _LAST
    with _GLOBAL_LOCK:
        _GLOBAL = led
        if led is not None:
            _LAST = led


def clear_global_ledger(led: HeightLedger) -> None:
    """Unregister `led` iff it is the current global — one stopping
    consensus engine must not tear down another's registration."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is led:
            _GLOBAL = None


def global_ledger() -> Optional[HeightLedger]:
    return _GLOBAL or _LAST


def dump_heights() -> dict:
    """The height ledger of the current (or last) registered consensus
    engine — history survives stop, like /dump_flushes."""
    led = _GLOBAL or _LAST
    if led is None:
        return {"summary": {"heights": 0}, "late_signers": [],
                "heights": []}
    return led.dump()


def ledger_tail(n: int = 8) -> List[str]:
    led = _GLOBAL or _LAST
    return [] if led is None else led.tail(n)


def ledger_mark() -> tuple:
    """Position marker (which ledger, how far written) — consumers that
    only want THIS window's heights (simnet replay blobs) mark at start
    and attach the tail only when the ledger moved past the mark."""
    led = _GLOBAL or _LAST
    if led is None:
        return (None, -1)
    ring = led._ring
    return (id(led), ring[-1][_H_HEIGHT] if ring else -1)


def ledger_advanced(mark: tuple) -> bool:
    return ledger_mark() != mark
