"""A height's precommits through the verify plane, height after height.

Each height's signed commit arrives as its validators' precommits: one
`submit_many` a vote (counted, with its validator index and the device
stamp of its sign-bytes, as the program's VoteSet submits it) into one
fresh QuorumGroup (threshold 2/3 + 1 of the power), from `threads`
threads at once. The plane is the program's `[verify_plane]` defaults
(`VerifyPlaneConfig(enable=True).build`), started once; its flush ledger
is given room for every flush of a run. A height ends when every future
has resolved; the next then starts. Heights go round a pool of `pool`
signed heights in passes; each pass first restores the signatures the
last pass flipped, then flips one seeded bit of `tamper` seeded
signatures of each height, far below 1/3 of the power.

Other parameters: `ref_rows` (signatures of each height the reference
verifies itself, drawn from the seed), `profile_ops` (heights in the
profiled slice), `ledger` (the flush ledger's room).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from portbench import fixtures, program
from portbench.driver import Driver as _Driver
from portbench.reference import ed25519, verdicts

RESULT_TIMEOUT_S = 60.0


@dataclass
class Height:
    slot: int
    tampers: tuple               # ((position, byte, bit), ...) of the pass
    t0: float = 0.0
    t1: float = 0.0
    quorum_ms: Optional[float] = None
    tally: int = -1
    reached: bool = False
    votes: Optional[np.ndarray] = None   # 1 valid, 0 invalid, -1 none
    flushes_before: int = 0              # ledger records before it
    attempted: int = 0
    items: int = 1               # heights
    failed: int = 0


class Driver(_Driver):
    span_names = ("plane.submit", "plane.wait_quorum", "plane.wait_futures")

    def setup(self) -> None:
        from cometbft_tpu_torch.config.config import VerifyPlaneConfig
        from cometbft_tpu_torch.types import canonical
        from cometbft_tpu_torch.types.vote import sign_bytes_template
        from cometbft_tpu_torch.verifyplane import FlushLedger, QuorumGroup

        cfg, p = self.config, self.p
        n = cfg["validators"]
        keys = fixtures.Keys(self.seed, n)
        key_powers = fixtures.powers(cfg, n)
        r = fixtures.rng(self.seed, fixtures.HEIGHTS)
        self.heights = [
            fixtures.signed_height(keys, key_powers, cfg["chain_id"],
                                   cfg["first_height"] + j, r,
                                   cfg["timestamp_spread_ns"])
            for j in range(p["pool"])]
        self.mark("inputs")
        h0 = self.heights[0]
        self.pubs = [keys.pubs[k] for k in h0.order]
        vs = program.valset(self.pubs, h0.powers)
        self.set_pubs = tuple(self.pubs)
        self.set_powers = tuple(h0.powers)
        self.threshold = sum(h0.powers) * 2 // 3 + 1
        self.Group = QuorumGroup
        # each vote as the program's VoteSet submits it; its sign-bytes
        # from the program's template, held to the reference's in check()
        self.subs, self.msgs = [], []
        for h in self.heights:
            tpl = sign_bytes_template(cfg["chain_id"],
                                      canonical.PRECOMMIT_TYPE, h.height,
                                      h.round, program.block_id(h.block_id))
            msgs = tpl.patch_rows(h.secs, h.nanos).tolist()
            self.msgs.append(msgs)
            self.subs.append([
                dict(rows=[(v.pub_key, m, sig)], power=v.voting_power,
                     counted=True, vidx=[i], stamp=[(tpl, s, ns)])
                for i, (v, m, sig, s, ns) in enumerate(zip(
                    vs.validators, msgs, h.sigs, h.secs, h.nanos))])
        if self.control:
            self.plane = ControlPlane(self)
        else:
            self.plane = VerifyPlaneConfig(enable=True).build(
                device=self.device)
            self.plane.ledger = FlushLedger(capacity=p["ledger"])
        self.plane.start()
        self.mark("program")
        self.tamper_rng = fixtures.rng(self.seed, fixtures.TAMPER)
        self.tampers: List[tuple] = []
        self.k = self.answered = 0
        warm = []
        for _ in range(2):
            self.op(warm)
        self._restore()
        self.k = 0

    def quiesce(self) -> None:
        """Wait until the ledger holds a record of every flush so far (a
        flush resolves its futures just before it records itself)."""
        ledger = self.plane.ledger
        deadline = time.perf_counter() + 10.0
        while ledger is not None and time.perf_counter() < deadline and \
                sum(r["rows"] for r in ledger.records()) < self.answered:
            time.sleep(0.01)

    def _restore(self) -> None:
        for slot, tampers in enumerate(self.tampers):
            for i, _, _ in tampers:
                self._set_sig(slot, i, self.heights[slot].sigs[i])
        self.tampers = []

    def _set_sig(self, slot: int, i: int, sig: bytes) -> None:
        sub = self.subs[slot][i]
        pub, msg, _ = sub["rows"][0]
        sub["rows"] = [(pub, msg, sig)]

    def _new_pass(self) -> None:
        self._restore()
        r = self.tamper_rng
        for slot, h in enumerate(self.heights):
            picked = r.choice(len(h.sigs), self.p["tamper"], replace=False)
            tampers = tuple((int(i), int(r.integers(64)), int(r.integers(8)))
                            for i in sorted(picked))
            for i, byte, bit in tampers:
                self._set_sig(slot, i, fixtures.flip(h.sigs[i], byte, bit))
            self.tampers.append(tampers)

    def op(self, sink: list) -> None:
        pool = len(self.heights)
        if self.k % pool == 0:
            self._new_pass()
        slot = self.k % pool
        self.k += 1
        subs = self.subs[slot]
        h = Height(slot, self.tampers[slot], attempted=len(subs))
        group = self.Group(self.threshold, f"h{slot}",
                           valset_pubs=self.set_pubs,
                           valset_powers=self.set_powers)
        futs = [None] * len(subs)
        go = threading.Event()
        step = self.p["threads"]
        plane, spans = self.plane, self.spans

        def worker(k):
            go.wait()
            with spans("plane.submit"):
                for i in range(k, len(subs), step):
                    futs[i] = plane.submit_many(group=group, **subs[i])

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(step)]
        for t in threads:
            t.start()
        if self.plane.ledger is not None:
            h.flushes_before = len(self.plane.ledger)
        h.t0 = time.perf_counter()
        go.set()
        with spans("plane.wait_quorum"):
            if group.wait_quorum(RESULT_TIMEOUT_S):
                h.quorum_ms = (time.perf_counter() - h.t0) * 1e3
        for t in threads:
            t.join(RESULT_TIMEOUT_S)
        votes = np.full(len(subs), -1, np.int8)
        with spans("plane.wait_futures"):
            for i, f in enumerate(futs):
                if f is None:
                    continue
                try:
                    votes[i] = bool(f.result(RESULT_TIMEOUT_S)[0])
                except Exception:  # noqa: BLE001 - a vote with no verdict
                    pass
        h.t1 = time.perf_counter()
        h.votes = votes
        h.failed = int((votes < 0).sum())
        self.answered += h.attempted - h.failed
        h.tally, h.reached = group.tally, group.quorum_reached
        sink.append(h)

    def _flushes(self, ops) -> List[dict]:
        """The ledger's records of the flushes that served `ops`, a run of
        consecutive heights that began after a `quiesce`."""
        ledger = self.plane.ledger
        if not ops or ledger is None:
            return []
        if len(ledger) >= self.p["ledger"]:
            raise RuntimeError("the flush ledger ran out of room")
        self.quiesce()
        want = sum(h.attempted - h.failed for h in ops)
        recs, got = [], 0
        for rec in ledger.records()[ops[0].flushes_before:]:
            if got >= want:
                break
            recs.append(rec)
            got += rec["rows"]
        return recs

    def rows(self, ops) -> dict:
        recs = self._flushes(ops)
        return {"cached_verify": sum(r["rows"] for r in recs
                                     if r["path"] == "fused")}

    def layer(self) -> dict:
        recs = self._flushes(self.ops)
        return {"quorum_ms": [h.quorum_ms for h in self.ops
                              if h.quorum_ms is not None],
                "flush_rows": [r["rows"] for r in recs],
                "flush_dev_ms": [r["dev_ms"] for r in recs]}

    def release(self) -> None:
        self.plane.stop()

    def check(self) -> List[tuple]:
        """Every vote's verdict, each height's tally and quorum bit
        against the reference, and the sign-bytes the program built
        against the reference's."""
        invalid = [set() for _ in self.heights]
        for slot, h in enumerate(self.heights):
            for i in fixtures.sample(self.seed, len(h.sigs),
                                     self.p["ref_rows"], slot):
                if not ed25519.verify(self.pubs[i], h.msgs[i], h.sigs[i]):
                    invalid[slot].add(i)
        wrong_votes = wrong_tally = wrong_quorum = 0
        known = {}
        for op in self.ops + self.later:
            h = self.heights[op.slot]
            bad = set(invalid[op.slot])
            for t in op.tampers:
                key = (op.slot,) + t
                if key not in known:
                    i, byte, bit = t
                    known[key] = not ed25519.verify(
                        self.pubs[i], h.msgs[i],
                        fixtures.flip(h.sigs[i], byte, bit))
                if known[key]:
                    bad.add(t[0])
            want = np.ones(len(h.sigs), np.int8)
            want[sorted(bad)] = 0
            answered = op.votes >= 0
            wrong_votes += int((op.votes[answered] != want[answered]).sum())
            tally = verdicts.group_tally(h.powers, bad)
            wrong_tally += op.tally != tally
            wrong_quorum += op.reached != (tally >= self.threshold)
        wrong_bytes = sum(m != r for msgs, h in zip(self.msgs, self.heights)
                          for m, r in zip(msgs, h.msgs))
        return [("votes_wrong", wrong_votes, 0),
                ("tallies_wrong", wrong_tally, 0),
                ("quorum_bits_wrong", wrong_quorum, 0),
                ("sign_bytes_wrong", wrong_bytes, 0),
                ("votes_unanswered", self.totals()[1], 0)]


class ControlPlane:
    """The control: the reference put in the plane's place, with one
    guarantee broken: it verifies one vote in 256, drawn from the seed,
    and takes the others as valid, then tallies the valid votes' power
    into their group."""

    def __init__(self, driver: Driver):
        self.r = fixtures.rng(driver.seed, fixtures.SAMPLE)
        self.lock = threading.Lock()
        self.ledger = None

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def submit_many(self, rows, power=0, group=None, counted=False, **_):
        with self.lock:
            pick = self.r.random() < 1 / 256
        ok = all(ed25519.verify(p.data, m, s) for p, m, s in rows) \
            if pick else True
        if ok and counted and group is not None:
            group.add(power)
        f = Future()
        f.set_result((ok,) * len(rows))
        return f
