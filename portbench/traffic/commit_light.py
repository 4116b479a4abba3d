"""`VerifyCommitLight` calls in a closed loop over a pool of signed commits.

Each call is `types.validation.verify_commit_light` with the program's
`device_batch_fn()`, which the benchmark wraps to time it and to keep
what it was given and what it answered. Calls go round the pool in
passes; each pass first restores the signature the last pass flipped,
then flips one seeded bit of one seeded signature among those the call
collects, in one seeded commit of the pool, so that commit has to be
refused with that signature's index.

Traffic parameters: `pool` (commits), `ref_rows` (signatures of each
commit the reference verifies itself, drawn from the seed),
`profile_ops` (calls in the profiled slice).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from portbench import fixtures, program
from portbench.driver import Driver as _Driver
from portbench.driver import outcome
from portbench.reference import ed25519, verdicts


@dataclass
class Call:
    slot: int
    tamper: Optional[tuple]      # (slot, index, byte, bit) of its pass
    t0: float = 0.0
    t1: float = 0.0
    verdict: Optional[tuple] = None
    batch_ms: float = 0.0
    n_rows: int = -1
    bad: List[int] = field(default_factory=list)   # rows it found invalid
    attempted: int = 1
    items: int = 0               # calls answered
    failed: int = 0


class Driver(_Driver):
    span_names = ("validation.verify_commit_light", "batch_fn")

    def setup(self) -> None:
        from cometbft_tpu_torch.types import validation

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
        self.vs = program.valset(self.pubs, h0.powers)
        self.commits = [program.commit(self.vs, h) for h in self.heights]
        self.bids = [c.block_id for c in self.commits]
        # the rows each call collects, by the reference's rule
        self.collect = [verdicts.light_collect(h.powers, h.present)
                        for h in self.heights]
        self.tamper_rng = fixtures.rng(self.seed, fixtures.TAMPER)
        self.tamper: Optional[tuple] = None
        self.last_msgs: dict = {}
        self.k = 0
        self.verify = validation.verify_commit_light
        self.errors = (validation.VerificationError,)
        inner = (self._control_fn() if self.control
                 else validation.device_batch_fn(self.device))
        self.batch_fn = self._wrap(inner)
        self.mark("program")
        # warm-up: every commit once, and a refused call
        warm = []
        for _ in range(2 * len(self.heights)):
            self.op(warm)
        self._restore()
        self.k = 0

    def _wrap(self, inner):
        spans = self.spans

        def fn(pubs, msgs, sigs):
            call = self.cur
            with spans("batch_fn"):
                t0 = time.perf_counter()
                valid = inner(pubs, msgs, sigs)
                call.batch_ms = (time.perf_counter() - t0) * 1e3
            v = np.asarray(valid)[:len(pubs)]
            call.n_rows = len(pubs)
            call.bad = np.flatnonzero(~v.astype(bool)).tolist()
            self.last_msgs[call.slot] = msgs
            return valid

        return fn

    def _control_fn(self):
        """The control: the reference put in the program's place, with
        one guarantee broken: it verifies one signature in 256, drawn from
        the seed, and takes the others as valid."""
        r = fixtures.rng(self.seed, fixtures.SAMPLE)

        def fn(pubs, msgs, sigs):
            picked = r.random(len(pubs)) < 1 / 256
            return np.asarray([ed25519.verify(p.data, m, s) if pick else True
                               for p, m, s, pick in zip(pubs, msgs, sigs,
                                                        picked)])

        return fn

    def _restore(self) -> None:
        if self.tamper is not None:
            slot, i = self.tamper[:2]
            self.commits[slot].signatures[i].signature = \
                self.heights[slot].sigs[i]
            self.tamper = None

    def _new_pass(self) -> None:
        self._restore()
        r = self.tamper_rng
        slot = int(r.integers(len(self.heights)))
        idxs = self.collect[slot][0]
        i = idxs[int(r.integers(len(idxs)))]
        byte, bit = int(r.integers(64)), int(r.integers(8))
        self.commits[slot].signatures[i].signature = fixtures.flip(
            self.heights[slot].sigs[i], byte, bit)
        self.tamper = (slot, i, byte, bit)

    def op(self, sink: list) -> None:
        pool = len(self.heights)
        if self.k % pool == 0:
            self._new_pass()
        slot = self.k % pool
        self.k += 1
        call = self.cur = Call(slot, self.tamper)
        h = self.heights[slot]
        with self.spans("validation.verify_commit_light"):
            call.t0 = time.perf_counter()
            try:
                self.verify(self.config["chain_id"], self.vs, self.bids[slot],
                            h.height, self.commits[slot], self.batch_fn)
            except self.errors as e:
                call.verdict = outcome(e)
            except Exception:  # noqa: BLE001 - a call with no verdict
                call.failed = 1
            call.t1 = time.perf_counter()
        call.items = 1 - call.failed
        sink.append(call)

    def rows(self, ops) -> dict:
        return {"ed25519_verify": sum(max(c.n_rows, 0) for c in ops)}

    def layer(self) -> dict:
        ops = [c for c in self.ops if not c.failed and c.n_rows >= 0]
        return {"batch_fn_ms": [c.batch_ms for c in ops],
                "collect_ms": [(c.t1 - c.t0) * 1e3 - c.batch_ms
                               for c in ops]}

    def check(self) -> List[tuple]:
        """Every call's verdict and each row's validity against the
        reference, and the sign-bytes the program built against the
        reference's."""
        invalid = [set() for _ in self.heights]
        for slot, h in enumerate(self.heights):
            idxs = self.collect[slot][0]
            for k in fixtures.sample(self.seed, len(idxs), self.p["ref_rows"],
                                     slot):
                i = idxs[k]
                if not ed25519.verify(self.pubs[i], h.msgs[i], h.sigs[i]):
                    invalid[slot].add(i)
        tampered = {}
        for c in self.ops + self.later:
            if c.tamper is not None and c.tamper not in tampered:
                slot, i, byte, bit = c.tamper
                h = self.heights[slot]
                tampered[c.tamper] = not ed25519.verify(
                    self.pubs[i], h.msgs[i],
                    fixtures.flip(h.sigs[i], byte, bit))
        wrong_verdicts = wrong_rows = 0
        for c in self.ops + self.later:
            if c.failed:
                continue
            bad = set(invalid[c.slot])
            if c.tamper is not None and c.tamper[0] == c.slot \
                    and tampered[c.tamper]:
                bad.add(c.tamper[1])
            idxs, tallied, needed = self.collect[c.slot]
            want = verdicts.light_verdict(idxs, tallied, needed, bad)
            wrong_verdicts += c.verdict != want
            if c.n_rows >= 0:
                got = {idxs[k] for k in c.bad} if c.n_rows == len(idxs) \
                    else None
                wrong_rows += got != bad & set(idxs)
        wrong_bytes = 0
        for slot, msgs in self.last_msgs.items():
            idxs = self.collect[slot][0]
            ref = self.heights[slot].msgs
            if len(msgs) != len(idxs):
                wrong_bytes += len(idxs)
                continue
            wrong_bytes += sum(m != ref[i] for m, i in zip(msgs, idxs))
        return [("verdicts_wrong", wrong_verdicts, 0),
                ("row_validity_wrong", wrong_rows, 0),
                ("sign_bytes_wrong", wrong_bytes, 0),
                ("calls_unanswered", self.totals()[1], 0)]
