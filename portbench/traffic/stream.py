"""Blocksync streaming: `StreamVerifier.verify` over runs of consecutive
heights, in a closed loop over a pool of signed heights.

The pool is `heights` signed commits of the configuration's set, split
into runs of `run` heights, one `verify(jobs)` call a run, as the
program's blocksync reactor hands its stream verifier a run. With
`valset` "shared" every height holds the same ValidatorSet object; with
"per_height" each height has its own set of the same keys, in which a
seeded `shift_share` of the validators' powers move by up to
`shift_max` (a fraction) from the height before. One seeded height of
each run misses quorum: its top validators by power are absent until the
rest hold no more than 2/3. Each pass over the runs first restores the
signatures the last pass flipped, then flips one seeded bit of one
seeded signature in one seeded commit of each run that reaches quorum,
among the signatures VerifyCommitLight would examine.

The verdict owed is CometBFT's VerifyCommitLight's (blocksync/reactor.go
verifies each block's commit with it). The stream verifier checks every
signature and VerifyCommitLight stops at 2/3 of the power; where the
tampering falls, both rules give the same verdict.

Other parameters: `ref_rows` (signatures of each height the reference
verifies itself, drawn from the seed), `profile_ops` (calls in the
profiled slice).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

from portbench import fixtures, program
from portbench.driver import Driver as _Driver
from portbench.driver import outcome
from portbench.reference import ed25519, verdicts


@dataclass
class Call:
    run: int
    tamper: Optional[tuple]      # (height index, position, byte, bit)
    t0: float = 0.0
    t1: float = 0.0
    refused: dict = field(default_factory=dict)   # position -> verdict
    host_ms: List[float] = field(default_factory=list)
    attempted: int = 0
    items: int = 0               # commits answered
    failed: int = 0


class Driver(_Driver):
    span_names = ("stream.verify",)

    def setup(self) -> None:
        from cometbft_tpu_torch.blocksync import pipeline

        cfg, p = self.config, self.p
        n = cfg["validators"]
        keys = fixtures.Keys(self.seed, n)
        key_powers = fixtures.powers(cfg, n)
        r = fixtures.rng(self.seed, fixtures.HEIGHTS)
        shift = fixtures.rng(self.seed, fixtures.POWERS)
        run = p["run"]
        n_heights = cfg["heights"]
        self.short = {k * run + int(r.integers(run))
                      for k in range(n_heights // run)}
        self.heights, sets = [], []
        for j in range(n_heights):
            if p["valset"] == "per_height" and j:
                key_powers = list(key_powers)
                moved = shift.choice(n, max(1, round(n * p["shift_share"])),
                                     replace=False)
                for k in moved:
                    f = 1 + p["shift_max"] * (2 * shift.random() - 1)
                    key_powers[k] = max(1, round(key_powers[k] * f))
            order = fixtures.set_order(keys, key_powers)
            set_powers = [key_powers[k] for k in order]
            absent = (fixtures.short_absent(set_powers) if j in self.short
                      else ())
            h = fixtures.signed_height(keys, key_powers, cfg["chain_id"],
                                       cfg["first_height"] + j, r,
                                       cfg["timestamp_spread_ns"], absent)
            self.heights.append(h)
            if p["valset"] == "shared" and sets:
                sets.append(sets[0])
            else:
                sets.append(program.valset([keys.pubs[k] for k in h.order],
                                           h.powers))
        self.mark("inputs")
        self.pubs = [[keys.pubs[k] for k in h.order] for h in self.heights]
        self.collect = [verdicts.light_collect(h.powers, h.present)
                        for h in self.heights]
        self.commits = [program.commit(vs, h)
                        for vs, h in zip(sets, self.heights)]
        jobs = [pipeline.CommitJob(vs, c.block_id, h.height, c,
                                   cfg["chain_id"])
                for vs, c, h in zip(sets, self.commits, self.heights)]
        self.runs = [jobs[k:k + run] for k in range(0, len(jobs), run)]
        self.sv = (Control(self) if self.control
                   else pipeline.make_stream_verifier(self.device))
        self.mark("program")
        self.tamper_rng = fixtures.rng(self.seed, fixtures.TAMPER)
        self.tampers: List[tuple] = []
        self.k = 0
        warm = []
        for _ in range(2 * len(self.runs)):
            self.op(warm)
        self._restore()
        self.k = 0

    def _restore(self) -> None:
        for j, i, _, _ in self.tampers:
            self.commits[j].signatures[i].signature = self.heights[j].sigs[i]
        self.tampers = []

    def _new_pass(self) -> None:
        self._restore()
        r, run = self.tamper_rng, self.p["run"]
        for k in range(len(self.runs)):
            full = [j for j in self._run_heights(k) if j not in self.short]
            j = full[int(r.integers(len(full)))]
            idxs = self.collect[j][0]
            i = idxs[int(r.integers(len(idxs)))]
            byte, bit = int(r.integers(64)), int(r.integers(8))
            self.commits[j].signatures[i].signature = fixtures.flip(
                self.heights[j].sigs[i], byte, bit)
            self.tampers.append((j, i, byte, bit))

    def op(self, sink: list) -> None:
        if self.k % len(self.runs) == 0:
            self._new_pass()
        k = self.k % len(self.runs)
        self.k += 1
        call = Call(k, self.tampers[k])
        jobs = self.runs[k]
        call.attempted = len(jobs)
        stats = getattr(self.sv, "stats", {"host_ms": []})
        seen = len(stats["host_ms"])
        with self.spans("stream.verify"):
            call.t0 = time.perf_counter()
            try:
                results = self.sv.verify(jobs)
                if len(results) != len(jobs):
                    raise RuntimeError("a verdict a job is owed")
                # only refusals are kept: a window's calls hold few objects
                call.refused = {k: outcome(e) for k, e in enumerate(results)
                                if e is not None}
            except Exception:  # noqa: BLE001 - a call with no verdicts
                call.failed = len(jobs)
            call.t1 = time.perf_counter()
        call.items = call.attempted - call.failed
        call.host_ms = stats["host_ms"][seen:]
        sink.append(call)

    def rows(self, ops) -> dict:
        live = sum(sum(self.heights[j].present)
                   for c in ops for j in self._run_heights(c.run))
        key = ("cached_verify" if self.p["valset"] == "shared"
               else "ed25519_verify")
        return {key: live}

    def _run_heights(self, k: int) -> range:
        run = self.p["run"]
        return range(k * run, (k + 1) * run)

    def layer(self) -> dict:
        return {"chunk_host_ms": [ms for c in self.ops for ms in c.host_ms]}

    def check(self) -> List[tuple]:
        """Every commit's verdict against the reference's."""
        invalid = [set() for _ in self.heights]
        for j, h in enumerate(self.heights):
            idxs = self.collect[j][0]
            for k in fixtures.sample(self.seed, len(idxs),
                                     self.p["ref_rows"], j):
                i = idxs[k]
                if not ed25519.verify(self.pubs[j][i], h.msgs[i], h.sigs[i]):
                    invalid[j].add(i)
        tampered = {}
        for c in self.ops + self.later:
            t = c.tamper
            if t not in tampered:
                j, i, byte, bit = t
                h = self.heights[j]
                tampered[t] = not ed25519.verify(
                    self.pubs[j][i], h.msgs[i],
                    fixtures.flip(h.sigs[i], byte, bit))
        wrong = 0
        for c in self.ops + self.later:
            if c.failed:
                continue
            for k, j in enumerate(self._run_heights(c.run)):
                got = c.refused.get(k)
                bad = set(invalid[j])
                if c.tamper[0] == j and tampered[c.tamper]:
                    bad.add(c.tamper[1])
                wrong += got != verdicts.light_verdict(*self.collect[j], bad)
        return [("verdicts_wrong", wrong, 0),
                ("commits_unanswered", self.totals()[1], 0)]


class Control:
    """The control: the reference put in the stream verifier's place,
    with one guarantee broken: it verifies one signature in 256 of each
    commit, drawn from the seed, and takes the others as valid."""

    def __init__(self, driver: Driver):
        self.d = driver
        self.r = fixtures.rng(driver.seed, fixtures.SAMPLE)
        self.index = {id(c): j for j, c in enumerate(driver.commits)}

    def verify(self, jobs):
        out = []
        for job in jobs:
            j = self.index[id(job.commit)]
            h = self.d.heights[j]
            bad = set()
            for i, cs in enumerate(job.commit.signatures):
                if h.present[i] and self.r.random() < 1 / 256 and \
                        not ed25519.verify(self.d.pubs[j][i], h.msgs[i],
                                           cs.signature):
                    bad.add(i)
            out.append(verdicts.light_verdict(*self.d.collect[j], bad))
        return out
