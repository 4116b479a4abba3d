"""`VerifyCommitLight` calls in a closed loop over a pool of signed commits
of a validator set that mixes ed25519 and sr25519 keys.

Each call is `types.validation.verify_commit_light` with the program's
`device_batch_fn()`, as in `commit_light`: the program groups a call's
rows by key type, one kernel call a group. The benchmark wraps the
batch_fn to time it and to keep what it was given and what it answered.
Calls go round the pool in passes; each pass first restores the
signature the last pass flipped, then flips one seeded bit of one seeded
signature among those the call collects, in one seeded commit, so that
commit has to be refused with that signature's index. The key type of
the tampered signature alternates pass by pass, so both groups are blamed
in every window.

The configuration's `key_types` gives how many keys of each type the set
holds: ed25519 keys sign with OpenSSL, as `fixtures.Keys` does, sr25519
keys with the reference's schnorrkel signer (`reference/sr25519.py`),
from separate seeded streams. The set's own order (power, then address)
interleaves them.

Where the program records its stages (`types/validation.py` and
`crypto/batch.py` `call_stats()`), each call keeps the records the
program appended while it ran, for the per-layer metrics; a program that
records none leaves those metrics out.

Traffic parameters: `pool` (commits), `ref_rows` (signatures of each key
type of each commit that the reference verifies itself, drawn from the
seed), `profile_ops` (calls in the profiled slice).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from portbench import fixtures, program
from portbench.driver import outcome
from portbench.reference import canonical, ed25519, sr25519, verdicts
from portbench.traffic import commit_light

KEY_TYPES = ("ed25519", "sr25519")
KERNELS = {"ed25519": "ed25519_verify", "sr25519": "sr25519_verify"}
SR_KEYS = 5            # the seed's stream of sr25519 mini-secrets
REFERENCE = {"ed25519": ed25519.verify, "sr25519": sr25519.verify}


class MixedKeys:
    """The configuration's keys: `pubs[k]` of type `types[k]`, signing
    with `sign(ks, msgs)` (key ks[i] signs msgs[i])."""

    def __init__(self, seed: int, counts: dict):
        n_ed, n_sr = counts["ed25519"], counts["sr25519"]
        self.ed = fixtures.Keys(seed, n_ed)
        raw = np.random.default_rng([seed & fixtures.MASK64,
                                     SR_KEYS]).bytes(32 * n_sr)
        self.sr = [sr25519.Key(raw[32 * i:32 * i + 32]) for i in range(n_sr)]
        self.pubs = self.ed.pubs + [k.pub for k in self.sr]
        self.types = ["ed25519"] * n_ed + ["sr25519"] * n_sr

    def sign(self, ks, msgs) -> List[bytes]:
        n_ed = len(self.ed.pubs)
        out = [self.ed.priv[k].sign(m) if k < n_ed else b""
               for k, m in zip(ks, msgs)]
        on_sr = [j for j, k in enumerate(ks) if k >= n_ed]
        for j, sig in zip(on_sr, sr25519.sign_batch(
                [self.sr[ks[j] - n_ed] for j in on_sr],
                [msgs[j] for j in on_sr])):
            out[j] = sig
        return out


def signed_height(keys: MixedKeys, key_powers, chain_id: str, height: int,
                  r: np.random.Generator, spread_ns: int
                  ) -> fixtures.Height:
    """A height whose validators all signed for one seeded block id, each
    at its own timestamp (`fixtures.signed_height` over mixed keys)."""
    order = verdicts.valset_order(keys.pubs, key_powers)
    n = len(order)
    bid = (r.bytes(32), int(r.integers(1, 100)), r.bytes(32))
    off = r.integers(0, spread_ns, n)
    secs = [fixtures.BASE_SECS + height + int(o) // 1_000_000_000
            for o in off]
    nanos = [int(o) % 1_000_000_000 for o in off]
    msgs = canonical.precommit_rows(chain_id, height, 0, bid, secs, nanos)
    return fixtures.Height(height, 0, bid, order,
                           [key_powers[k] for k in order], secs, nanos,
                           [True] * n, msgs, keys.sign(order, msgs))


def valset(pubs, types, powers):
    """The program's ValidatorSet of typed keys and powers given in set
    order; its own order has to be the same."""
    from cometbft_tpu_torch.crypto.keys import PubKey
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

    vs = ValidatorSet([Validator(PubKey(p, kt), int(w))
                       for p, kt, w in zip(pubs, types, powers)])
    if [(v.pub_key.data, v.pub_key.key_type) for v in vs.validators] \
            != list(zip(pubs, types)):
        raise program.SetupError(
            "the program orders the validator set otherwise")
    return vs


def _newest(ring, before) -> Optional[dict]:
    """The record a call appended to a program's ring, or None."""
    return ring[-1] if ring and ring[-1] is not before else None


@dataclass
class Call(commit_light.Call):
    vrec: Optional[dict] = None   # types/validation.py's record
    brec: Optional[dict] = None   # crypto/batch.py's record


class Driver(commit_light.Driver):
    span_names = ("validation.verify_commit_light", "batch_fn",
                  "validation.collect", "validation.sign_bytes",
                  "batch.group", "batch.challenges", "batch.pack",
                  "batch.dispatch", "batch.wait")

    def setup(self) -> None:
        from cometbft_tpu_torch.crypto import batch as cbatch
        from cometbft_tpu_torch.types import validation

        cfg, p = self.config, self.p
        if sum(cfg["key_types"].values()) != cfg["validators"]:
            raise ValueError("key_types do not add up to validators")
        keys = MixedKeys(self.seed, cfg["key_types"])
        key_powers = fixtures.powers(cfg, len(keys.pubs))
        r = fixtures.rng(self.seed, fixtures.HEIGHTS)
        self.heights = [
            signed_height(keys, key_powers, cfg["chain_id"],
                          cfg["first_height"] + j, r,
                          cfg["timestamp_spread_ns"])
            for j in range(p["pool"])]
        self.mark("inputs")
        h0 = self.heights[0]
        self.pubs = [keys.pubs[k] for k in h0.order]
        self.types = [keys.types[k] for k in h0.order]
        self.vs = valset(self.pubs, self.types, h0.powers)
        self.commits = [program.commit(self.vs, h)
                        for h in self.heights]
        self.bids = [c.block_id for c in self.commits]
        self.collect = [verdicts.light_collect(h.powers, h.present)
                        for h in self.heights]
        # the collected rows of each commit, by key type
        self.by_type = [{kt: [i for i in c[0] if self.types[i] == kt]
                         for kt in KEY_TYPES} for c in self.collect]
        self.tamper_rng = fixtures.rng(self.seed, fixtures.TAMPER)
        self.tamper: Optional[tuple] = None
        self.passes = 0
        self.last_msgs: dict = {}
        self.k = 0
        # the program's rings of stage records (None: it keeps none)
        self.vring = getattr(validation, "call_stats", lambda: None)()
        self.bring = getattr(cbatch, "call_stats", lambda: None)()
        self.verify = self._verify_recorded
        self._light = validation.verify_commit_light
        self.errors = (validation.VerificationError,)
        inner = (self._control_fn() if self.control
                 else validation.device_batch_fn(self.device))
        self.batch_fn = self._wrap(self._batch_recorded(inner))
        self.mark("program")
        # warm-up: every commit twice, a tampered row of each key type
        warm = []
        for _ in range(2 * len(self.heights)):
            self.op(warm)
        self._restore()
        self.k = 0

    def _verify_recorded(self, *args) -> None:
        before = self.vring[-1] if self.vring else None
        try:
            self._light(*args)
        finally:
            self.cur.vrec = _newest(self.vring, before)

    def _batch_recorded(self, inner):
        def fn(pubs, msgs, sigs):
            before = self.bring[-1] if self.bring else None
            try:
                return inner(pubs, msgs, sigs)
            finally:
                self.cur.brec = _newest(self.bring, before)

        return fn

    def _control_fn(self):
        """The control: the reference put in the program's place, with
        one guarantee broken: it verifies one signature in 256 of either
        key type, drawn from the seed, and takes the others as valid."""
        r = fixtures.rng(self.seed, fixtures.SAMPLE)

        def fn(pubs, msgs, sigs):
            picked = r.random(len(pubs)) < 1 / 256
            return np.asarray([REFERENCE[p.key_type](p.data, m, s)
                               if pick else True
                               for p, m, s, pick in zip(pubs, msgs, sigs,
                                                        picked)])

        return fn

    def _new_pass(self) -> None:
        self._restore()
        r = self.tamper_rng
        kt = KEY_TYPES[self.passes % len(KEY_TYPES)]
        self.passes += 1
        slot = int(r.integers(len(self.heights)))
        idxs = self.by_type[slot][kt]
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
                self.verify(self.config["chain_id"], self.vs,
                            self.bids[slot], h.height, self.commits[slot],
                            self.batch_fn)
            except self.errors as e:
                call.verdict = outcome(e)
            except Exception:  # noqa: BLE001 - a call with no verdict
                call.failed = 1
            call.t1 = time.perf_counter()
        call.items = 1 - call.failed
        sink.append(call)

    def rows(self, ops) -> dict:
        out = dict.fromkeys(KERNELS.values(), 0)
        for c in ops:
            if c.n_rows == len(self.collect[c.slot][0]):
                for kt, kernel in KERNELS.items():
                    out[kernel] += len(self.by_type[c.slot][kt])
        return out

    def layer(self) -> dict:
        """The program's readings of the window's answered calls: the
        collection loop, and each key type's group and the sr25519
        group's challenges."""
        ops = [c for c in self.ops if not c.failed]
        out = {"collect_ms": [c.vrec["collect"] for c in ops if c.vrec]}
        for kt in KEY_TYPES:
            out[f"{kt}_group_ms"] = [self._group(c, kt, "ms") for c in ops
                                     if c.brec]
        out["sr25519_challenges_ms"] = [
            self._group(c, "sr25519", "challenges") for c in ops if c.brec]
        return out

    @staticmethod
    def _group(c: Call, kt: str, reading: str) -> float:
        return sum(g[reading] for g in c.brec["groups"]
                   if g["key_type"] == kt)

    def check(self) -> List[tuple]:
        """Every call's verdict and each row's validity against the
        reference of the row's key type, and the sign-bytes the program
        built against the reference's."""
        def ref(slot, i, sig):
            return REFERENCE[self.types[i]](self.pubs[i],
                                            self.heights[slot].msgs[i], sig)

        invalid = [set() for _ in self.heights]
        for slot, h in enumerate(self.heights):
            for t, kt in enumerate(KEY_TYPES):
                idxs = self.by_type[slot][kt]
                for k in fixtures.sample(self.seed, len(idxs),
                                         self.p["ref_rows"],
                                         len(KEY_TYPES) * slot + t):
                    if not ref(slot, idxs[k], h.sigs[idxs[k]]):
                        invalid[slot].add(idxs[k])
        tampered = {}
        for c in self.ops + self.later:
            if c.tamper is not None and c.tamper not in tampered:
                slot, i, byte, bit = c.tamper
                tampered[c.tamper] = not ref(
                    slot, i, fixtures.flip(self.heights[slot].sigs[i],
                                           byte, bit))
        wrong_verdicts = wrong_rows = 0
        for c in self.ops + self.later:
            if c.failed:
                continue
            bad = set(invalid[c.slot])
            if c.tamper is not None and c.tamper[0] == c.slot \
                    and tampered[c.tamper]:
                bad.add(c.tamper[1])
            idxs, tallied, needed = self.collect[c.slot]
            wrong_verdicts += c.verdict != verdicts.light_verdict(
                idxs, tallied, needed, bad)
            if c.n_rows >= 0:
                got = {idxs[k] for k in c.bad} if c.n_rows == len(idxs) \
                    else None
                wrong_rows += got != bad & set(idxs)
        wrong_bytes = 0
        for slot, msgs in self.last_msgs.items():
            idxs = self.collect[slot][0]
            if len(msgs) != len(idxs):
                wrong_bytes += len(idxs)
                continue
            ref_msgs = self.heights[slot].msgs
            wrong_bytes += sum(m != ref_msgs[i] for m, i in zip(msgs, idxs))
        return [("verdicts_wrong", wrong_verdicts, 0),
                ("row_validity_wrong", wrong_rows, 0),
                ("sign_bytes_wrong", wrong_bytes, 0),
                ("calls_unanswered", self.totals()[1], 0)]
