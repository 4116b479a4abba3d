"""The port's light client (cometbft_tpu_torch/light/) and the types under
it (types/block.py, part_set.py, serde.py, evidence.py, state/state.py's
valset serde) against the JAX package's.

The scenarios of tests/test_light.py:90-286 and :409 run on both packages
over the same chain, built from the same key seeds by a LightChain helper
instantiated for each package: the heights verified, `verifications`,
`store.heights()`, the error classes, the attack evidence's bytes and hash
and the sqlite store's round trip must be equal. Then the block types:
`Header.hash`, `Block.hash`, PartSet roots and proofs and serde JSON equal
the JAX package's on seeded blocks. Then the card path's plan
(chip_smoke.light_plan, phase 13) at 16 secp256k1 validators: the
skipping client bisects 1 -> 8 across the era change with the same
heights and verification count on both packages (oracle batch_fn), and on
the port with its commits routed through a running verify plane
(batch_fn=None, as phase 13 runs it on the card). The proxy and gateway
scenarios (:316-371, :467) wait for their modules."""
import copy
import importlib.util
import json
import random
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.light import client as jlc
from cometbft_tpu.light import store as jls
from cometbft_tpu.light import verifier as jlv
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import evidence as jev
from cometbft_tpu.types import part_set as jps
from cometbft_tpu.types import serde as jserde
from cometbft_tpu.types import validation as jvalidation
from cometbft_tpu.types import validator as jval
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.timestamp import Timestamp as JTimestamp
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.light import client as plc
from cometbft_tpu_torch.light import store as pls
from cometbft_tpu_torch.light import verifier as plv
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import canonical as pcanon
from cometbft_tpu_torch.types import commit as pcommit
from cometbft_tpu_torch.types import evidence as pev
from cometbft_tpu_torch.types import part_set as pps
from cometbft_tpu_torch.types import serde as pserde
from cometbft_tpu_torch.types import validation as pvalidation
from cometbft_tpu_torch.types import validator as pval
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.verifyplane import plane as pvp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CHAIN_ID = "light-chain"
T0 = 1_700_000_000

JAX = SimpleNamespace(
    name="jax", keys=jkeys, lc=jlc, lv=jlv, ls=jls, block=jblock,
    canon=jcanon, commit=jcommit, ev=jev, ps=jps, serde=jserde,
    validation=jvalidation, val=jval, BlockID=JBlockID, PSH=JPSH,
    Timestamp=JTimestamp, Vote=JVote)
PORT = SimpleNamespace(
    name="port", keys=pkeys, lc=plc, lv=plv, ls=pls, block=pblock,
    canon=pcanon, commit=pcommit, ev=pev, ps=pps, serde=pserde,
    validation=pvalidation, val=pval, BlockID=BlockID, PSH=PartSetHeader,
    Timestamp=Timestamp, Vote=Vote)


def keys_for(P, tag, n):
    return [P.keys.PrivKey.generate(bytes([tag, i + 1]) + b"\x07" * 30)
            for i in range(n)]


class LightChain:
    """tests/test_light.py's chain builder for package P: plan[h] is the
    list of (private key, power) whose set signs height h; headers carry
    the validators / next-validators hashes, so adjacent links and
    bisection behave as on a real chain. `t0` is height 0's time; a
    commit is signed the first time its height is fetched."""

    def __init__(self, P, plan, chain_id=CHAIN_ID, t0=T0):
        self.P = P
        self.chain_id = chain_id
        self.plan = {h: [(k, 10) if not isinstance(k, tuple) else k
                         for k in keys] for h, keys in plan.items()}
        self.max_height = max(plan)
        self.blocks = {}
        self.signed = []
        prev_bid = P.BlockID()
        for h in range(1, self.max_height + 1):
            vs = self._valset(h)
            nvs = self._valset(h + 1 if h + 1 in self.plan else h)
            header = P.block.Header(
                chain_id=chain_id, height=h, time=P.Timestamp(t0 + h, 0),
                last_block_id=prev_bid, validators_hash=vs.hash(),
                next_validators_hash=nvs.hash(),
                proposer_address=vs.validators[0].address,
                app_hash=b"\x01" * 32)
            bid = P.BlockID(header.hash(), P.PSH(1, header.hash()))
            self.blocks[h] = (header, bid, vs)
            prev_bid = bid

    def _valset(self, h):
        return self.P.val.ValidatorSet([
            self.P.val.Validator(k.pub_key(), w) for k, w in self.plan[h]])

    def sign(self, h, header, bid, vs):
        P = self.P
        by_addr = {k.pub_key().address(): k for k, _ in self.plan[h]}
        sigs = []
        for v in vs.validators:
            ts = P.Timestamp(header.time.seconds, 42)
            sb = P.canon.canonical_vote_bytes(
                self.chain_id, P.canon.PRECOMMIT_TYPE, h, 0, bid, ts)
            sigs.append(P.commit.CommitSig(
                P.commit.BLOCK_ID_FLAG_COMMIT, v.address, ts,
                by_addr[v.address].sign(sb)))
        self.signed.append(h)
        return P.lv.LightBlock(
            P.lv.SignedHeader(header, P.commit.Commit(h, 0, bid, sigs)), vs)

    def block(self, h):
        ent = self.blocks.get(h)
        if ent is None:
            return None
        if isinstance(ent, tuple):
            ent = self.blocks[h] = self.sign(h, *ent)
        return ent

    def provider(self):
        return self.P.lc.Provider(self.chain_id, self.block)


NOW_S = T0 + 1000


def make_client(P, chain, **kw):
    kw.setdefault("trusting_period", 1e6)
    kw.setdefault("batch_fn", P.validation.oracle_batch_fn())
    c = P.lc.Client(chain.chain_id, chain.provider(), **kw)
    c.trust_light_block(chain.block(1))
    return c


def _outcome(fn):
    try:
        return ("ret", fn())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raise", type(e).__name__)


def _lb(lb):
    return (lb.height, lb.signed_header.header.hash(),
            lb.validator_set.hash())


# -- the scenarios of tests/test_light.py -----------------------------------


def _skipping_one_jump_stable_valset(P, tmp):
    # test_light.py:90
    keys = keys_for(P, 1, 4)
    chain = LightChain(P, {h: keys for h in range(1, 21)})
    c = make_client(P, chain)
    lb = c.verify_light_block_at_height(20, now=P.Timestamp(NOW_S, 0))
    return (_lb(lb), c.verifications, c.store.heights())


def _sequential_walks_every_height(P, tmp):
    # test_light.py:101
    keys = keys_for(P, 1, 4)
    chain = LightChain(P, {h: keys for h in range(1, 11)})
    c = make_client(P, chain, skipping=False)
    c.verify_light_block_at_height(10, now=P.Timestamp(NOW_S, 0))
    return (c.verifications, c.store.heights())


def _bisection_across_full_valset_rotation(P, tmp):
    # test_light.py:110
    a, b = keys_for(P, 1, 4), keys_for(P, 2, 4)
    chain = LightChain(P, {h: (a if h <= 10 else b) for h in range(1, 21)})
    c = make_client(P, chain)
    lb = c.verify_light_block_at_height(20, now=P.Timestamp(NOW_S, 0))
    return (_lb(lb), c.verifications, c.store.heights(), chain.signed)


def _gradual_churn_skips_far(P, tmp):
    # test_light.py:125
    base = keys_for(P, 3, 8)
    plan, cur = {}, list(base)
    for h in range(1, 31):
        if h % 3 == 0:
            cur = cur[1:] + [keys_for(P, 10 + h, 1)[0]]
        plan[h] = list(cur)
    chain = LightChain(P, plan)
    c = make_client(P, chain)
    c.verify_light_block_at_height(30, now=P.Timestamp(NOW_S, 0))
    return (c.verifications, c.store.heights())


def _expired_trusted_header_rejected(P, tmp):
    # test_light.py:141
    keys = keys_for(P, 1, 4)
    chain = LightChain(P, {h: keys for h in range(1, 6)})
    c = make_client(P, chain, trusting_period=10.0)
    return _outcome(lambda: c.verify_light_block_at_height(
        5, now=P.Timestamp(T0 + 1000, 0)))


def _witness_divergence_detected(P, tmp):
    # test_light.py:149
    keys = keys_for(P, 1, 4)
    chain = LightChain(P, {h: keys for h in range(1, 6)})
    forged = LightChain(P, {h: keys_for(P, 9, 4) for h in range(1, 6)})
    c = P.lc.Client(CHAIN_ID, chain.provider(),
                    witnesses=[forged.provider()], trusting_period=1e6,
                    batch_fn=P.validation.oracle_batch_fn())
    c.trust_light_block(chain.block(1))
    out = _outcome(lambda: c.verify_light_block_at_height(
        5, now=P.Timestamp(NOW_S, 0)))
    return (out, c.verifications, c.store.heights())


def _tampered_target_rejected(P, tmp):
    # test_light.py:163
    keys = keys_for(P, 1, 4)
    chain = LightChain(P, {h: keys for h in range(1, 6)})
    lb = chain.block(5)
    bad_sigs = [P.commit.CommitSig(cs.flag, cs.validator_address,
                                   cs.timestamp, bytes(64))
                for cs in lb.signed_header.commit.signatures]
    chain.blocks[5] = P.lv.LightBlock(P.lv.SignedHeader(
        lb.signed_header.header,
        P.commit.Commit(5, 0, lb.signed_header.commit.block_id, bad_sigs)),
        lb.validator_set)
    c = make_client(P, chain)
    out = _outcome(lambda: c.verify_light_block_at_height(
        5, now=P.Timestamp(NOW_S, 0)))
    return (out, c.verifications, c.store.heights())


def _backwards_verification(P, tmp):
    # test_light.py:184
    keys = keys_for(P, 7, 4)
    chain = LightChain(P, {h: keys for h in range(1, 9)})
    c = P.lc.Client(CHAIN_ID, chain.provider(), trusting_period=1e6,
                    batch_fn=P.validation.oracle_batch_fn())
    c.trust_light_block(chain.block(6))
    lb = c.verify_light_block_at_height(2, now=P.Timestamp(NOW_S, 0))
    chain2 = LightChain(P, {h: keys for h in range(1, 9)})
    bad = copy.deepcopy(chain2.block(3))
    bad.signed_header.header.app_hash = b"\x99" * 32
    chain2.blocks[3] = bad
    c2 = P.lc.Client(CHAIN_ID, chain2.provider(), trusting_period=1e6,
                     batch_fn=P.validation.oracle_batch_fn())
    c2.trust_light_block(chain2.block(6))
    out = _outcome(lambda: c2.verify_light_block_at_height(
        2, now=P.Timestamp(NOW_S, 0)))
    return (_lb(lb), c.verifications, c.store.heights(), out,
            c2.store.heights())


def _divergence_produces_attack_evidence(P, tmp):
    # test_light.py:210
    keys = keys_for(P, 9, 4)
    chain = LightChain(P, {h: keys for h in range(1, 6)})
    fork = LightChain(P, {h: keys for h in range(1, 6)})
    hdr = fork.blocks[4][0]
    hdr.app_hash = b"\x66" * 32
    bid = P.BlockID(hdr.hash(), P.PSH(1, hdr.hash()))
    fork.blocks[4] = (hdr, bid, fork.blocks[4][2])
    collected = []
    c = make_client(P, chain)
    c.witnesses = [fork.provider()]
    c.on_attack_evidence = collected.append
    try:
        c.verify_light_block_at_height(4, now=P.Timestamp(NOW_S, 0))
        return ("no divergence",)
    except P.lc.DivergenceError as e:
        ev = e.evidence
    ev.validate_basic()
    back = P.ev.evidence_from_j(P.ev.evidence_to_j(ev))
    return (ev.bytes(), ev.hash(), ev.conflicting_height,
            len(ev.byzantine_validators), collected[0] is ev,
            back.hash() == ev.hash(), c.store.heights())


def _persistent_store_roundtrip(P, tmp):
    # test_light.py:255
    keys = keys_for(P, 9, 4)
    chain = LightChain(P, {h: keys for h in range(1, 8)})
    path = str(tmp / f"{P.name}-light.db")
    st = P.ls.DBStore(path)
    for h in (1, 3, 5, 7):
        st.save(chain.block(h))
    first = (st.size(), st.first_height(), st.latest().height)
    st.close()
    st2 = P.ls.DBStore(path)
    heights = st2.heights()
    lb = st2.get(3)
    lb.validate_basic(CHAIN_ID)
    rows = st2._db.execute(
        "SELECT height, data FROM light_blocks ORDER BY height").fetchall()
    st2.prune(2)
    pruned = st2.heights()
    st2.delete(5)
    after = (st2.heights(), st2.lowest_at_or_above(6).height)
    st2.close()
    return (first, heights, _lb(lb), rows, pruned, after)


def _client_resumes_from_persisted_trust(P, tmp):
    # test_light.py:286
    keys = keys_for(P, 11, 4)
    chain = LightChain(P, {h: keys for h in range(1, 31)})
    path = str(tmp / f"{P.name}-resume.db")
    c1 = P.lc.Client(CHAIN_ID, chain.provider(), trusting_period=1e6,
                     batch_fn=P.validation.oracle_batch_fn(),
                     store=P.ls.DBStore(path))
    c1.trust_light_block(chain.block(1))
    c1.verify_light_block_at_height(15, now=P.Timestamp(NOW_S, 0))
    c1.store.close()
    c2 = P.lc.Client(CHAIN_ID, chain.provider(), trusting_period=1e6,
                     batch_fn=P.validation.oracle_batch_fn(),
                     store=P.ls.DBStore(path))
    latest = c2.store.latest().height
    lb = c2.verify_light_block_at_height(30, now=P.Timestamp(NOW_S, 0))
    c2.store.close()
    st = P.ls.DBStore(path)
    out = (latest, _lb(lb), c1.verifications, c2.verifications,
           st.heights())
    st.close()
    return out


def _client_concurrent_access_hammer(P, tmp):
    # test_light.py:409: the store a race leaves differs between runs,
    # so the invariants are compared
    keys = keys_for(P, 31, 3)
    chain = LightChain(P, {h: keys for h in range(1, 25)})
    c = make_client(P, chain)
    now = P.Timestamp(NOW_S, 0)
    targets = [6, 12, 18, 24]
    errs = []
    K = 8
    barrier = threading.Barrier(K + 1)

    def worker(seed):
        rng = random.Random(seed)
        try:
            barrier.wait(30.0)
            for t in rng.sample(targets, len(targets)):
                lb = c.verify_light_block_at_height(t, now=now)
                assert lb.signed_header.header.hash() == \
                    chain.block(t).signed_header.header.hash()
        except Exception as e:  # noqa: BLE001 - compared below
            errs.append(repr(e))

    def pruner():
        barrier.wait(30.0)
        for _ in range(20):
            c.prune_expired(now=now)

    threads = [threading.Thread(target=worker, args=(1000 + k,))
               for k in range(K)] + [threading.Thread(target=pruner)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
        assert not t.is_alive()
    honest = all(c.store.get(h).signed_header.header.hash()
                 == chain.block(h).signed_header.header.hash()
                 for h in c.store.heights())
    return (errs, honest, set(targets) <= set(c.store.heights()),
            c.verifications >= len([h for h in c.store.heights()
                                    if h > 1]),
            c.store.lowest_at_or_above(7).height in c.store.heights())


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _skipping_one_jump_stable_valset, _sequential_walks_every_height,
    _bisection_across_full_valset_rotation, _gradual_churn_skips_far,
    _expired_trusted_header_rejected, _witness_divergence_detected,
    _tampered_target_rejected, _backwards_verification,
    _divergence_produces_attack_evidence, _persistent_store_roundtrip,
    _client_resumes_from_persisted_trust,
    _client_concurrent_access_hammer)}

# what tests/test_light.py asserts of each scenario, on the JAX outcome
EXPECT = {
    "skipping_one_jump_stable_valset": lambda o: o[0][0] == 20
    and o[1] == 1,
    "sequential_walks_every_height": lambda o: o == (9, list(range(1, 11))),
    "bisection_across_full_valset_rotation": lambda o: 11 in o[2]
    and o[1] > 2,
    "gradual_churn_skips_far": lambda o: o[0] < 29,
    "expired_trusted_header_rejected": lambda o: o == (
        "raise", "ErrOldHeaderExpired"),
    "witness_divergence_detected": lambda o: o[0] == (
        "raise", "DivergenceError"),
    "tampered_target_rejected": lambda o: o[0] == (
        "raise", "ErrInvalidHeader"),
    # the tampered header fails validate_basic: an ErrInvalidHeader, the
    # LightClientError subclass
    "backwards_verification": lambda o: o[0][0] == 2 and o[3] == (
        "raise", "ErrInvalidHeader"),
    "divergence_produces_attack_evidence": lambda o: o[2] == 4
    and o[3] == 4 and o[4] and o[5],
    "persistent_store_roundtrip": lambda o: o[1] == [1, 3, 5, 7]
    and o[4] == [5, 7] and o[5][0] == [7],
    "client_resumes_from_persisted_trust": lambda o: o[0] == 15
    and o[1][0] == 30 and o[4][-1] == 30,
    "client_concurrent_access_hammer": lambda o: o == (
        [], True, True, True, True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_light_scenario_matches_the_jax_client(name, tmp_path):
    want = SCENARIOS[name](JAX, tmp_path)
    got = SCENARIOS[name](PORT, tmp_path)
    assert EXPECT[name](want), want
    assert got == want


# -- the block types ---------------------------------------------------------


def _seeded_block(P, seed):
    """A block with every header field, txs, a last commit and a
    duplicate-vote evidence, from seeded bytes."""
    rng = np.random.default_rng(seed)
    b = lambda n: rng.bytes(n)  # noqa: E731
    bid = P.BlockID(b(32), P.PSH(int(rng.integers(1, 9)), b(32)))
    ts = P.Timestamp(T0 + int(rng.integers(0, 2**20)),
                     int(rng.integers(0, 10**9)))
    header = P.block.Header(
        chain_id="seeded-%d" % seed, height=int(rng.integers(2, 10**6)),
        time=ts, last_block_id=bid, validators_hash=b(32),
        next_validators_hash=b(32), consensus_hash=b(32), app_hash=b(32),
        last_results_hash=b(32), proposer_address=b(20),
        version_app=int(rng.integers(0, 5)))
    sigs = [P.commit.CommitSig(P.commit.BLOCK_ID_FLAG_COMMIT, b(20),
                               ts, b(64)) for _ in range(5)]
    sigs.append(P.commit.CommitSig.absent())
    last = P.commit.Commit(header.height - 1, 0, bid, sigs)
    votes = [P.Vote(vote_type=P.canon.PRECOMMIT_TYPE,
                    height=header.height - 1, round=0,
                    block_id=P.BlockID(b(32), P.PSH(1, b(32))),
                    timestamp=ts, validator_address=b"\x05" * 20,
                    validator_index=3, signature=b(64)) for _ in range(2)]
    ev = P.ev.DuplicateVoteEvidence.from_votes(votes[0], votes[1], ts,
                                               1000, 10)
    txs = [b(int(rng.integers(1, 700))) for _ in range(int(
        rng.integers(1, 40)))]
    block = P.block.Block(header, P.block.Data(txs), last, [ev])
    block.fill_header()
    return block


@pytest.mark.parametrize("seed", [3, 17, 41])
def test_block_hashes_parts_and_serde_match_the_jax_package(seed):
    out = {}
    for P in (JAX, PORT):
        block = _seeded_block(P, seed)
        block.validate_basic()
        js = P.serde.block_to_json(block)
        ps = block.make_part_set(part_size=512)
        parts = [ps.get_part(i) for i in range(ps.total())]
        back = P.serde.block_from_json(js)
        rebuilt = P.ps.PartSet.from_header(ps.header())
        for part in parts:
            assert rebuilt.add_part(P.ps.Part.from_j(part.to_j()))
        ext = P.commit.ExtendedCommit(
            block.last_commit.height, 0, block.last_commit.block_id,
            [P.commit.ExtendedCommitSig(cs, b"x%d" % i, b"y%d" % i)
             for i, cs in enumerate(block.last_commit.signatures)])
        out[P.name] = dict(
            header=block.header.hash(), block=block.hash(),
            proto=block.header.to_proto_bytes(), json=js,
            evidence=[e.hash() for e in block.evidence],
            parts=(ps.header().total, ps.header().hash,
                   [(p.index, p.data, p.proof.aunts, p.proof.leaf_hash)
                    for p in parts]),
            back=(back.hash(), P.serde.block_to_json(back) == js),
            assembled=rebuilt.assemble() == js.encode(),
            block_id=P.serde.bid_to_j(block.block_id()),
            ext=json.dumps(P.serde.extcommit_to_j(ext)),
            ext_back=P.serde.extcommit_from_j(
                P.serde.extcommit_to_j(ext)) == ext)
    assert out["port"] == out["jax"]
    assert out["jax"]["back"][1] and out["jax"]["assembled"]
    assert out["jax"]["ext_back"]


def test_valset_serde_matches_the_jax_state_module():
    from cometbft_tpu.state import state as jstate
    from cometbft_tpu_torch.state import state as pstate

    got = {}
    for P, st in ((JAX, jstate), (PORT, pstate)):
        vs = P.val.ValidatorSet([P.val.Validator(k.pub_key(), 5 + i)
                                 for i, k in enumerate(keys_for(P, 5, 6))])
        vs.increment_proposer_priority(3)
        j = st._valset_to_j(vs)
        back = st._valset_from_j(json.loads(json.dumps(j)))
        got[P.name] = (json.dumps(j), back.hash(),
                       back.proposer.address, st._valset_from_j(None))
    assert got["port"] == got["jax"]


# -- phase 13's plan at 16 secp256k1 validators -----------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
# what phase 13 asserts of its 10k run: the heights the skipping client
# stores and the verifications it counts on the way 1 -> 8
LIGHT_PLAN_HEIGHTS = [1, 4, 5, 6, 8]
LIGHT_PLAN_VERIFICATIONS = 7


def _plan_chain(P, n):
    plan = CS.light_plan(n)
    return LightChain(P, {
        h: [(P.keys.Secp256k1PrivKey.generate(s), w) for s, w in vals]
        for h, vals in plan.items()}, chain_id=CS.CHAIN_ID, t0=CS.LCC_T0)


def _plan_run(P, batch_fn):
    chain = _plan_chain(P, CS.LCC_COPY_VALS)
    c = P.lc.Client(CS.CHAIN_ID, chain.provider(), trusting_period=1e6,
                    batch_fn=batch_fn)
    c.trust_light_block(chain.block(1))
    lb = c.verify_light_block_at_height(
        8, now=P.Timestamp(CS.LCC_T0 + 1000, 0))
    return (lb.height, c.store.heights(), c.verifications,
            sorted(set(chain.signed)))


def test_the_card_plan_bisects_alike_on_both_packages():
    """The secp256k1 signatures differ between the packages' signers (the
    JAX one may use OpenSSL's random nonce), so the outcomes are
    compared, not the commits."""
    want = _plan_run(JAX, jvalidation.oracle_batch_fn())
    got = _plan_run(PORT, pvalidation.oracle_batch_fn())
    assert got == want
    assert want[1] == LIGHT_PLAN_HEIGHTS
    assert want[2] == LIGHT_PLAN_VERIFICATIONS
    assert want[3] == [1, 4, 5, 6, 8]  # only the visited heights signed


def test_the_card_plan_through_a_running_port_plane():
    """batch_fn=None: the client's commits go through the running global
    plane (its host path here; phase 13 runs a card plane, whose grouped
    path takes the secp256k1 rows to the ECDSA kernel)."""
    plane = pvp.VerifyPlane(window_ms=0.5, use_device=False)
    plane.start()
    pvp.set_global_plane(plane)
    try:
        got = _plan_run(PORT, None)
    finally:
        pvp.set_global_plane(None)
        plane.stop()
    assert got[1:3] == (LIGHT_PLAN_HEIGHTS, LIGHT_PLAN_VERIFICATIONS)
    recs = plane.ledger.records()
    # 1->4 and 6->8 two commit checks each, 4->5 and 5->6 one each; the
    # failing trust checks stop before any signature is verified
    assert len(recs) == 6 and {r["path"] for r in recs} == {"host"}
    assert plane.rows_verified == sum(r["rows"] for r in recs) > 0


def test_an_ed25519_client_through_a_device_plane_on_the_plain_kernels():
    """batch_fn=None on a device="cpu" plane: the commits' rows take the
    plane's grouped path to the ed25519 kernel's plain version, and the
    outcome equals the oracle client's."""
    keys = keys_for(PORT, 1, 4)
    want = _skipping_one_jump_stable_valset(PORT, None)
    plane = pvp.VerifyPlane(window_ms=0.5, device="cpu")
    plane.start()
    pvp.set_global_plane(plane)
    try:
        chain = LightChain(PORT, {h: keys for h in range(1, 21)})
        c = make_client(PORT, chain, batch_fn=None)
        lb = c.verify_light_block_at_height(20, now=Timestamp(NOW_S, 0))
        got = (_lb(lb), c.verifications, c.store.heights())
    finally:
        pvp.set_global_plane(None)
        plane.stop()
    assert got == want
    recs = plane.ledger.records()
    assert [r["path"] for r in recs] == ["grouped", "grouped"]
    assert plane.rows_verified == sum(r["rows"] for r in recs) > 0
