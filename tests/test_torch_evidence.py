"""The port's evidence verification and pool (cometbft_tpu_torch/evidence/)
against the JAX package's.

tests/test_evidence.py:59-181 (five scenarios: the duplicate-vote pool's
lifecycle, the light-client-attack pool's lifecycle, its forgeries, its
attack-level dedup and its serde round trip) run on both packages over the
same keys, votes and forged attacks, built per package from the same seeds
(ed25519 signs deterministically). The JAX pool verifies on the host
(batch_fn=None); the port's pool with the oracle batch_fn, and with
batch_fn=None under a running host plane and a device="cpu" plane. Every
operation's outcome (return value, or the error's class and message),
evidence bytes and hashes and pool sizes must be equal. Then the port's
seams: the named byzantine rows verify as one batch_fn call whose first
forged row is blamed with the JAX text and order, batch_fn=None with no
plane is the card (DeviceError here), and a device plane that cannot take
the rows verifies them on its own device. The light-client attacks are
each package's simnet actor (simnet/actors.py), and the port's actors
(the attacker, the forged claim, the equivocator, the garbage signer and
the election) are held byte-equal to the JAX package's."""
import hashlib
import json
import random
from types import SimpleNamespace

import pytest
import torch

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.evidence import pool as jpool
from cometbft_tpu.evidence import verify as jverify
from cometbft_tpu.simnet import actors as jactors
from cometbft_tpu.types import block_id as jbid
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import evidence as jev
from cometbft_tpu.types import serde as jserde
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validation as jvalidation
from cometbft_tpu.types import validator as jval
from cometbft_tpu.types import vote as jvote
from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.device import DeviceError
from cometbft_tpu_torch.evidence import pool as ppool
from cometbft_tpu_torch.evidence import verify as pverify
from cometbft_tpu_torch.simnet import actors as pactors
from cometbft_tpu_torch.types import block_id as pbid
from cometbft_tpu_torch.types import canonical as pcanon
from cometbft_tpu_torch.types import commit as pcommit
from cometbft_tpu_torch.types import evidence as pev
from cometbft_tpu_torch.types import serde as pserde
from cometbft_tpu_torch.types import timestamp as pts
from cometbft_tpu_torch.types import validation as pvalidation
from cometbft_tpu_torch.types import validator as pval
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.verifyplane import plane as pvp

torch.set_num_threads(1)

JAX = SimpleNamespace(name="jax", keys=jkeys, pool=jpool, verify=jverify,
                      bid=jbid, canon=jcanon, commit=jcommit, ev=jev,
                      ts=jts, validation=jvalidation, val=jval, vote=jvote,
                      actors=jactors, serde=jserde)
PORT = SimpleNamespace(name="port", keys=pkeys, pool=ppool, verify=pverify,
                       bid=pbid, canon=pcanon, commit=pcommit, ev=pev,
                       ts=pts, validation=pvalidation, val=pval, vote=pvote,
                       actors=pactors, serde=pserde)

CHAIN = "ev-chain"


def keys_and_vals(P, n=4):
    privs = [P.keys.PrivKey.generate(bytes([i + 1]) * 32) for i in range(n)]
    vals = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10)
                               for p in privs])
    return privs, vals


def _mk_vote(P, priv, vals, height, round_, bid):
    addr = priv.pub_key().address()
    idx, _ = vals.get_by_address(addr)
    v = P.vote.Vote(
        vote_type=P.canon.PREVOTE_TYPE, height=height, round=round_,
        block_id=bid, timestamp=P.ts.Timestamp(1_700_000_100, 0),
        validator_address=addr, validator_index=idx)
    v.signature = priv.sign(v.sign_bytes(CHAIN))
    return v


def mk_evidence(P, priv, vals, height, power=10):
    bid_a = P.bid.BlockID(b"\xaa" * 32, P.bid.PartSetHeader(1, b"\xaa" * 32))
    bid_b = P.bid.BlockID(b"\xbb" * 32, P.bid.PartSetHeader(1, b"\xbb" * 32))
    va = _mk_vote(P, priv, vals, height, 0, bid_a)
    vb = _mk_vote(P, priv, vals, height, 0, bid_b)
    return P.ev.DuplicateVoteEvidence.from_votes(
        va, vb, P.ts.Timestamp(1_700_000_000, 0),
        vals.total_voting_power(), power)


def mk_lca(P, privs, vals, byz_idxs, height):
    """Each package's simnet light-client attacker: a forged header at
    `height` sealed by the byzantine coalition, packaged as
    LightClientAttackEvidence with its commit proof."""
    return P.actors.build_light_attack(privs, vals, CHAIN, byz_idxs, height,
                                       P.ts.Timestamp(1_700_000_100, 0))


def test_the_attack_builder_equals_the_simnet_actor():
    test_more_light_attacks_equal_the_jax_actor([1, 2], 5)


@pytest.mark.parametrize("byz,height", [([0, 3], 1), ([2], 9)])
def test_more_light_attacks_equal_the_jax_actor(byz, height):
    jprivs, jvals = keys_and_vals(JAX)
    want = mk_lca(JAX, jprivs, jvals, byz, height)
    pprivs, pvals = keys_and_vals(PORT)
    got = mk_lca(PORT, pprivs, pvals, byz, height)
    assert got.bytes() == want.bytes()
    assert got.hash() == want.hash()


@pytest.mark.parametrize("byz,height", [([2, 3], 2), ([0], 7)])
def test_the_forged_claim_equals_the_simnet_actor(byz, height):
    out = []
    for P in (JAX, PORT):
        privs, vals = keys_and_vals(P)
        out.append(P.actors.forged_claim(
            privs, vals, CHAIN, byz, height,
            P.ts.Timestamp(1_700_000_200, 5)))
    assert out[0] == out[1]
    assert json.dumps(out[0], sort_keys=True) == json.dumps(
        out[1], sort_keys=True)


@pytest.mark.parametrize("vote_type,nil", [("PREVOTE_TYPE", False),
                                           ("PRECOMMIT_TYPE", False),
                                           ("PRECOMMIT_TYPE", True)])
def test_the_equivocation_and_garbage_actors_equal_the_jax_ones(vote_type,
                                                                nil):
    """conflicting_vote re-signs the vote for a fabricated block ID with
    the raw key; garbage_sign puts a seeded forgery in its signature. The
    same vote and RNG seed give the same bytes in both packages."""
    out = []
    for P in (JAX, PORT):
        privs, vals = keys_and_vals(P)
        bid = (P.bid.BlockID() if nil else
               P.bid.BlockID(b"\xcc" * 32, P.bid.PartSetHeader(1, b"\xcc" * 32)))
        addr = privs[2].pub_key().address()
        idx, _ = vals.get_by_address(addr)
        v = P.vote.Vote(
            vote_type=getattr(P.canon, vote_type), height=6, round=1,
            block_id=bid, timestamp=P.ts.Timestamp(1_700_000_300, 7),
            validator_address=addr, validator_index=idx)
        v.signature = privs[2].sign(v.sign_bytes(CHAIN))
        bad = P.actors.conflicting_vote(v, privs[2], CHAIN)
        junk = P.actors.garbage_sign(v, random.Random(31))
        out.append([P.serde.vote_to_j(x) for x in (v, bad, junk)]
                   + [bad.sign_bytes(CHAIN).hex(),
                      privs[2].pub_key().verify_signature(
                          bad.sign_bytes(CHAIN), bad.signature)])
    assert out[0] == out[1]
    assert out[0][-1] is True


def test_the_election_equals_the_jax_one():
    """election_score and proportional_election over a 200-member pool of
    hashed keys and stakes 1-7, several epochs and churns: the same
    scores (float bits) and the same committees, rotations included."""
    pubs = [hashlib.sha256(b"pool-%d" % i).digest() for i in range(200)]
    stakes = {i: (pubs[i], 1 + i % 7) for i in range(200)}
    out = []
    for P in (JAX, PORT):
        a = P.actors
        scores = [a.election_score(seed, ep, pubs[i], stakes[i][1]).hex()
                  for seed in (-3, 0, 77) for ep in (0, 1, 5)
                  for i in range(0, 200, 13)]
        committee, standby = list(range(0, 200, 2)), list(range(1, 200, 2))
        rounds = []
        for ep, churn in enumerate((0.02, 0.25, 0.5, 1.0, 0.0), start=1):
            committee, standby, rot_out, rot_in = a.proportional_election(
                77, ep, committee, standby, stakes, churn)
            rounds.append((committee, standby, rot_out, rot_in))
        out.append((scores, rounds))
    assert out[0] == out[1]
    assert any(r[2] for r in out[0][1])


def outcome(fn):
    try:
        r = fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raise", type(e).__name__, str(e))
    if isinstance(r, list):
        r = [ev.hash().hex() for ev in r]
    return ("ret", r)


# -- tests/test_evidence.py:59-181, as functions of the package -------------


def sc_pool_verify_and_lifecycle(P, make_pool):
    privs, vals = keys_and_vals(P)
    pool = make_pool(P, lambda h: vals)
    ev = mk_evidence(P, privs[0], vals, 5)
    bad = mk_evidence(P, privs[1], vals, 5, power=99)
    out = [ev.bytes().hex(), ev.hash().hex(),
           outcome(lambda: pool.add_evidence(ev)),
           outcome(lambda: pool.add_evidence(ev)),
           outcome(pool.pending_evidence),
           outcome(lambda: pool.check_evidence([ev])),
           outcome(lambda: pool.mark_committed(6, 1_700_000_010, [ev])),
           outcome(pool.pending_evidence),
           outcome(lambda: pool.check_evidence([ev])),
           outcome(lambda: pool.add_evidence(bad)), pool.size()]
    assert out[2] == ("ret", True) and out[8][0] == "raise"
    return out


def sc_lca_pool_lifecycle(P, make_pool):
    privs, vals = keys_and_vals(P)
    pool = make_pool(P, lambda h: vals)
    ev = mk_lca(P, privs, vals, [1, 2], 5)
    out = [ev.bytes().hex(), ev.hash().hex(),
           outcome(lambda: pool.add_evidence(ev)),
           outcome(lambda: pool.add_evidence(ev)),
           outcome(pool.pending_evidence),
           outcome(lambda: pool.check_evidence([ev])),
           outcome(lambda: pool.mark_committed(6, 1_700_000_110, [ev])),
           outcome(pool.pending_evidence),
           outcome(lambda: pool.check_evidence([ev]))]
    pool2 = make_pool(P, lambda h: vals, max_age_blocks=10,
                      max_age_seconds=100)
    pool2.mark_committed(500, 1_800_000_000, [])
    old = mk_lca(P, privs, vals, [1, 2], 3)
    out += [outcome(lambda: pool2.add_evidence(old)), pool2.size()]
    assert out[2] == ("ret", True) and out[-2] == ("ret", False)
    return out


def sc_lca_verification_rejects_forgeries(P, make_pool):
    privs, vals = keys_and_vals(P)
    pool = make_pool(P, lambda h: vals)
    bad_power = mk_lca(P, privs, vals, [1, 2], 5)
    bad_power.total_voting_power = 99
    innocent = mk_lca(P, privs, vals, [1, 2], 5)
    innocent.byzantine_validators.append(privs[0].pub_key().address())
    weak = mk_lca(P, privs, vals, [1], 5)
    proofless = mk_lca(P, privs, vals, [1, 2], 5)
    proofless.conflicting_commit = None
    framed = mk_lca(P, privs, vals, [1, 2], 5)
    victim = privs[0].pub_key().address()
    vidx, _ = vals.get_by_address(victim)
    framed.conflicting_commit.signatures[vidx] = P.commit.CommitSig(
        P.commit.BLOCK_ID_FLAG_COMMIT, victim, framed.timestamp,
        b"\x13" * 64)
    framed.byzantine_validators.append(victim)
    out = [outcome(lambda: pool.add_evidence(ev))
           for ev in (bad_power, innocent, weak, proofless, framed)]
    for got, want in zip(out, ("total power", "did not sign", "trusting",
                               "no conflicting commit", "FORGED")):
        assert got[0] == "raise" and want in got[2], got
    return out + [pool.size()]


def sc_lca_attack_level_dedup(P, make_pool):
    privs, vals = keys_and_vals(P)
    pool = make_pool(P, lambda h: vals)
    ev = mk_lca(P, privs, vals, [1, 2], 5)
    variant = mk_lca(P, privs, vals, [1, 2, 3], 5)
    variant.byzantine_validators = list(ev.byzantine_validators)
    assert variant.hash() != ev.hash()
    out = [outcome(lambda: pool.add_evidence(ev)),
           outcome(lambda: pool.add_evidence(variant)),
           outcome(lambda: pool.mark_committed(6, 1_700_000_110, [ev])),
           pool.size(),
           outcome(lambda: pool.add_evidence(variant)),
           outcome(lambda: pool.check_evidence([variant]))]
    assert out[1] == ("ret", False) and "already committed" in out[5][2]
    return out


def sc_lca_serde_roundtrip_keeps_proof(P, make_pool):
    privs, vals = keys_and_vals(P)
    ev = mk_lca(P, privs, vals, [0, 3], 7)
    j = P.ev.evidence_to_j(ev)
    back = P.ev.evidence_from_j(j)
    pool = make_pool(P, lambda h: vals)
    stripped = P.ev.evidence_from_j(
        {k: v for k, v in j.items() if k != "commit"})
    out = [j, type(back).__name__, back.hash().hex(), ev.hash().hex(),
           back.conflicting_commit.block_id.hash.hex(),
           outcome(lambda: pool.add_evidence(back)),
           stripped.hash().hex(), stripped.conflicting_commit is None,
           outcome(lambda: pool.check_evidence([stripped]))]
    assert out[2] == out[3] and out[6] != out[3]
    return out


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


def _jax_pool(P, load, **kw):
    return P.pool.EvidencePool(CHAIN, load, **kw)


def _oracle_pool(P, load, **kw):
    return P.pool.EvidencePool(CHAIN, load,
                               batch_fn=P.validation.oracle_batch_fn(), **kw)


class _PlanePool:
    """batch_fn=None under a running port plane mounted as the global
    plane (use_device=False: the host path; device="cpu": the device
    path on the kernels' plain versions)."""

    def __init__(self, **plane_kw):
        self.plane_kw = plane_kw

    def __enter__(self):
        self.plane = pvp.VerifyPlane(window_ms=0.5, **self.plane_kw)
        self.plane.start()
        pvp.set_global_plane(self.plane)
        return self

    def __exit__(self, *exc):
        pvp.set_global_plane(None)
        self.plane.stop()

    def __call__(self, P, load, **kw):
        return P.pool.EvidencePool(CHAIN, load, **kw)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_evidence_scenario_matches_the_jax_pool(name):
    want = SCENARIOS[name](JAX, _jax_pool)
    assert SCENARIOS[name](PORT, _oracle_pool) == want
    with _PlanePool(use_device=False) as host:
        assert SCENARIOS[name](PORT, host) == want
        if name != "pool_verify_and_lifecycle":
            assert host.plane.rows_verified > 0


def test_a_device_plane_verifies_the_attack_on_its_device():
    """batch_fn=None under a device="cpu" plane: the named rows and the
    trusting check flush on the plane's device path, and the outcomes
    equal the JAX pool's."""
    want = SCENARIOS["lca_attack_level_dedup"](JAX, _jax_pool)
    with _PlanePool(device="cpu") as dev:
        assert SCENARIOS["lca_attack_level_dedup"](PORT, dev) == want
        paths = {r["path"] for r in dev.plane.ledger.records()}
        assert dev.plane.rows_verified > 0 and "host" not in paths


def _calls(fn):
    calls = []

    def wrapped(pubs, msgs, sigs):
        calls.append(len(pubs))
        return fn(pubs, msgs, sigs)

    return wrapped, calls


def test_named_rows_verify_as_one_batch_and_blame_the_first_forgery():
    """Two named rows forged (validators 2 and 3, in that order), then a
    name that signed nothing: one batch_fn call carries the named rows
    before the walk's first error, the error names validator 2's address
    with the JAX text; with the forgeries repaired, the walk's own error
    ("did not sign") is raised, as in the JAX one-by-one walk."""
    outs = {}
    for P in (JAX, PORT):
        privs, vals = keys_and_vals(P, n=6)
        ev = mk_lca(P, privs, vals, [1, 2, 3, 4], 5)
        for i in (2, 3):
            addr = privs[i].pub_key().address()
            vidx, _ = vals.get_by_address(addr)
            cs = ev.conflicting_commit.signatures[vidx]
            cs.signature = cs.signature[:5] + b"\x00" + cs.signature[6:]
        ev.byzantine_validators.append(privs[0].pub_key().address())
        fn, calls = _calls(P.validation.oracle_batch_fn())
        forged = outcome(lambda: P.verify.verify_light_client_attack(
            ev, CHAIN, vals, batch_fn=fn))
        clean = mk_lca(P, privs, vals, [1, 2, 3, 4], 5)
        clean.byzantine_validators.append(privs[0].pub_key().address())
        fn2, calls2 = _calls(P.validation.oracle_batch_fn())
        walk = outcome(lambda: P.verify.verify_light_client_attack(
            clean, CHAIN, vals, batch_fn=fn2))
        outs[P.name] = (forged, walk, calls, calls2)
    assert outs["port"][:2] == outs["jax"][:2]
    assert "FORGED" in outs["port"][0][2]
    addr2 = keys_and_vals(PORT, n=6)[0][2].pub_key().address().hex()
    assert addr2 in outs["port"][0][2]
    assert "did not sign" in outs["port"][1][2]
    # the port: the four named rows in ONE call, nothing after the forgery
    assert outs["port"][2] == [4]
    assert outs["port"][3] == [4]
    # the JAX walk verifies on the host, one row at a time
    assert outs["jax"][2] == []


def test_evidence_with_no_plane_is_the_card():
    privs, vals = keys_and_vals(PORT)
    ev = mk_lca(PORT, privs, vals, [1, 2], 5)
    pool = PORT.pool.EvidencePool(CHAIN, lambda h: vals)
    assert pvp.global_plane() is None
    if torch.cuda.is_available():
        assert pool.add_evidence(ev)
    else:
        with pytest.raises(DeviceError):
            pool.add_evidence(ev)


def test_a_device_plane_that_cannot_take_the_rows_keeps_them_on_its_device(
        monkeypatch):
    """A running plane that cannot take the rows (PlaneQueueFull) sends
    them to verify_batch_direct on the plane's own device; a host plane
    answers from the host."""
    seen = []
    real = pbatch.verify_batch_direct

    def spy(pubs, msgs, sigs, device=None, **kw):
        seen.append((len(pubs), str(device)))
        return real(pubs, msgs, sigs, device=device, **kw)

    monkeypatch.setattr(pbatch, "verify_batch_direct", spy)
    for kw, want_direct in (({"device": "cpu"}, True),
                            ({"use_device": False}, False)):
        seen.clear()
        privs, vals = keys_and_vals(PORT)
        ev = mk_lca(PORT, privs, vals, [1, 2], 5)
        plane = pvp.VerifyPlane(window_ms=0.5, **kw)
        plane.start()
        pvp.set_global_plane(plane)

        def submit_many(*a, **k):
            raise pvp.PlaneQueueFull("plane full")

        plane.submit_many = submit_many  # a plane that cannot take rows
        try:
            assert PORT.pool.EvidencePool(CHAIN,
                                          lambda h: vals).add_evidence(ev)
        finally:
            pvp.set_global_plane(None)
            plane.stop()
        if want_direct:
            assert seen and all(d == "cpu" for _, d in seen)
            assert seen[0][0] == 2
        else:
            assert seen == []
