"""The port's VoteSet (cometbft_tpu_torch/types/vote_set.py) against the
JAX package's, on seeded precommit sequences of an 8-validator set.

Each sequence goes to the JAX VoteSet on a host JAX plane
(`use_device=False`) and on no plane, and to the port's VoteSet three
ways: on a host port plane (`use_device=False`), on a `device="cpu"` port
plane (the fused path, on the kernels' plain versions) and on no plane
(the serial path). Return values, exception classes and messages,
`bit_array()`, the per-block bit arrays, `two_thirds_majority()`, `sum`,
`make_commit()` and `make_extended_commit()` (hash and serde JSON) must be
equal in every run. The sequences cover valid votes, a tampered signature,
a conflicting vote, `set_peer_maj23`, nil votes, extensions required and
forbidden (tests/test_vote_ext.py:88, :107), a bad index and a wrong
height, a prevote set, and the threaded quorum scenario of
tests/test_verify_plane.py:295.

Then the port's own seams: a faulting device plane makes add_vote raise
DeviceError and admits nothing (ROADMAP C1: the JAX plane would answer
from the host); a plane that stops under a submission gives the JAX
VoteSet's outcome, a host plane through the serial path and a device
plane through a direct verify on its own device, and a device plane that
is full or sheds never sends the vote to the host; a device plane's
verdict that times out is a DeviceError; and the template prefetch a vote
asks of the global warmer."""
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import serde as jserde
from cometbft_tpu.types import vote_set as jvs
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.timestamp import Timestamp as JTimestamp
from cometbft_tpu.types.validator import Validator as JValidator
from cometbft_tpu.types.validator import ValidatorSet as JValidatorSet
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu.verifyplane import plane as jvp
from cometbft_tpu_torch import device as pdevice
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.libs import failpoints as pfp
from cometbft_tpu_torch.types import canonical as pcanon
from cometbft_tpu_torch.types import serde as pserde
from cometbft_tpu_torch.types import vote_set as pvs
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.verifyplane import plane as pvp
from cometbft_tpu_torch.verifyplane import warmer as pwm

torch.set_num_threads(1)

CHAIN = "voteset-diff"
HEIGHT = 41
N_VALS = 8

JAX = SimpleNamespace(keys=jkeys, canon=jcanon, serde=jserde, vs=jvs,
                      BlockID=JBlockID, PSH=JPSH, Timestamp=JTimestamp,
                      Validator=JValidator, ValidatorSet=JValidatorSet,
                      Vote=JVote)
PORT = SimpleNamespace(keys=pkeys, canon=pcanon, serde=pserde, vs=pvs,
                       BlockID=BlockID, PSH=PartSetHeader,
                       Timestamp=Timestamp, Validator=Validator,
                       ValidatorSet=ValidatorSet, Vote=Vote)


def _fixture():
    rng = np.random.default_rng(1516)
    seeds = [rng.bytes(32) for _ in range(N_VALS)]
    # close powers: any 6 of the 8 hold more than 2/3
    powers = [int(p) for p in rng.integers(100, 121, N_VALS)]
    blocks = {k: (rng.bytes(32), rng.bytes(32)) for k in ("A", "B")}
    secs = [1_700_000_000 + int(s) for s in rng.integers(0, 2**20, 64)]
    nanos = [int(n) for n in rng.integers(0, 10**9, 64)]
    return SimpleNamespace(seeds=seeds, powers=powers, blocks=blocks,
                           secs=secs, nanos=nanos)


FIX = _fixture()


class Pkg:
    """One package's objects for the fixture: the valset (in its sorted
    order), the private key of each index, the block ids."""

    def __init__(self, P):
        self.P = P
        privs = [P.keys.PrivKey.generate(s) for s in FIX.seeds]
        self.vals = P.ValidatorSet([
            P.Validator(p.pub_key(), w) for p, w in zip(privs, FIX.powers)])
        by_addr = {p.pub_key().address(): p for p in privs}
        self.privs = [by_addr[v.address] for v in self.vals.validators]
        self.bids = {k: P.BlockID(h, P.PSH(1, p))
                     for k, (h, p) in FIX.blocks.items()}
        self.bids[None] = P.BlockID()

    def vote(self, v, blk="A", ts=0, tamper=False, idx=None, height=None,
             ext=b"", ext_sig="none", vote_type=None):
        P = self.P
        priv = self.privs[v]
        vo = P.Vote(vote_type=vote_type or P.canon.PRECOMMIT_TYPE,
                    height=HEIGHT if height is None else height, round=0,
                    block_id=self.bids[blk],
                    timestamp=P.Timestamp(FIX.secs[ts], FIX.nanos[ts]),
                    validator_address=priv.pub_key().address(),
                    validator_index=v if idx is None else idx,
                    extension=ext)
        sig = priv.sign(vo.sign_bytes(CHAIN))
        if tamper:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        vo.signature = sig
        if ext_sig == "ok":
            vo.extension_signature = priv.sign(
                vo.extension_sign_bytes(CHAIN))
        elif ext_sig == "forged":
            vo.extension_signature = b"\x01" * 64
        return vo


JPKG = Pkg(JAX)
PPKG = Pkg(PORT)


def _outcome(fn):
    try:
        return ("ret", fn())
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raise", type(e).__name__, str(e))


def _bid(b):
    return None if b is None else (b.hash, b.part_set_header.total,
                                   b.part_set_header.hash)


def _bits(ba):
    return None if ba is None else [ba.get_index(i)
                                    for i in range(N_VALS)]


def final_state(pk, vset):
    P = pk.P
    out = {
        "bits": _bits(vset.bit_array()),
        "by_block": {str(k): _bits(vset.bit_array_by_block_id(b))
                     for k, b in pk.bids.items()},
        "maj23": _bid(vset.two_thirds_majority()),
        "sum": vset.sum,
        "has_all": vset.has_all(),
        "two_thirds_any": vset.has_two_thirds_any(),
    }
    c = _outcome(vset.make_commit)
    out["commit"] = c if c[0] == "raise" else (
        "ret", c[1].hash(), json.dumps(P.serde.commit_to_j(c[1])))
    e = _outcome(vset.make_extended_commit)
    out["ext_commit"] = e if e[0] == "raise" else (
        "ret", json.dumps(P.serde.extcommit_to_j(e[1])),
        e[1].to_commit().hash())
    return out


# -- the sequences ----------------------------------------------------------
# ("add", vote kwargs) | ("nil",) | ("peer", peer id, block key)

SEQUENCES = {
    "quorum_with_faults": dict(ext=False, ops=[
        ("add", dict(v=0)),
        ("add", dict(v=1, ts=1)),
        ("add", dict(v=2, ts=2, tamper=True)),       # invalid signature
        ("add", dict(v=3, ts=3)),
        ("add", dict(v=0)),                          # exact duplicate
        ("add", dict(v=1, blk="B", ts=4)),           # conflicting vote
        ("add", dict(v=4, blk=None, ts=5)),          # nil precommit
        ("add", dict(v=5, ts=6, idx=99)),            # bad index
        ("add", dict(v=5, ts=6, idx=-1)),            # negative index
        ("add", dict(v=5, ts=6, height=HEIGHT + 1)),  # wrong height
        ("add", dict(v=5, ts=6, idx=6)),             # index/address
        ("nil",),
        ("add", dict(v=5, ts=6)),
        ("add", dict(v=6, ts=7)),
        ("add", dict(v=7, blk="B", ts=8)),
        ("add", dict(v=2, ts=9)),                    # now well signed
    ]),
    "peer_maj23_unlocks_a_conflict": dict(ext=False, ops=[
        ("add", dict(v=0, ts=10)),
        ("add", dict(v=1, ts=11)),
        ("add", dict(v=2, ts=12)),
        ("peer", "p1", "B"),
        ("add", dict(v=0, blk="B", ts=13)),          # accepted: peer maj23
        ("peer", "p1", "A"),                         # conflicting claim
        ("peer", "p1", "B"),                         # repeat: no-op
        ("add", dict(v=3, blk="B", ts=14)),
        ("add", dict(v=4, blk=None, ts=15)),
        ("add", dict(v=1, blk="B", ts=16)),
        ("add", dict(v=5, blk="B", ts=17)),
        ("add", dict(v=6, blk="B", ts=18)),
        ("add", dict(v=7, blk="B", ts=19)),
        ("add", dict(v=2, blk="B", ts=20)),
    ]),
    "nil_majority_makes_no_commit": dict(ext=False, ops=[
        ("add", dict(v=v, blk=None, ts=21 + v)) for v in range(6)
    ]),
    "prevotes_make_no_commit": dict(ext=False, prevote=True, ops=[
        ("add", dict(v=v, ts=29 + v)) for v in range(6)
    ]),
    # test_vote_ext.py:88
    "extensions_required": dict(ext=True, ops=[
        ("add", dict(v=0, ts=35)),                   # missing ext sig
        ("add", dict(v=0, ts=35, ext=b"data", ext_sig="forged")),
        ("add", dict(v=0, ts=35, ext=b"data", ext_sig="ok")),
        ("add", dict(v=1, blk=None, ts=36)),         # nil: none needed
        ("add", dict(v=2, ts=37, ext=b"e2", ext_sig="ok", tamper=True)),
        ("add", dict(v=2, ts=37, ext=b"e2", ext_sig="ok")),
        ("add", dict(v=3, ts=38, ext=b"", ext_sig="ok")),  # empty ext
        ("add", dict(v=4, ts=39, ext=b"e4", ext_sig="ok")),
        ("add", dict(v=5, ts=40, ext=b"e5", ext_sig="ok")),
        ("add", dict(v=6, ts=41, ext=b"e6", ext_sig="ok")),
    ]),
    # test_vote_ext.py:107
    "extensions_forbidden": dict(ext=False, ops=[
        ("add", dict(v=0, ts=42, ext=b"data", ext_sig="ok")),
        ("add", dict(v=1, ts=43, ext=b"", ext_sig="ok")),
        ("add", dict(v=2, ts=44)),
    ]),
}


def run_sequence(pk, name, plane):
    seq = SEQUENCES[name]
    P = pk.P
    vtype = P.canon.PREVOTE_TYPE if seq.get("prevote") else None
    vset = P.vs.VoteSet(CHAIN, HEIGHT, 0, vtype or P.canon.PRECOMMIT_TYPE,
                        pk.vals, ext_enabled=seq["ext"])
    vset.verify_plane = plane
    outs = []
    for op in seq["ops"]:
        if op[0] == "add":
            vo = pk.vote(vote_type=vtype, **op[1])
            outs.append(_outcome(lambda: vset.add_vote(vo)))
        elif op[0] == "nil":
            outs.append(_outcome(lambda: vset.add_vote(None)))
        else:
            _, peer, blk = op
            outs.append(_outcome(
                lambda: vset.set_peer_maj23(peer, pk.bids[blk])))
    return {"ops": outs, **final_state(pk, vset)}


def run_threaded(pk, plane):
    """test_verify_plane.py:295 on the fixture: 6 precommits with
    extensions (vote + extension signature as one submission) from 6
    threads reach quorum through the plane's tally; a forged extension
    is rejected without its power standing; a duplicate returns False."""
    P = pk.P
    vset = P.vs.VoteSet(CHAIN, HEIGHT, 0, P.canon.PRECOMMIT_TYPE,
                        pk.vals, ext_enabled=True)
    vset.verify_plane = plane
    votes = [pk.vote(v, ts=45 + v, ext=b"ext", ext_sig="ok")
             for v in range(6)]
    outs = [None] * 6
    start = threading.Barrier(6)

    def add(i):
        start.wait(30.0)
        outs[i] = _outcome(lambda: vset.add_vote(votes[i]))

    threads = [threading.Thread(target=add, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
        assert not t.is_alive()
    bad = pk.vote(6, ts=51, ext=b"ext", ext_sig="forged")
    tail = [_outcome(lambda: vset.add_vote(bad)),
            _outcome(lambda: vset.add_vote(votes[0]))]
    group = None
    if plane is not None:
        g = vset._plane_groups[pk.bids["A"].key()]
        group = (g.quorum_reached, g.tally)
    return {"ops": outs + tail, "group": group, **final_state(pk, vset)}


@pytest.fixture(scope="module")
def planes():
    """The four planes: the JAX host plane, the port's host plane, the
    port's fused plane on the plain kernels. Started once."""
    ps = {"jax_host": jvp.VerifyPlane(window_ms=0.5, use_device=False),
          "port_host": pvp.VerifyPlane(window_ms=0.5, use_device=False),
          "port_fused": pvp.VerifyPlane(window_ms=0.5, device="cpu")}
    for p in ps.values():
        p.start()
    yield ps
    for p in ps.values():
        p.stop()


def _runs(planes, fn):
    """fn(pkg, plane) in every mode: {mode: outcome}, with the paths of
    the fused plane's flushes during its run."""
    out = {"jax_host": fn(JPKG, planes["jax_host"]),
           "jax_serial": fn(JPKG, None),
           "port_host": fn(PPKG, planes["port_host"]),
           "port_serial": fn(PPKG, None)}
    fused = planes["port_fused"]
    n0 = len(fused.ledger.records())
    out["port_fused"] = fn(PPKG, fused)
    paths = {r["path"] for r in fused.ledger.records()[n0:]}
    return out, paths


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_vote_sequence_matches_the_jax_vote_set(planes, name):
    out, paths = _runs(planes, lambda pk, p: run_sequence(pk, name, p))
    want = out["jax_host"]
    for mode, got in out.items():
        assert got == want, mode
    assert paths <= {"fused"}
    if name != "prevotes_make_no_commit":
        assert paths == {"fused"}  # the device path really ran
    if name == "quorum_with_faults":
        ops = want["ops"]
        assert ops[2] == ("raise", "VoteSetError",
                          "invalid vote: invalid signature")
        assert ops[4] == ("ret", False)
        assert ops[5][1] == "ConflictingVoteError"
        assert want["maj23"] == _bid(JPKG.bids["A"])
        assert want["commit"][0] == "ret"
    if name == "peer_maj23_unlocks_a_conflict":
        assert want["ops"][4] == ("ret", True)
        assert want["maj23"] == _bid(JPKG.bids["B"])


def test_threaded_quorum_through_the_plane_matches_the_jax_vote_set(planes):
    out, paths = _runs(planes, run_threaded)
    want = out["jax_host"]
    assert want["group"][0] is True
    assert want["ops"][6][0] == "raise" and "extension" in want["ops"][6][2]
    assert want["ops"][7] == ("ret", False)
    for mode, got in out.items():
        if mode.endswith("serial"):
            assert got["group"] is None
            got = dict(got, group=want["group"])
        assert got == want, mode
    assert paths == {"fused"}


def test_a_device_fault_propagates_out_of_add_vote():
    """A device plane whose flush faults fails the vote's future with
    DeviceError; VoteSet lets it through (it is not a PlaneError) and
    admits nothing. The JAX plane would have verified on the host
    (ROADMAP C1)."""
    plane = pvp.VerifyPlane(window_ms=0.5, device="cpu")
    plane.start()
    try:
        vset = pvs.VoteSet(CHAIN, HEIGHT, 0, pcanon.PRECOMMIT_TYPE,
                           PPKG.vals)
        vset.verify_plane = plane
        vo = PPKG.vote(0, ts=60)
        pfp.arm("verifyplane.dispatch", "raise", count=1)
        try:
            with pytest.raises(pdevice.DeviceError):
                vset.add_vote(vo)
        finally:
            pfp.reset()
        assert vset.bit_array().is_empty() and vset.sum == 0
        assert vset.get_by_index(0) is None
        assert not issubclass(pdevice.DeviceError, pvp.PlaneError)
        recs = plane.ledger.records()
        assert recs[-1]["path"] == "device_fault"
        assert plane.rows_verified == 0
    finally:
        plane.stop()


def _stop_under_submission(plane):
    """Make `plane` stop just as a submission arrives: submit_many raises
    PlaneStopped (a plane that was running when VoteSet picked it)."""
    real = plane.submit_many

    def submit_many(*a, **kw):
        plane.stop()
        return real(*a, **kw)

    plane.submit_many = submit_many


def test_a_plane_stopped_under_a_vote_takes_the_serial_path():
    """As in the JAX VoteSet: PlaneError (here PlaneStopped) is an
    admission outcome, so a host plane's vote is verified on the host,
    one by one, and a device plane's directly on its device (the test
    below); the outcome equals the JAX VoteSet's under the same race."""
    outs = {}
    for name, pk, mod, kw in (
            ("jax", JPKG, jvp, {"use_device": False}),
            ("port_host", PPKG, pvp, {"use_device": False}),
            ("port_fused", PPKG, pvp, {"device": "cpu"})):
        plane = mod.VerifyPlane(window_ms=0.5, **kw)
        plane.start()
        try:
            vset = pk.P.vs.VoteSet(CHAIN, HEIGHT, 0,
                                   pk.P.canon.PRECOMMIT_TYPE, pk.vals)
            vset.verify_plane = plane
            _stop_under_submission(plane)
            good = _outcome(lambda: vset.add_vote(pk.vote(0, ts=61)))
            bad = _outcome(lambda: vset.add_vote(
                pk.vote(1, ts=62, tamper=True)))
            outs[name] = (good, bad, _bits(vset.bit_array()), vset.sum,
                          plane.rows_verified)
        finally:
            plane.stop()
    assert outs["jax"][:2] == (("ret", True), (
        "raise", "VoteSetError", "invalid vote: invalid signature"))
    assert outs["jax"][4] == 0  # no row reached the plane
    assert outs["port_host"] == outs["jax"]
    assert outs["port_fused"] == outs["jax"]


@pytest.mark.parametrize("exc", [pvp.PlaneOverloaded, pvp.PlaneQueueFull,
                                 pvp.PlaneStopped])
def test_a_device_plane_that_cannot_take_a_vote_keeps_it_on_its_device(
        monkeypatch, exc):
    """A device plane that sheds, is full or stops under a vote: the vote
    is verified by crypto/batch.verify_batch_direct on the plane's device
    (here the plain kernels on the CPU), never by the pure-Python serial
    path, and admission brings the block's quorum group up to date."""
    from cometbft_tpu_torch.crypto import batch as pcbatch

    def serial(*a, **kw):
        raise AssertionError("the vote took the host serial path")

    monkeypatch.setattr(pvs.VoteSet, "_add_vote", serial)
    monkeypatch.setattr(Vote, "verify", serial)
    direct = []
    real_direct = pcbatch.verify_batch_direct

    def verify_batch_direct(pubs, msgs, sigs, device=None, **kw):
        direct.append((len(pubs), device))
        return real_direct(pubs, msgs, sigs, device=device, **kw)

    monkeypatch.setattr(pcbatch, "verify_batch_direct", verify_batch_direct)
    plane = pvp.VerifyPlane(window_ms=0.5, device="cpu")
    plane.start()
    try:
        def refuse(*a, **kw):
            raise exc("refused")

        plane.submit_many = refuse
        vset = pvs.VoteSet(CHAIN, HEIGHT, 0, pcanon.PRECOMMIT_TYPE,
                           PPKG.vals)
        vset.verify_plane = plane
        good = _outcome(lambda: vset.add_vote(PPKG.vote(0, ts=56)))
        bad = _outcome(lambda: vset.add_vote(PPKG.vote(1, ts=57,
                                                       tamper=True)))
        assert (good, bad) == (("ret", True), (
            "raise", "VoteSetError", "invalid vote: invalid signature"))
        assert direct == [(1, torch.device("cpu"))] * 2
        assert _bits(vset.bit_array()) == [True] + [False] * (N_VALS - 1)
        assert vset.sum == PPKG.vals.validators[0].voting_power
        group = vset._plane_groups[PPKG.bids["A"].key()]
        assert group.tally == vset.sum and not group.quorum_reached
        assert plane.rows_verified == 0
    finally:
        plane.stop()


@pytest.mark.parametrize("kw,err", [({"device": "cpu"}, pdevice.DeviceError),
                                    ({"use_device": False}, pvp.PlaneError)])
def test_a_verdict_that_times_out_is_a_device_error_on_a_device_plane(kw, err):
    """A device plane's future that times out raises DeviceError (a wedged
    device pass), which VoteSet lets through; a host plane's raises
    PlaneError. The dispatcher is held off by holding the plane's lock."""
    plane = pvp.VerifyPlane(window_ms=0.5, **kw)
    plane.start()
    try:
        pub = PPKG.vals.validators[0].pub_key
        with plane._cv:
            fut = plane.submit_many([(pub, b"m", b"\x00" * 64)])
            with pytest.raises(err) as got:
                fut.result(0.05)
        assert "timed out" in str(got.value)
        assert isinstance(got.value, pvp.PlaneError) == (
            err is pvp.PlaneError)
        assert fut.result(60.0) == (False,)
    finally:
        plane.stop()


def test_a_vote_asks_the_global_warmer_for_its_template():
    """The plane path's best-effort template prefetch: a running global
    warmer receives the vote's stamp site."""
    sites = []

    class Recorder(pwm.TableWarmer):
        def request_template(self, s):
            sites.append(tuple(s))

    w = Recorder(build_fn=lambda p, pw: None, use_device=False)
    w.start()
    pwm.set_global_warmer(w)
    plane = pvp.VerifyPlane(window_ms=0.5, use_device=False)
    plane.start()
    try:
        vset = pvs.VoteSet(CHAIN, HEIGHT, 0, pcanon.PRECOMMIT_TYPE,
                           PPKG.vals)
        vset.verify_plane = plane
        assert vset.add_vote(PPKG.vote(0, ts=63))
        from cometbft_tpu_torch.types.vote import sign_bytes_template

        tmpl = sign_bytes_template(CHAIN, pcanon.PRECOMMIT_TYPE, HEIGHT, 0,
                                   PPKG.bids["A"])
        assert [tuple(x.key for x in ss) for ss in sites] == [
            (tmpl.stamp_site().key,)]
    finally:
        plane.stop()
        pwm.clear_global_warmer(w)
        w.stop()
        pwm._LAST = None
