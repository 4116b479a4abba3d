"""The port's consensus state machine (cometbft_tpu_torch/consensus/state.py)
and HeightVoteSet against the JAX package's.

tests/test_pol.py's two scripted scenarios (POL-based unlocking, and a
lying POL that must not unlock) run on both packages' ConsensusState,
single-threaded through the ManualTicker seam, from the same keys with
Timestamp.now pinned: every proposal and vote the machine broadcasts must
be equal byte for byte (sign bytes and signature), and so must the lock
and valid-block decisions after every step. HeightVoteSet takes the same
vote sequence on both packages (rounds ahead, conflicts, a bad
signature) with equal outcomes, majorities and POL; the port's, given a
device and no plane, verifies each vote with verify_batch_direct on that
device. A DeviceError out of VoteSet.add_vote (a device="cpu" plane whose
dispatch faults) is not logged as an invalid vote: the receive routine's
catch-all reports it, the vote is not admitted, and the engine goes on.
"""
import importlib
import logging
import queue
import time
from types import SimpleNamespace

import pytest

MODULES = {"kv": "abci.kvstore", "cs": "consensus.state",
           "ticker": "consensus.ticker", "hvs": "consensus.height_vote_set",
           "keys": "crypto.keys", "pv": "privval.file_pv",
           "ex": "state.execution", "state": "state.state",
           "bs": "store.blockstore", "canon": "types.canonical",
           "bid": "types.block_id", "commit": "types.commit",
           "proposal": "types.proposal", "ts": "types.timestamp",
           "val": "types.validator", "vote": "types.vote",
           "vs": "types.vote_set"}


def _pkg(base):
    return SimpleNamespace(name=base, **{
        k: importlib.import_module(f"{base}.{m}")
        for k, m in MODULES.items()})


JAX = _pkg("cometbft_tpu")
PORT = _pkg("cometbft_tpu_torch")
CHAIN = "pol-chain"
NOW = 1_700_000_200


@pytest.fixture
def fixed_now(monkeypatch):
    for P in (JAX, PORT):
        ts = P.ts.Timestamp
        monkeypatch.setattr(ts, "now", staticmethod(
            lambda ts=ts: ts(NOW, 123_000)))


class Machine:
    """One package's ConsensusState for a 4-validator genesis, driven by
    hand (tests/test_pol.py's harness)."""

    def __init__(self, P, key_base):
        self.P = P
        self.privs = [P.keys.PrivKey.generate(bytes([i + key_base]) * 32)
                      for i in range(4)]
        self.vs = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10)
                                      for p in self.privs])
        self.state = P.state.State.make_genesis(CHAIN, self.vs)
        self.exec = P.ex.BlockExecutor(P.kv.KVStoreApplication(),
                                       P.state.StateStore(":memory:"))
        self.captured = []
        self.cs = P.cs.ConsensusState(
            self.state, self.exec, P.bs.BlockStore(":memory:"),
            privval=P.pv.FilePV(self.privs[0]), manual_ticker=True,
            broadcast=self.captured.append)
        self.cs._started = True
        self.cs.decide_proposal_fn = lambda h, r: None
        self.others = self.privs[1:]
        self.trace = []

    def drain(self):
        while True:
            try:
                item = self.cs.internal_queue.get_nowait()
            except queue.Empty:
                return
            self.cs._handle(item, write_wal=False)

    def block(self, tx):
        P = self.P
        prop0 = self.cs.proposer_for_round(0).address
        return self.exec.create_proposal_block(
            1, self.state, P.commit.Commit(0, 0, P.bid.BlockID(), []),
            prop0, txs=[tx])

    def peer_vote(self, priv, vote_type, round_, bid):
        P = self.P
        addr = priv.pub_key().address()
        idx, _ = self.vs.get_by_address(addr)
        v = P.vote.Vote(vote_type=vote_type, height=self.cs.height,
                        round=round_, block_id=bid,
                        timestamp=P.ts.Timestamp(1_700_000_100, 0),
                        validator_address=addr, validator_index=idx)
        v.signature = priv.sign(v.sign_bytes(CHAIN))
        self.cs._handle(("vote", P.cs.VoteMsg(v)), write_wal=False)
        self.drain()
        self.note("vote")

    def proposal(self, round_, pol_round, block):
        P = self.P
        proposer = self.cs.proposer_for_round(round_)
        priv = next(p for p in self.privs
                    if p.pub_key().address() == proposer.address)
        prop = P.proposal.Proposal(self.cs.height, round_, pol_round,
                                   block.block_id(),
                                   P.ts.Timestamp(1_700_000_050, 0))
        prop.signature = priv.sign(prop.sign_bytes(CHAIN))
        self.cs._handle(("proposal", P.cs.ProposalMsg(prop, block)),
                        write_wal=False)
        self.drain()
        self.note("proposal")

    def fire(self, round_, step):
        self.cs._handle_timeout(self.P.ticker.TimeoutInfo(
            self.cs.height, round_, step, 0))
        self.drain()
        self.note("timeout")

    def note(self, what):
        cs = self.cs

        def h(b):
            return b.hash().hex() if b is not None else None

        self.trace.append((what, cs.height, cs.round, cs.step,
                           cs.locked_round, h(cs.locked_block),
                           cs.valid_round, h(cs.valid_block),
                           len(self.captured)))

    def own(self, vote_type, round_):
        return [m[1] for m in self.captured
                if m[0] == "vote" and m[1].vote_type == vote_type
                and m[1].round == round_]

    def wire(self):
        """Every broadcast message as bytes: sign bytes and signature."""
        out = []
        for kind, m in self.captured:
            if kind == "vote":
                out.append((kind, m.sign_bytes(CHAIN).hex(),
                            m.signature.hex()))
            else:
                out.append((kind, m.proposal.sign_bytes(CHAIN).hex(),
                            m.proposal.signature.hex(),
                            m.block.hash().hex()))
        return out


def pol_unlock(P):
    """tests/test_pol.py::test_pol_unlock_prevotes_new_block."""
    m = Machine(P, 40)
    cs, canon = m.cs, P.canon
    block_a, block_b = m.block(b"a=1"), m.block(b"b=2")
    assert block_a.hash() != block_b.hash()
    cs._enter_new_round(1, 0)
    m.drain()
    m.proposal(0, -1, block_a)
    assert m.own(canon.PREVOTE_TYPE, 0), "no prevote"
    for p in m.others[:2]:
        m.peer_vote(p, canon.PREVOTE_TYPE, 0, block_a.block_id())
    assert cs.locked_round == 0
    assert cs.locked_block.hash() == block_a.hash()
    for p in m.others:
        m.peer_vote(p, canon.PRECOMMIT_TYPE, 0, P.bid.BlockID())
    m.fire(0, P.cs.STEP_PRECOMMIT_WAIT)
    assert cs.round == 1
    m.peer_vote(m.others[0], canon.PREVOTE_TYPE, 1, block_b.block_id())
    m.peer_vote(m.others[1], canon.PREVOTE_TYPE, 1, block_b.block_id())
    m.fire(1, P.cs.STEP_PROPOSE)
    nil_pv = m.own(canon.PREVOTE_TYPE, 1)
    assert nil_pv and nil_pv[-1].block_id.is_nil()
    m.fire(1, P.cs.STEP_PREVOTE_WAIT)
    assert cs.locked_round == 0
    m.peer_vote(m.others[2], canon.PREVOTE_TYPE, 1, block_b.block_id())
    assert cs.locked_block.hash() == block_a.hash()
    for p in m.others:
        m.peer_vote(p, canon.PRECOMMIT_TYPE, 1, P.bid.BlockID())
    m.fire(1, P.cs.STEP_PRECOMMIT_WAIT)
    assert cs.round == 2
    m.proposal(2, 1, block_b)
    pv2 = m.own(canon.PREVOTE_TYPE, 2)
    assert pv2 and pv2[-1].block_id.hash == block_b.hash()
    for p in m.others[:2]:
        m.peer_vote(p, canon.PREVOTE_TYPE, 2, block_b.block_id())
    assert cs.locked_round == 2
    assert cs.locked_block.hash() == block_b.hash()
    pc2 = m.own(canon.PRECOMMIT_TYPE, 2)
    assert pc2 and pc2[-1].block_id.hash == block_b.hash()
    return m


def no_unlock_without_pol(P):
    """tests/test_pol.py::test_no_unlock_without_pol_evidence."""
    m = Machine(P, 80)
    cs, canon = m.cs, P.canon
    block_a, block_b = m.block(b"a=1"), m.block(b"b=2")
    cs._enter_new_round(1, 0)
    m.drain()
    m.proposal(0, -1, block_a)
    for p in m.others[:2]:
        m.peer_vote(p, canon.PREVOTE_TYPE, 0, block_a.block_id())
    assert cs.locked_round == 0
    for p in m.others:
        m.peer_vote(p, canon.PRECOMMIT_TYPE, 0, P.bid.BlockID())
    m.fire(0, P.cs.STEP_PRECOMMIT_WAIT)
    for p in m.others:
        m.peer_vote(p, canon.PRECOMMIT_TYPE, 1, P.bid.BlockID())
    m.fire(1, P.cs.STEP_PROPOSE)
    m.fire(1, P.cs.STEP_PRECOMMIT_WAIT)
    assert cs.round == 2
    m.proposal(2, 1, block_b)
    pv2 = m.own(canon.PREVOTE_TYPE, 2)
    assert pv2 and pv2[-1].block_id.is_nil()
    assert cs.locked_block.hash() == block_a.hash()
    return m


@pytest.mark.parametrize("scenario", [pol_unlock, no_unlock_without_pol],
                         ids=lambda f: f.__name__)
def test_pol_scenarios_equal_byte_for_byte(scenario, fixed_now):
    j, p = scenario(JAX), scenario(PORT)
    assert p.wire() == j.wire()
    assert p.trace == j.trace
    assert len(p.wire()) >= 4
    assert p.cs.round_state_json() == j.cs.round_state_json()


# -- HeightVoteSet ------------------------------------------------------------


def _hvs_run(P, device=None):
    privs = [P.keys.PrivKey.generate(bytes([i + 120]) * 32)
             for i in range(4)]
    vs = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10)
                             for p in privs])
    kw = {} if P is JAX else {"device": device}
    hvs = P.hvs.HeightVoteSet(CHAIN, 3, vs, **kw)
    flushes = []
    hvs.set_on_flush(flushes.append)
    bid_a = P.bid.BlockID(b"\xaa" * 32, P.bid.PartSetHeader(1, b"\x01" * 32))
    bid_b = P.bid.BlockID(b"\xbb" * 32, P.bid.PartSetHeader(1, b"\x02" * 32))

    def vote(i, vtype, r, bid, bad=False):
        addr = privs[i].pub_key().address()
        idx, _ = vs.get_by_address(addr)
        v = P.vote.Vote(vote_type=vtype, height=3, round=r, block_id=bid,
                        timestamp=P.ts.Timestamp(NOW + i, 7),
                        validator_address=addr, validator_index=idx)
        v.signature = privs[i].sign(v.sign_bytes(CHAIN))
        if bad:
            v.signature = bytes([v.signature[0] ^ 1]) + v.signature[1:]
        return v

    out = []
    script = [(0, 1, 0, bid_a, False), (1, 1, 0, bid_a, False),
              (2, 1, 0, bid_a, True), (2, 1, 0, bid_a, False),
              (3, 1, 3, bid_a, False), (3, 1, 1, bid_b, False),
              (0, 1, 0, bid_b, False), (1, 1, 0, bid_a, False)]
    for i, vtype, r, bid, bad in script:
        try:
            out.append(hvs.add_vote(vote(i, vtype, r, bid, bad)))
        except P.vs.VoteSetError as e:
            out.append((type(e).__name__, str(e)))
    hvs.set_round(2)
    r_pol, maj = hvs.pol_info()
    out.append((hvs.round, r_pol, maj.hash.hex() if maj else None,
                [hvs.prevotes(r).has_two_thirds_any() for r in range(4)],
                hvs.precommits(3).size(), hvs.on_flush is not None))
    return out, flushes


def test_height_vote_set_equal():
    j, _ = _hvs_run(JAX)
    p, flushes = _hvs_run(PORT)
    assert p == j
    assert ("VoteSetError", "invalid vote: invalid signature") in p
    assert any(isinstance(o, tuple) and o[0] == "ConflictingVoteError"
               for o in p)
    assert flushes == []  # no plane ran


def test_height_vote_set_on_a_device_verifies_with_verify_batch_direct(
        monkeypatch):
    from cometbft_tpu_torch.crypto import batch as pbatch

    calls = []
    real = pbatch.verify_batch_direct

    def spy(pubs, msgs, sigs, device=None, **kw):
        calls.append((len(pubs), str(device)))
        return real(pubs, msgs, sigs, device=device, **kw)

    monkeypatch.setattr(pbatch, "verify_batch_direct", spy)
    j, _ = _hvs_run(JAX)
    p, _ = _hvs_run(PORT, device="cpu")
    assert p == j
    # every vote that reached verification: not the exact duplicate, not
    # the round past the bound
    assert calls == [(1, "cpu")] * 6


# -- a DeviceError is not an invalid vote -------------------------------------


def test_device_error_from_add_vote_is_not_an_invalid_vote(caplog, capfd):
    from cometbft_tpu_torch.libs import failpoints as fp
    from cometbft_tpu_torch.verifyplane import (VerifyPlane,
                                                set_global_plane)

    m = Machine(PORT, 150)
    cs = ConsensusStateRunner(m)
    from cometbft_tpu_torch.crypto.batch import CircuitBreaker

    plane = VerifyPlane(device="cpu",
                        breaker=CircuitBreaker(name="consensus-test"))
    plane.start()
    set_global_plane(plane)
    bid = PORT.bid.BlockID(b"\xcc" * 32,
                           PORT.bid.PartSetHeader(1, b"\x03" * 32))
    fp.reset()
    fp.arm("verifyplane.dispatch", "raise", count=1)
    try:
        with caplog.at_level(logging.WARNING):
            cs.start()
            cs.vote(m.others[0], bid)
            assert cs.wait(lambda: fp.registry().stats(
                "verifyplane.dispatch")["fires"] == 1
                and m.cs.msg_queue.empty())
            time.sleep(0.2)
            first, second = (m.vs.get_by_address(p.pub_key().address())[0]
                             for p in m.others[:2])
            assert m.cs.votes.prevotes(0).get_by_index(first) is None
            assert m.cs.is_running() and m.cs._thread.is_alive()
            cs.vote(m.others[1], bid)
            assert cs.wait(lambda: m.cs.votes.prevotes(0).get_by_index(
                second) is not None, timeout=120)
            assert m.cs.votes.prevotes(0).get_by_index(first) is None
    finally:
        fp.reset()
        set_global_plane(None)
        m.cs.stop()
        plane.stop()
    assert "dropped invalid vote" not in caplog.text
    assert "DeviceError" in capfd.readouterr().err
    recs = plane.ledger.records()
    assert [r["path"] for r in recs][:1] == ["device_fault"]


class ConsensusStateRunner:
    """Runs a Machine's ConsensusState on its own receive routine (no
    privval, so it signs nothing) and feeds it peer prevotes."""

    def __init__(self, m):
        self.m = m
        m.cs.privval = None
        m.cs._started = False

    def start(self):
        self.m.cs.start()

    def vote(self, priv, bid):
        P = self.m.P
        addr = priv.pub_key().address()
        idx, _ = self.m.vs.get_by_address(addr)
        v = P.vote.Vote(vote_type=P.canon.PREVOTE_TYPE, height=1, round=0,
                        block_id=bid, timestamp=P.ts.Timestamp(NOW, 0),
                        validator_address=addr, validator_index=idx)
        v.signature = priv.sign(v.sign_bytes(CHAIN))
        self.m.cs.receive_vote(v)

    @staticmethod
    def wait(cond, timeout=30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if cond():
                return True
            time.sleep(0.01)
        return False
