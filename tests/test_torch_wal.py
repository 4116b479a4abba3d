"""The port's consensus WAL (cometbft_tpu_torch/consensus/wal.py) and WAL
generator against the JAX package's, and tests/test_wal_recovery.py's
scenarios on the port.

For the same scripted records (raw frames, synced frames, ENDHEIGHT
marks with a head rotation) and the same consensus messages (a vote, a
proposal with its block, a timeout, through ConsensusState._wal_write)
both packages write equal WAL bytes, and each package decodes, searches
and repairs the other's WAL alike (wal_to_json included). Then the
recovery matrix on the port: a single-validator node over a host plane
killed at every WAL and consensus failpoint (SimulatedCrash) restarts
over its home with the app hash its replay agrees with and commits on;
a crash mid-rotation, a corrupt tail, a truncation sweep over a
wal_generator WAL and a node resuming on a torn WAL, as in the JAX
package's tests."""
import importlib
import os
import struct
import time
from types import SimpleNamespace

import pytest

MODULES = {"wal": "consensus.wal", "gen": "consensus.wal_generator",
           "cs": "consensus.state", "ticker": "consensus.ticker",
           "fp": "libs.failpoints", "kv": "abci.kvstore",
           "keys": "crypto.keys", "pv": "privval.file_pv",
           "ex": "state.execution", "state": "state.state",
           "val": "types.validator", "vote": "types.vote",
           "bid": "types.block_id", "ts": "types.timestamp",
           "commit": "types.commit", "proposal": "types.proposal"}


def _pkg(base):
    return SimpleNamespace(name=base, **{
        k: importlib.import_module(f"{base}.{m}")
        for k, m in MODULES.items()})


JAX = _pkg("cometbft_tpu")
PORT = _pkg("cometbft_tpu_torch")
CHAIN = "wal-chain"
T0 = 1_700_000_000

CRASH_POINTS = [
    "wal.pre_write", "wal.post_write", "wal.pre_fsync",
    "consensus.wal.pre_vote", "consensus.wal.post_vote",
    "consensus.wal.pre_proposal", "consensus.wal.post_proposal",
    "consensus.pre_finalize", "consensus.post_block_save",
]


@pytest.fixture(autouse=True)
def clean_failpoints():
    for P in (JAX, PORT):
        P.fp.reset()
        P.fp.set_crash_handler(P.fp.simulated_crash)
    yield
    for P in (JAX, PORT):
        P.fp.reset()
        P.fp.set_crash_handler(None)


# -- equal bytes, cross reads -------------------------------------------------


def _scripted_wal(P, path):
    w = P.wal.WAL(path, head_size_limit=96, max_segments=3)
    for h in range(1, 6):
        w.write(P.wal.MSG_INFO, b"msg-%d" % h)
        w.write_sync(P.wal.TIMEOUT_INFO, struct.pack(">qii", h, 0, 3))
        w.write_sync(P.wal.EVENT, b"e" * (10 * h))
        w.write_end_height(h)
    w.close()
    return w


class _Stub:
    def __init__(self, wal):
        self.wal = wal


def _consensus_records(P, path):
    """A vote, a proposal with its block and a timeout through the
    consensus WAL writer, then ENDHEIGHT(1)."""
    privs = [P.keys.PrivKey.generate(bytes([i + 90]) * 32)
             for i in range(2)]
    vals = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10)
                               for p in privs])
    state = P.state.State.make_genesis(
        CHAIN, vals, genesis_time=P.ts.Timestamp(T0, 0))
    ex = P.ex.BlockExecutor(P.kv.KVStoreApplication(),
                            P.state.StateStore(":memory:"),
                            **({} if P is JAX else {
                                "batch_fn": lambda *a: None}))
    block = ex.create_proposal_block(
        1, state, P.commit.Commit(0, 0, P.bid.BlockID(), []),
        vals.get_proposer().address, txs=[b"w=1"])
    bid = block.block_id()
    prop = P.proposal.Proposal(1, 0, -1, bid, P.ts.Timestamp(T0, 5))
    prop.signature = privs[0].sign(prop.sign_bytes(CHAIN))
    addr = privs[1].pub_key().address()
    vote = P.vote.Vote(vote_type=1, height=1, round=0, block_id=bid,
                       timestamp=P.ts.Timestamp(T0 + 1, 9),
                       validator_address=addr,
                       validator_index=vals.get_by_address(addr)[0])
    vote.signature = privs[1].sign(vote.sign_bytes(CHAIN))
    stub = _Stub(P.wal.WAL(path))
    write = P.cs.ConsensusState._wal_write
    write(stub, ("proposal", P.cs.ProposalMsg(prop, block)))
    write(stub, ("vote", P.cs.VoteMsg(vote)))
    write(stub, ("timeout", P.ticker.TimeoutInfo(1, 0, 3, 0.4)))
    stub.wal.write_end_height(1)
    stub.wal.close()


def _files(path):
    d = os.path.dirname(path)
    base = os.path.basename(path)
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d)) if name.startswith(base)}


@pytest.mark.parametrize("writer", [_scripted_wal, _consensus_records],
                         ids=["frames", "consensus"])
def test_equal_wal_bytes_and_cross_reads(tmp_path, writer):
    paths = {}
    for P in (JAX, PORT):
        os.makedirs(tmp_path / P.name)
        paths[P.name] = str(tmp_path / P.name / "cs.wal")
        writer(P, paths[P.name])
    jf, pf = _files(paths["cometbft_tpu"]), _files(paths["cometbft_tpu_torch"])
    assert pf == jf and pf
    for reader in (JAX, PORT):
        for path in paths.values():
            recs = [(r.kind, r.data) for r in
                    reader.wal.WAL.iter_records(path)]
            ends = [reader.wal.WAL.search_for_end_height(path, h)
                    for h in range(0, 7)]
            assert (recs, ends) == (
                [(r.kind, r.data) for r in
                 JAX.wal.WAL.iter_records(paths["cometbft_tpu"])],
                [JAX.wal.WAL.search_for_end_height(
                    paths["cometbft_tpu"], h) for h in range(0, 7)])
            assert reader.gen.wal_to_json(path) == \
                JAX.gen.wal_to_json(paths["cometbft_tpu"])


def test_repair_tail_equal_on_a_torn_wal(tmp_path):
    blobs = {}
    for P in (JAX, PORT):
        os.makedirs(tmp_path / P.name)
        path = str(tmp_path / P.name / "cs.wal")
        _scripted_wal(P, path)
        with open(path, "ab") as f:
            f.write(struct.pack(">II", 5, 40) + b"torn")
        blobs[P.name] = (P.wal.WAL.repair_tail(path), _files(path))
    assert blobs["cometbft_tpu_torch"] == blobs["cometbft_tpu"]
    assert blobs["cometbft_tpu"][0] == 12


# -- the recovery matrix on the port ------------------------------------------

FAST = PORT.ticker.TimeoutParams(
    propose=0.4, propose_delta=0.1, prevote=0.2, prevote_delta=0.1,
    precommit=0.2, precommit_delta=0.1, commit=0.01)


def _genesis(chain_id="crash-chain"):
    priv = PORT.keys.PrivKey.generate(b"\x77" * 32)
    vals = PORT.val.ValidatorSet([PORT.val.Validator(priv.pub_key(), 10)])
    return PORT.state.State.make_genesis(chain_id, vals), priv


def _node(state, priv, home, app=None):
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.verifyplane import VerifyPlane

    return Node(app or PORT.kv.KVStoreApplication(), state,
                privval=PORT.pv.FilePV(priv), home=home, timeouts=FAST,
                device="cpu", verify_plane=VerifyPlane(use_device=False))


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_kill_at_failpoint_then_recover(tmp_path, point):
    fp = PORT.fp
    state, priv = _genesis()
    home = str(tmp_path / "n0")
    node = _node(state, priv, home)
    node.start()
    try:
        assert node.consensus.wait_for_height(2, timeout=30)
        fp.arm(point, "crash", count=1)
        deadline = time.time() + 30
        while not node.consensus.crashed:
            assert time.time() < deadline, f"failpoint {point} never fired"
            time.sleep(0.01)
    finally:
        fp.reset()
        node.stop()
    app2 = PORT.kv.KVStoreApplication()
    node2 = _node(state, priv, home, app2)
    persisted_h = node2.height()
    assert app2.app_hash == node2.consensus.state.app_hash, \
        f"replay diverged after crash at {point}"
    node2.start()
    try:
        assert node2.consensus.wait_for_height(persisted_h + 2, timeout=30), \
            f"node wedged after crash at {point}"
    finally:
        node2.stop()


def test_crash_mid_rotation_recovers(tmp_path):
    wal, fp = PORT.wal, PORT.fp
    path = str(tmp_path / "cs.wal")
    w = wal.WAL(path, head_size_limit=64)
    w.write_sync(wal.MSG_INFO, b"m" * 64)
    w.write_end_height(1)
    w.write_sync(wal.MSG_INFO, b"n" * 64)
    fp.arm("wal.mid_rotate", "crash", count=1)
    with pytest.raises(fp.SimulatedCrash):
        w.write_end_height(2)
    fp.reset()
    assert not os.path.exists(path)
    w2 = wal.WAL(path, head_size_limit=64)
    kinds = [r.kind for r in wal.WAL.iter_records(path)]
    assert kinds.count(wal.END_HEIGHT) == 2
    assert wal.WAL.search_for_end_height(path, 2) is not None
    w2.write_sync(wal.MSG_INFO, b"post-crash")
    w2.close()
    assert any(r.data == b"post-crash" for r in wal.WAL.iter_records(path))


def test_corrupt_tail_repaired_on_reopen(tmp_path):
    wal = PORT.wal
    path = str(tmp_path / "cs.wal")
    w = wal.WAL(path)
    for i in range(5):
        w.write_sync(wal.MSG_INFO, b"rec-%d" % i)
    w.close()
    good_size = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b"\xde\xad\xbe\xef" * 7)
    w2 = wal.WAL(path)
    assert os.path.getsize(path) == good_size
    w2.write_sync(wal.MSG_INFO, b"after-repair")
    w2.close()
    assert [r.data for r in wal.WAL.iter_records(path)] == \
        [b"rec-%d" % i for i in range(5)] + [b"after-repair"]


def test_truncation_sweep_on_generated_wal(tmp_path):
    """The port's wal_generator (its single-validator node over a host
    plane) gives a real WAL; truncated at every offset across its final
    records, both packages decode it alike and repair it to the same
    valid prefix."""
    from cometbft_tpu_torch.verifyplane import VerifyPlane

    wal = PORT.wal
    src = str(tmp_path / "gen.wal")
    PORT.gen.generate_wal(3, src, chain_id="walgen-sweep", device="cpu",
                          verify_plane=VerifyPlane(use_device=False))
    blob = open(src, "rb").read()
    recs_full = list(wal.WAL.iter_records(src))
    assert len(recs_full) >= 4
    assert [r.kind for r in recs_full].count(wal.END_HEIGHT) >= 3
    offsets = list(range(max(0, len(blob) - 160), len(blob))) + [
        len(blob) // 3, len(blob) // 2]
    for cut in offsets:
        outs = []
        for P in (JAX, PORT):
            path = str(tmp_path / f"{P.name}.wal")
            with open(path, "wb") as f:
                f.write(blob[:cut])
            recs = list(P.wal.WAL.iter_records(path))
            assert len(recs) <= len(recs_full)
            dropped = P.wal.WAL.repair_tail(path)
            again = list(P.wal.WAL.iter_records(path))
            assert len(again) == len(recs)
            assert os.path.getsize(path) == \
                P.wal.WAL._scan_valid_prefix(path)
            outs.append((dropped, [(r.kind, r.data) for r in again]))
        assert outs[0] == outs[1]


def test_node_resumes_on_truncated_wal(tmp_path):
    state, priv = _genesis("trunc-chain")
    home = str(tmp_path / "n0")
    node = _node(state, priv, home)
    node.start()
    assert node.consensus.wait_for_height(3, timeout=30)
    node.stop()
    h_before = node.height()
    wal_path = os.path.join(home, "cs.wal")
    size = os.path.getsize(wal_path)
    with open(wal_path, "r+b") as f:
        f.truncate(size - 11)
        f.seek(0, os.SEEK_END)
        f.write(b"\x00" * 64)
    app2 = PORT.kv.KVStoreApplication()
    node2 = _node(state, priv, home, app2)
    assert app2.app_hash == node2.consensus.state.app_hash
    node2.start()
    try:
        assert node2.consensus.wait_for_height(h_before + 2, timeout=30)
    finally:
        node2.stop()
    # the repaired WAL decodes to its end: every record is whole
    assert os.path.getsize(wal_path) == \
        PORT.wal.WAL._scan_valid_prefix(wal_path)
