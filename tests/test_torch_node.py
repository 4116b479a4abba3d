"""The port's Node and LocalNetwork (cometbft_tpu_torch/node/node.py), in
one process, against the JAX package's.

tests/test_consensus.py's four non-slow scenarios run on port nodes over
a host verify plane (VerifyPlane(use_device=False): the JAX semantics,
every signature on the host), node 0's plane the global one the others
ride; the 100-block one is the slow counterpart. A chain the port's
4-node network wrote is opened by the JAX package's BlockStore and
StateStore: the JAX package's verify_commit (host path) accepts every
stored commit against its validator set and recomputes every block hash
equal to the port's; the same holds the other way round for a JAX
network's files. A port node resumes over a JAX node's home (stores, WAL
and FilePV state) and the reverse. tests/test_vote_ext.py's network
scenarios (:116, :149), tests/test_mempool_time.py and
tests/test_evidence.py:215 run on port nodes. Then the port's seams: one
plane in one process (a second node's plane replaces the global one, as
in the JAX package), Node() with no card raises, a plane-less
one-validator Node(device="cpu") verifies every vote through
verify_batch_direct(device="cpu"), and a [lightgate] config mounts
LightGateway.for_node, through which a light client verifies the
node's heights."""
import hashlib
import importlib
import json
import threading
import time
import urllib.request
from types import SimpleNamespace

import pytest
import torch

MODULES = {"kv": "abci.kvstore", "abci": "abci.types",
           "ticker": "consensus.ticker", "keys": "crypto.keys",
           "node": "node.node", "pv": "privval.file_pv",
           "state": "state.state", "bs": "store.blockstore",
           "val": "types.validator", "validation": "types.validation",
           "vp": "verifyplane", "ts": "types.timestamp",
           "canon": "types.canonical", "bid": "types.block_id",
           "vote": "types.vote", "params": "types.params",
           "evidence": "types.evidence", "block": "types.block",
           "mempool": "mempool.mempool", "commit": "types.commit",
           "bft": "types.bft_time"}


def _pkg(base):
    return SimpleNamespace(name=base, **{
        k: importlib.import_module(f"{base}.{m}")
        for k, m in MODULES.items()})


JAX = _pkg("cometbft_tpu")
PORT = _pkg("cometbft_tpu_torch")


def fast(P):
    return P.ticker.TimeoutParams(
        propose=0.4, propose_delta=0.1, prevote=0.2, prevote_delta=0.1,
        precommit=0.2, precommit_delta=0.1, commit=0.01)


def make_genesis(P, n_vals, chain_id="test-chain", key_base=1, **kw):
    privs = [P.keys.PrivKey.generate(bytes([i + key_base]) * 32)
             for i in range(n_vals)]
    vals = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10)
                               for p in privs])
    return P.state.State.make_genesis(chain_id, vals, **kw), privs


def node_kw(P, i, plane=True):
    """The package's node arguments: the JAX node as its tests build it;
    the port's on device="cpu", node 0 owning a host plane."""
    if P is JAX:
        return {}
    return {"device": "cpu",
            "verify_plane": (PORT.vp.VerifyPlane(use_device=False)
                             if plane and i == 0 else None)}


def network(P, tmp_path, privs, state, app=None, name="n"):
    net = P.node.LocalNetwork()
    for i, priv in enumerate(privs):
        net.add(P.node.Node(
            (app or P.kv.KVStoreApplication)(), state.copy(),
            privval=P.pv.FilePV(priv), home=str(tmp_path / f"{name}{i}"),
            broadcast=net.broadcaster(i), timeouts=fast(P),
            **node_kw(P, i)))
    for n in net.nodes:
        n.start()
    return net


def stop(nodes):
    """Node 0, the plane's owner, last."""
    for n in reversed(nodes):
        n.stop()


def single(P, tmp_path, priv, state, app=None, name="n0"):
    return P.node.Node(app or P.kv.KVStoreApplication(), state,
                       privval=P.pv.FilePV(priv),
                       home=str(tmp_path / name), timeouts=fast(P),
                       **node_kw(P, 0))


# -- tests/test_consensus.py on the port --------------------------------------


def test_single_node_produces_blocks(tmp_path):
    state, privs = make_genesis(PORT, 1)
    node = single(PORT, tmp_path, privs[0], state)
    node.start()
    try:
        assert node.consensus.wait_for_height(3, timeout=30)
        node.broadcast_tx(b"alpha=1")
        assert node.consensus.wait_for_height(node.height() + 2, timeout=30)
        assert node.query(b"alpha").value == b"1"
        assert node.consensus.state.app_hash != b""
        assert node.verify_plane.rows_verified > 0
    finally:
        node.stop()


def test_four_validator_network(tmp_path):
    state, privs = make_genesis(PORT, 4)
    net = network(PORT, tmp_path, privs, state)
    nodes = net.nodes
    try:
        assert PORT.vp.global_plane() is nodes[0].verify_plane
        nodes[0].broadcast_tx(b"k=v")
        for n in nodes:
            assert n.consensus.wait_for_height(5, timeout=60), \
                f"node stuck at {n.height()}"
        assert len({n.block_store.load_block(3).hash() for n in nodes}) == 1
        assert all(n.query(b"k").value == b"v" for n in nodes)
    finally:
        stop(nodes)
    lanes = nodes[0].verify_plane.stats()["lane_rows"]
    assert lanes["consensus"] > 0


def test_wal_crash_replay(tmp_path):
    state, privs = make_genesis(PORT, 1)
    node = single(PORT, tmp_path, privs[0], state)
    node.start()
    assert node.consensus.wait_for_height(3, timeout=30)
    node.broadcast_tx(b"persist=me")
    assert node.consensus.wait_for_height(node.height() + 2, timeout=30)
    crash_height = node.height()
    node.stop()
    node2 = single(PORT, tmp_path, privs[0], state)
    assert node2.height() >= crash_height
    node2.start()
    try:
        assert node2.query(b"persist").value == b"me"
        assert node2.consensus.wait_for_height(crash_height + 2, timeout=30)
    finally:
        node2.stop()


class CommitInfoApp(PORT.kv.KVStoreApplication):
    """tests/test_consensus.py's CommitInfoApp over the port's kvstore:
    its state hashes FinalizeBlock's CommitInfo and misbehavior."""

    def finalize_block(self, req):
        resp = super().finalize_block(req)
        dlc = req.decided_last_commit
        blob = json.dumps({
            "votes": [(v.validator_address.hex(), v.power, v.block_id_flag)
                      for v in dlc.votes] if dlc else None,
            "round": dlc.round if dlc else -1,
            "misbehavior": [(m.type, m.validator_address.hex(), m.height)
                            for m in (req.misbehavior or [])],
        }, sort_keys=True).encode()
        self.staged[b"ci:%08d" % req.height] = \
            hashlib.sha256(blob).hexdigest()[:16].encode()
        self._pending_hash = self._computed_staged_hash(req.height)
        resp.app_hash = self._pending_hash
        return resp


def test_replay_feeds_identical_commit_info(tmp_path):
    state, privs = make_genesis(PORT, 1)
    app = CommitInfoApp()
    node = single(PORT, tmp_path, privs[0], state, app)
    node.start()
    assert node.consensus.wait_for_height(4, timeout=30)
    node.broadcast_tx(b"ci=live")
    assert node.consensus.wait_for_height(node.height() + 2, timeout=30)
    crash_height = node.height()
    live_hash = app.app_hash
    live_state_hash = node.consensus.state.app_hash
    node.stop()
    app2 = CommitInfoApp()
    node2 = single(PORT, tmp_path, privs[0], state, app2)
    assert app2.height >= crash_height
    assert app2.app_hash == live_hash
    assert node2.consensus.state.app_hash == live_state_hash
    node2.start()
    try:
        assert node2.consensus.wait_for_height(crash_height + 2, timeout=30)
    finally:
        node2.stop()


@pytest.mark.slow
def test_hundred_blocks(tmp_path):
    state, privs = make_genesis(PORT, 1)
    node = single(PORT, tmp_path, privs[0], state)
    node.start()
    try:
        assert node.consensus.wait_for_height(100, timeout=300)
        assert node.block_store.load_block(100) is not None
        assert node.block_store.load_seen_commit(100) is not None
    finally:
        node.stop()


# -- one package's chain, the other's stores and verification -----------------


def _run_chain(P, tmp_path, heights=5):
    state, privs = make_genesis(P, 4, chain_id="cross-chain",
                                key_base=30)
    net = network(P, tmp_path, privs, state, name=P.name)
    try:
        for i, n in enumerate(net.nodes):
            n.broadcast_tx(b"x%d=%s" % (i, P.name.encode()))
        for n in net.nodes:
            assert n.consensus.wait_for_height(heights, timeout=60)
    finally:
        stop(net.nodes)
    return str(tmp_path / f"{P.name}0"), net.nodes[0]


@pytest.mark.parametrize("writer,reader", [(PORT, JAX), (JAX, PORT)],
                         ids=["port_chain_jax_reads", "jax_chain_port_reads"])
def test_chain_read_and_verified_by_the_other_package(tmp_path, writer,
                                                      reader):
    home, wnode = _run_chain(writer, tmp_path)
    blocks = reader.bs.BlockStore(f"{home}/blockstore.db")
    states = reader.state.StateStore(f"{home}/state.db")
    wblocks = writer.bs.BlockStore(f"{home}/blockstore.db")
    top = blocks.height()
    assert top >= 5 and states.load().last_block_height == top
    batch_fn = (None if reader is JAX
                else PORT.validation.oracle_batch_fn())
    for h in range(1, top + 1):
        blk, commit = blocks.load_block(h), blocks.load_seen_commit(h)
        assert blk.hash() == wblocks.load_block(h).hash()
        assert commit.block_id.hash == blk.hash()
        vals = states.load_validators(h)
        reader.validation.verify_commit(
            "cross-chain", vals, commit.block_id, h, commit,
            batch_fn=batch_fn)
        if h > 1:
            assert blk.last_commit.block_id.hash == \
                blocks.load_block(h - 1).hash()
    # a tampered commit is refused by the reader
    commit = blocks.load_seen_commit(2)
    i = next(k for k, cs in enumerate(commit.signatures) if cs.for_block())
    sig = commit.signatures[i].signature
    commit.signatures[i].signature = bytes([sig[0] ^ 1]) + sig[1:]
    with pytest.raises(reader.validation.VerificationError):
        reader.validation.verify_commit(
            "cross-chain", states.load_validators(2), commit.block_id, 2,
            commit, batch_fn=batch_fn)
    for s in (blocks, states, wblocks):
        s.close()


@pytest.mark.parametrize("first,second", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_home_port_resumes",
                              "port_home_jax_resumes"])
def test_node_resumes_over_the_other_packages_home(tmp_path, first, second):
    """Stores, WAL and FilePV state written by one package's node; the
    other package's node over the same home replays and commits on."""
    states = {P.name: make_genesis(P, 1, chain_id="resume-chain",
                                   key_base=70) for P in (first, second)}
    state, privs = states[first.name]
    node = first.node.Node(
        first.kv.KVStoreApplication(), state,
        privval=first.pv.FilePV.generate(str(tmp_path / "pv"),
                                         seed=bytes([70]) * 32),
        home=str(tmp_path / "home"), timeouts=fast(first),
        **node_kw(first, 0))
    node.start()
    try:
        assert node.consensus.wait_for_height(3, timeout=30)
        node.broadcast_tx(b"resume=yes")
        assert node.consensus.wait_for_height(node.height() + 2, timeout=30)
    finally:
        node.stop()
    h = node.height()
    state2, _ = states[second.name]
    app2 = second.kv.KVStoreApplication()
    node2 = second.node.Node(
        app2, state2, privval=second.pv.FilePV.load(str(tmp_path / "pv")),
        home=str(tmp_path / "home"), timeouts=fast(second),
        **node_kw(second, 0))
    assert node2.height() == h
    assert app2.app_hash == node2.consensus.state.app_hash
    node2.start()
    try:
        assert node2.query(b"resume").value == b"yes"
        assert node2.consensus.wait_for_height(h + 2, timeout=30)
    finally:
        node2.stop()


# -- tests/test_vote_ext.py :116 and :149 on the port -------------------------


class ExtensionApp(PORT.kv.KVStoreApplication):
    def __init__(self):
        super().__init__()
        self.seen_local_last_commits = []
        self._elock = threading.Lock()

    def extend_vote(self, req):
        return PORT.abci.ResponseExtendVote(
            vote_extension=b"ext@%d" % req.height)

    def verify_vote_extension(self, req):
        ok = req.vote_extension == b"ext@%d" % req.height
        return PORT.abci.ResponseVerifyVoteExtension(
            status=PORT.abci.VERIFY_VOTE_EXTENSION_ACCEPT if ok
            else PORT.abci.VERIFY_VOTE_EXTENSION_REJECT)

    def prepare_proposal(self, req):
        with self._elock:
            if req.local_last_commit is not None:
                self.seen_local_last_commits.append(
                    (req.height, req.local_last_commit))
        return super().prepare_proposal(req)


def _ext_genesis(n):
    params = PORT.params.ConsensusParams(
        abci=PORT.params.ABCIParams(vote_extensions_enable_height=1))
    return make_genesis(PORT, n, chain_id="ext-chain", params=params)


def test_empty_extensions_still_progress(tmp_path):
    state, privs = _ext_genesis(2)
    net = network(PORT, tmp_path, privs, state, name="e")
    try:
        for n in net.nodes:
            assert n.consensus.wait_for_height(3, timeout=60), n.height()
        ec = net.nodes[0].block_store.load_extended_commit(2)
        assert ec is not None
        assert all(e.extension == b"" and e.extension_signature
                   for e in ec.extended_signatures
                   if e.commit_sig.is_commit())
    finally:
        stop(net.nodes)


def test_extensions_flow_through_network(tmp_path):
    state, privs = _ext_genesis(4)
    vs = state.validators
    net = network(PORT, tmp_path, privs, state, app=ExtensionApp)
    apps = [n.consensus.block_exec.app for n in net.nodes]
    try:
        for n in net.nodes:
            assert n.consensus.wait_for_height(4, timeout=60), n.height()
        ec = net.nodes[0].block_store.load_extended_commit(2)
        assert ec is not None
        n_with_ext = 0
        for i, e in enumerate(ec.extended_signatures):
            if not e.commit_sig.is_commit():
                continue
            assert e.extension == b"ext@2"
            v = ec.get_extended_vote(i)
            _, val = vs.get_by_address(e.commit_sig.validator_address)
            v.verify_extension("ext-chain", val.pub_key)
            n_with_ext += 1
        assert n_with_ext >= 3
    finally:
        stop(net.nodes)
    seen = [(h, llc) for conn in apps
            for (h, llc) in conn._app.seen_local_last_commits]
    assert seen, "no proposer ever received local_last_commit"
    h, llc = seen[0]
    exts = [v.vote_extension for v in llc.votes
            if v.block_id_flag == 2 and v.vote_extension]
    assert exts and all(x == b"ext@%d" % (h - 1) for x in exts)


# -- tests/test_mempool_time.py on the port -----------------------------------


def _one_shot(P):
    class OneShotApp(P.kv.KVStoreApplication):
        def check_tx(self, req):
            key = req.tx.split(b"=", 1)[0]
            if self.query(P.abci.RequestQuery(data=key)).value:
                return P.abci.ResponseCheckTx(code=7, log="key already set")
            return P.abci.ResponseCheckTx(code=P.abci.CODE_TYPE_OK)

    return OneShotApp()


def _recheck(P):
    app = _one_shot(P)
    mp = P.mempool.Mempool(app)
    out = [mp.check_tx(b"k=1").code, mp.check_tx(b"k=2").code, mp.size()]
    app.finalize_block(P.abci.RequestFinalizeBlock(
        txs=[b"k=1"], height=1, hash=b"", proposer_address=b"",
        time_seconds=0))
    app.commit()
    mp.update(1, [b"k=1"])
    out += [mp.size(), mp.check_tx(b"k=2").code]
    return out


def test_mempool_recheck_drops_stale():
    assert _recheck(PORT) == _recheck(JAX) == [0, 0, 2, 0, 7]


def _median(P):
    vals = P.val.ValidatorSet([
        P.val.Validator(P.keys.PrivKey.generate(bytes([i + 5]) * 32)
                        .pub_key(), p) for i, p in enumerate((1, 1, 10))])
    bid = P.bid.BlockID(b"\x01" * 32, P.bid.PartSetHeader(1, b"\x02" * 32))
    by_power = sorted(range(3), key=lambda i: vals.validators[i].voting_power)
    secs = {by_power[0]: 100, by_power[1]: 200, by_power[2]: 300}
    sigs = [P.commit.CommitSig(P.commit.BLOCK_ID_FLAG_COMMIT,
                               vals.validators[i].address,
                               P.ts.Timestamp(secs[i], 0), b"s" * 64)
            for i in range(3)]
    out = [P.bft.median_time(P.commit.Commit(5, 0, bid, sigs), vals)]
    sigs[by_power[2]] = P.commit.CommitSig.absent()
    out.append(P.bft.median_time(P.commit.Commit(5, 0, bid, sigs), vals))
    return [(t.seconds, t.nanos) for t in out]


def test_median_time_weighted():
    assert _median(PORT) == _median(JAX)
    assert _median(PORT)[0] == (300, 0)


def test_concurrent_hammer(tmp_path):
    """Garbage votes from 3 threads into a live 4-node port network: no
    deadlock, no stall, no crash; the prefilter drops them before any
    WAL write or verification."""
    state, privs = make_genesis(PORT, 4, chain_id="hammer-chain")
    net = network(PORT, tmp_path, privs, state)
    nodes = net.nodes
    stop_ev = threading.Event()

    def hammer(seed):
        bid = PORT.bid.BlockID(bytes([seed]) * 32,
                               PORT.bid.PartSetHeader(1, b"\x0a" * 32))
        k = 0
        while not stop_ev.is_set():
            k += 1
            v = PORT.vote.Vote(
                vote_type=PORT.canon.PREVOTE_TYPE,
                height=nodes[0].consensus.height, round=0, block_id=bid,
                timestamp=PORT.ts.Timestamp(1_700_000_000 + k, 0),
                validator_address=bytes([seed]) * 20,
                validator_index=k % 7)
            v.signature = b"\x11" * 64
            for n in nodes:
                n.consensus.receive_vote(v)
            time.sleep(0.002)

    threads = [threading.Thread(target=hammer, args=(40 + i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    try:
        start_h = nodes[0].height()
        assert nodes[0].consensus.wait_for_height(start_h + 4, timeout=90)
    finally:
        stop_ev.set()
        for t in threads:
            t.join(timeout=5)
        stop(nodes)
    assert all(n.consensus.prefilter_drops > 0 for n in nodes)


# -- tests/test_evidence.py:215 on the port -----------------------------------


def test_double_signer_evidence_committed(tmp_path):
    state, privs = make_genesis(PORT, 4, chain_id="byz-chain")
    vals = state.validators
    net = network(PORT, tmp_path, privs, state)
    nodes = net.nodes
    try:
        byz = privs[3]
        assert nodes[0].consensus.wait_for_height(2, timeout=60)
        h = nodes[0].consensus.height
        addr = byz.pub_key().address()
        idx, _ = vals.get_by_address(addr)
        votes = []
        for tag in (b"\xaa", b"\xbb"):
            v = PORT.vote.Vote(
                vote_type=PORT.canon.PREVOTE_TYPE, height=h, round=0,
                block_id=PORT.bid.BlockID(tag * 32, PORT.bid.PartSetHeader(
                    1, tag * 32)),
                timestamp=PORT.ts.Timestamp(1_700_000_100, 0),
                validator_address=addr, validator_index=idx)
            v.signature = byz.sign(v.sign_bytes("byz-chain"))
            votes.append(v)
        for n in nodes:
            for v in votes:
                n.consensus.receive_vote(v)
        deadline = time.time() + 60
        found = None
        while time.time() < deadline and found is None:
            time.sleep(0.2)
            for hh in range(max(1, h - 1), nodes[0].height() + 1):
                blk = nodes[0].block_store.load_block(hh)
                if blk is not None and blk.evidence:
                    found = (hh, blk)
                    break
        assert found is not None, "no block carried the evidence"
        hh, blk = found
        assert blk.header.evidence_hash == \
            PORT.block.evidence_hash(blk.evidence)
        assert blk.evidence[0].vote_a.validator_address == addr
        for n in nodes:
            assert n.consensus.wait_for_height(hh, timeout=60)
            b2 = n.block_store.load_block(hh)
            assert b2 is not None and b2.evidence
            assert b2.header.evidence_hash == blk.header.evidence_hash
    finally:
        stop(nodes)


# -- the port's seams ---------------------------------------------------------


def _second_plane_run(P, tmp_path):
    """Two nodes of one network, each with its own plane: the second
    node's start replaces the global plane (set_global_plane)."""
    state, privs = make_genesis(P, 2, chain_id="planes", key_base=90)
    net = P.node.LocalNetwork()
    planes = []
    for i, priv in enumerate(privs):
        plane = P.vp.VerifyPlane(use_device=False)
        planes.append(plane)
        kw = {"device": "cpu"} if P is PORT else {}
        net.add(P.node.Node(
            P.kv.KVStoreApplication(), state.copy(),
            privval=P.pv.FilePV(priv), home=str(tmp_path / f"{P.name}{i}"),
            broadcast=net.broadcaster(i), timeouts=fast(P),
            verify_plane=plane, **kw))
    seen = []
    for n in net.nodes:
        n.start()
        seen.append(planes.index(P.vp.global_plane()))
    try:
        for n in net.nodes:
            assert n.consensus.wait_for_height(2, timeout=60)
    finally:
        net.nodes[1].stop()
        seen.append(P.vp.global_plane())
        net.nodes[0].stop()
    seen.append(P.vp.global_plane())
    return seen, [p.stats()["lane_rows"]["consensus"] > 0 for p in planes]


def test_one_plane_in_one_process(tmp_path):
    """Trap (f): a second node with its own plane takes the global slot
    from node 0's; the port keeps the JAX behaviour."""
    j, p = _second_plane_run(JAX, tmp_path), _second_plane_run(PORT,
                                                               tmp_path)
    assert p == j
    assert p[0] == [0, 1, None, None]
    assert p[1][1]  # the last mounted plane served the votes


def test_node_without_a_card_raises(tmp_path, monkeypatch):
    from cometbft_tpu_torch.device import DeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state, privs = make_genesis(PORT, 1)
    with pytest.raises(DeviceError):
        PORT.node.Node(PORT.kv.KVStoreApplication(), state,
                       privval=PORT.pv.FilePV(privs[0]),
                       home=str(tmp_path / "n"))
    # p2p=True builds the switch and its reactors; rpc_listen serves the
    # JSON-RPC server over the node
    node = PORT.node.Node(PORT.kv.KVStoreApplication(), state, p2p=True,
                          device="cpu")
    assert node.switch is not None and node.consensus_reactor is not None
    assert node.blocksync_reactor is not None
    url = node.rpc_listen()
    try:
        with urllib.request.urlopen(f"{url}/health", timeout=10) as r:
            assert json.loads(r.read())["result"] == {}
        with urllib.request.urlopen(f"{url}/status", timeout=10) as r:
            st = json.loads(r.read())["result"]
        assert st["node_info"]["network"] == state.chain_id
        assert st["node_info"]["version"] == "cometbft-tpu/0.3"
    finally:
        node.rpc_server.stop()
    node.block_store.close()
    node.state_store.close()


def test_planeless_cpu_node_verifies_votes_on_its_device(tmp_path,
                                                          monkeypatch):
    """No plane: each vote is one verify_batch_direct(device="cpu") call
    (the plain kernel). On the host: the proposal's signature
    (consensus/state.py's named site) and the one-signature LastCommit,
    which validation's batch threshold (two signatures, as in the JAX
    package) sends to its single-verify loop."""
    SITES = ("_set_proposal", "_note_straggler", "_try_add_vote",
             "_verify_single")
    from cometbft_tpu_torch.crypto import batch as pbatch
    from cometbft_tpu_torch.crypto import ed25519_ref

    calls, host = [], []
    real, real_ref = pbatch.verify_batch_direct, ed25519_ref.verify

    def spy(pubs, msgs, sigs, device=None, **kw):
        calls.append((len(pubs), str(device)))
        return real(pubs, msgs, sigs, device=device, **kw)

    def ref(*a, **kw):
        import sys

        f = sys._getframe(1)
        while f is not None and f.f_code.co_name not in SITES:
            f = f.f_back
        host.append(f.f_code.co_name if f is not None else "elsewhere")
        return real_ref(*a, **kw)

    monkeypatch.setattr(pbatch, "verify_batch_direct", spy)
    monkeypatch.setattr(ed25519_ref, "verify", ref)
    state, privs = make_genesis(PORT, 1)
    node = PORT.node.Node(PORT.kv.KVStoreApplication(), state,
                          privval=PORT.pv.FilePV(privs[0]),
                          home=str(tmp_path / "n"), timeouts=fast(PORT),
                          device="cpu")
    assert node.verify_plane is None and PORT.vp.global_plane() is None
    node.start()
    try:
        assert node.consensus.wait_for_height(2, timeout=120)
    finally:
        node.stop()
    assert node.device == torch.device("cpu")
    votes = 2 * node.height()
    assert len(calls) >= votes and set(calls) == {(1, "cpu")}
    assert set(host) == {"_set_proposal", "_verify_single"}


def test_lightgate_config_mounts_a_gateway_on_the_node(tmp_path):
    """[lightgate] enable = true: the node builds LightGateway.for_node
    (its stores, evidence pool and own chain as the root); a light client
    verifies the node's heights through it, the commits' signatures on
    the plane's GATEWAY lane."""
    from cometbft_tpu_torch.config.config import LightGateConfig
    from cometbft_tpu_torch.lightgate import gateway as pgw

    state, privs = make_genesis(PORT, 2, chain_id="gate-chain")
    net = PORT.node.LocalNetwork()
    for i, priv in enumerate(privs):
        net.add(PORT.node.Node(
            PORT.kv.KVStoreApplication(), state.copy(),
            privval=PORT.pv.FilePV(priv), home=str(tmp_path / f"g{i}"),
            broadcast=net.broadcaster(i), timeouts=fast(PORT),
            lightgate=LightGateConfig(enable=True, cache_size=8)
            if i == 0 else None, **node_kw(PORT, i)))
    node = net.nodes[0]
    gw = node.lightgate
    assert isinstance(gw, pgw.LightGateway) and net.nodes[1].lightgate is None
    for n in net.nodes:
        n.start()
    try:
        assert pgw.last_gateway() is gw
        assert node.consensus.wait_for_height(3, timeout=30)
        # the first call roots the gateway on the node's tip (below it,
        # heights verify by hash); the next heights verify forward, their
        # commits' signatures checked
        assert gw.verify(1, 2)["status"] == "verified"
        root = gw.client.store.latest().height
        assert node.consensus.wait_for_height(root + 3, timeout=30)
        out = gw.verify(root, root + 3)
        again = gw.verify(root, root + 3)
        hdr = node.block_store.load_block(root + 3).header
        assert out["status"] == "verified" and out["height"] == root + 3
        assert out["target_hash"] == hdr.hash().hex()
        assert again["cached"]
        st = gw.stats()
        assert st["verifies"] >= 1 and st["cache"]["hits"] >= 1
        assert node.verify_plane.stats()["lane_rows"]["gateway"] > 0
    finally:
        stop(net.nodes)
    assert not gw.is_running()
