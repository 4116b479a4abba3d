"""The port's wire against the JAX package's: byte for byte.

A secret connection between the two packages over a socket.socketpair,
in both directions, with the ephemeral X25519 keys pinned: the handshake
and every sealed frame each side writes equal a JAX-to-JAX pair's. The
same holds with `cryptography` forced off through each module's own
import gate (a fresh copy of secret_connection.py / symmetric.py loaded
while `cryptography` cannot be imported, so the pure-Python aead_ref
runs, as on the card's machine). MConnection's packets for the same
queued messages are equal, and the other package's MConnection reads
them back. The JSON of every consensus, blocksync, mempool, evidence,
PEX and statesync message, and the handshake's NodeInfo, built from the
same input by the two packages' reactors, is equal byte for byte. The
reactors are driven with recording peers and a recording switch over a
chain a JAX node wrote, which both packages' stores open. Three tests
hold where the port's consensus reactor sends more than the JAX one, to
a peer that lags (ROADMAP §C): the messages it sends are the same
forms."""
import importlib
import importlib.util
import json
import random
import socket
import sys
import threading
from types import SimpleNamespace

import pytest

import torch_mirror as tm

MODULES = {"kv": "abci.kvstore", "abci": "abci.types",
           "keys": "crypto.keys", "node": "node.node",
           "pv": "privval.file_pv", "state": "state.state",
           "bs": "store.blockstore", "val": "types.validator",
           "ts": "types.timestamp", "canon": "types.canonical",
           "bid": "types.block_id", "vote": "types.vote",
           "evidence": "types.evidence", "proposal": "types.proposal",
           "serde": "types.serde", "cs": "consensus.state",
           "ticker": "consensus.ticker", "creactor": "consensus.reactor",
           "ex": "state.execution", "mempool": "mempool.mempool",
           "mreactor": "mempool.reactor", "ereactor": "evidence.reactor",
           "bsreactor": "blocksync.p2p_reactor", "pex": "p2p.pex",
           "p2pkey": "p2p.key", "conn": "p2p.conn.connection",
           "sc": "p2p.conn.secret_connection",
           "ssreactor": "statesync.p2p_reactor"}


def _pkg(base):
    return SimpleNamespace(name=base, **{
        k: importlib.import_module(f"{base}.{m}")
        for k, m in MODULES.items()})


JAX = _pkg("cometbft_tpu")
PORT = _pkg("cometbft_tpu_torch")
BOTH = [pytest.param(JAX, id="jax"), pytest.param(PORT, id="port")]
CHAIN = "wire-chain"
GENESIS_TIME = 1_700_000_000


def _without_cryptography(base, mod):
    """A fresh copy of `base.mod` loaded while `cryptography` cannot be
    imported: its own try/except gate takes the aead_ref branch."""
    name = f"{base}.{mod}"
    spec = importlib.util.find_spec(name)
    blocked = {k: None for k in list(sys.modules)
               if k == "cryptography" or k.startswith("cryptography.")}
    blocked["cryptography"] = None
    saved = {k: sys.modules.get(k) for k in blocked}
    sys.modules.update(blocked)
    try:
        copy = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(copy)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return copy


SC = {("jax", "openssl"): JAX.sc, ("port", "openssl"): PORT.sc,
      ("jax", "aead_ref"): _without_cryptography("cometbft_tpu",
                                                  "p2p.conn.secret_connection"),
      ("port", "aead_ref"): _without_cryptography(
          "cometbft_tpu_torch", "p2p.conn.secret_connection")}


def test_gate_takes_each_branch():
    assert JAX.sc._HAVE_OPENSSL and PORT.sc._HAVE_OPENSSL
    assert not SC["jax", "aead_ref"]._HAVE_OPENSSL
    assert not SC["port", "aead_ref"]._HAVE_OPENSSL
    assert SC["port", "aead_ref"].ChaCha20Poly1305.__module__ == \
        "cometbft_tpu_torch.crypto.aead_ref"


# -- secret connection ---------------------------------------------------------


class Tap:
    """A socket that records every byte written to it."""

    def __init__(self, sock):
        self.sock = sock
        self.sent = bytearray()

    def sendall(self, data):
        self.sent += data
        self.sock.sendall(data)

    def recv(self, n):
        return self.sock.recv(n)

    def close(self):
        self.sock.close()


EPH = {"a": bytes(range(1, 33)), "b": bytes(range(33, 65))}


def _pin(sc, monkeypatch):
    """sc's X25519PrivateKey.generate() pinned: the thread named "a"
    gets EPH["a"], the thread named "b" EPH["b"]."""
    real = getattr(sc.X25519PrivateKey, "real", sc.X25519PrivateKey)

    class Pinned:
        @staticmethod
        def generate():
            seed = EPH[threading.current_thread().name]
            if hasattr(real, "from_private_bytes"):
                return real.from_private_bytes(seed)
            return real(seed)  # aead_ref's class takes the raw scalar

    Pinned.real = real
    monkeypatch.setattr(sc, "X25519PrivateKey", Pinned)


def _pkg_of(sc):
    return JAX if sc.__name__.startswith("cometbft_tpu.") else PORT


def _session(sc_a, sc_b, monkeypatch):
    """Handshake A (node key 0x01) with B (0x02), then A writes two
    messages (the second spans frames) and B one; returns each side's
    bytes on the wire and what each side read."""
    for sc in {id(sc_a): sc_a, id(sc_b): sc_b}.values():
        _pin(sc, monkeypatch)
    sa, sb = socket.socketpair()
    taps = {"a": Tap(sa), "b": Tap(sb)}
    out = {}
    plan = {"a": (sc_a, b"\x01", [b"hello", bytes(range(256)) * 9], 1),
            "b": (sc_b, b"\x02", [b"world" * 300], 2)}

    def side(name):
        sc, seed, writes, reads = plan[name]
        priv = _pkg_of(sc).keys.PrivKey.generate(seed * 32)
        conn = sc.SecretConnection.handshake(taps[name], priv)
        for w in writes:
            conn.write_msg(w)
        out[name] = (conn.remote_pub.data,
                     [conn.read_msg() for _ in range(reads)])

    threads = [threading.Thread(target=side, args=(n,), name=n)
               for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    sa.close()
    sb.close()
    assert set(out) == {"a", "b"}, "handshake did not finish"
    return bytes(taps["a"].sent), bytes(taps["b"].sent), out


@pytest.mark.parametrize("gate", ["openssl", "aead_ref"])
@pytest.mark.parametrize("a,b", [("port", "jax"), ("jax", "port"),
                                 ("port", "port")])
def test_secret_connection_bytes_equal_jax_pair(a, b, gate, monkeypatch):
    ref = _session(SC["jax", gate], SC["jax", gate], monkeypatch)
    got = _session(SC[a, gate], SC[b, gate], monkeypatch)
    assert got[0] == ref[0] and got[1] == ref[1]
    assert got[2] == ref[2]
    pa = PORT.keys.PrivKey.generate(b"\x01" * 32).pub_key().data
    pb = PORT.keys.PrivKey.generate(b"\x02" * 32).pub_key().data
    assert got[2]["a"] == (pb, [b"world" * 300])
    assert got[2]["b"] == (pa, [b"hello", bytes(range(256)) * 9])
    # 32-byte ephemeral key, then sealed 1,044-byte frames
    assert len(got[0]) == 32 + (1 + 1 + 3) * (1028 + 16)


def test_secret_connection_openssl_and_aead_ref_agree(monkeypatch):
    """An OpenSSL port node and an aead_ref port node (the card's
    machine) write the same bytes as two OpenSSL nodes."""
    ref = _session(SC["port", "openssl"], SC["port", "openssl"],
                   monkeypatch)
    got = _session(SC["port", "openssl"], SC["port", "aead_ref"],
                   monkeypatch)
    assert got[:2] == ref[:2] and got[2] == ref[2]


def test_symmetric_seal_equal_across_gates():
    """XChaCha20-Poly1305 sealing (key files) in both packages, with and
    without `cryptography`."""
    mods = [importlib.import_module("cometbft_tpu.crypto.symmetric"),
            importlib.import_module("cometbft_tpu_torch.crypto.symmetric"),
            _without_cryptography("cometbft_tpu", "crypto.symmetric"),
            _without_cryptography("cometbft_tpu_torch", "crypto.symmetric")]
    key, nonce = bytes(range(32)), bytes(range(100, 124))
    msg, aad = b"validator key material" * 20, b"aad"
    sealed = {m.XChaCha20Poly1305(key).seal(nonce, msg, aad) for m in mods}
    assert len(sealed) == 1
    for m in mods:
        assert m.XChaCha20Poly1305(key).open(nonce, sealed.pop() if False
                                             else next(iter(sealed)),
                                             aad) == msg


# -- MConnection ---------------------------------------------------------------


class Wire:
    """A SecretConnection stand-in: records each message written; reads
    from a list."""

    def __init__(self, incoming=()):
        self.written = []
        self._in = list(incoming)
        self._stream = SimpleNamespace(close=lambda: None)
        self.done = threading.Event()

    def write_msg(self, data):
        self.written.append(bytes(data))

    def read_msg(self):
        if self._in:
            return self._in.pop(0)
        self.done.set()
        raise ConnectionError("end of recording")


def _mconn_packets(P):
    chans = [P.conn.ChannelDescriptor(0x20, priority=5),
             P.conn.ChannelDescriptor(0x22, priority=10),
             P.conn.ChannelDescriptor(0x30, priority=1)]
    wire = Wire()
    mc = P.conn.MConnection(wire, chans, on_receive=lambda c, m: None)
    msgs = [(0x20, b"a" * 10), (0x22, bytes(range(256)) * 12),
            (0x30, b"x" * 1400), (0x20, b""), (0x22, b"vote"),
            (0x30, b"y" * 2801)]
    for chan, m in msgs:
        assert mc.send(chan, m)
    mc.start()
    deadline = __import__("time").time() + 10
    while sum(p[:1] == b"M" and p[2] == 1 for p in wire.written) < len(msgs):
        assert __import__("time").time() < deadline
        __import__("time").sleep(0.01)
    mc.stop()
    return [p for p in wire.written if p[:1] == b"M"], msgs


def test_mconnection_packets_equal_and_cross_read():
    jp, msgs = _mconn_packets(JAX)
    pp, _ = _mconn_packets(PORT)
    assert pp == jp
    assert all(len(p) <= 3 + 1400 for p in pp)
    # each package reads the other's packets back into the messages
    for reader, packets in ((PORT, jp), (JAX, pp)):
        got = []
        wire = Wire(packets)
        mc = reader.conn.MConnection(
            wire, [reader.conn.ChannelDescriptor(c)
                   for c in (0x20, 0x22, 0x30)],
            on_receive=lambda c, m: got.append((c, m)))
        mc.start()
        assert wire.done.wait(10)
        mc.stop()
        assert sorted(got) == sorted(msgs)


# -- reactor messages ------------------------------------------------------------


class Peer:
    def __init__(self, peer_id="peer-1"):
        self.peer_id = peer_id
        self.sent = []

    def send(self, chan, data):
        self.sent.append((chan, bytes(data)))
        return True


class Switch:
    def __init__(self, P=JAX):
        self.broadcasts = []
        self.stopped = []
        self.peer_ledger = importlib.import_module(
            f"{P.name}.p2p.peerledger").PeerLedger()
        self.peers = {}
        self._peers_lock = threading.Lock()

    def broadcast(self, chan, data):
        self.broadcasts.append((chan, bytes(data)))

    def stop_peer_for_error(self, peer, reason):
        self.stopped.append((peer.peer_id, reason))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A JAX node's 6-block single-validator chain with txs; both
    packages' stores open its files."""
    home = tmp_path_factory.mktemp("wire") / "n0"
    priv = JAX.keys.PrivKey.generate(b"\x31" * 32)
    vals = JAX.val.ValidatorSet([JAX.val.Validator(priv.pub_key(), 10)])
    state = JAX.state.State.make_genesis(
        CHAIN, vals, genesis_time=JAX.ts.Timestamp(GENESIS_TIME, 0))
    node = JAX.node.Node(
        JAX.kv.KVStoreApplication(), state, privval=JAX.pv.FilePV(priv),
        home=str(home), timeouts=JAX.ticker.TimeoutParams(
            propose=0.4, propose_delta=0.1, prevote=0.2, prevote_delta=0.1,
            precommit=0.2, precommit_delta=0.1, commit=0.01))
    node.start()
    try:
        for i in range(6):
            node.broadcast_tx(b"k%d=v%d" % (i, i))
        assert node.consensus.wait_for_height(6, timeout=60)
    finally:
        node.stop()
    return str(home)


def _store(P, home):
    return P.bs.BlockStore(home + "/blockstore.db")


def test_blocksync_messages_equal(chain):
    out = {}
    for P in (JAX, PORT):
        store = _store(P, chain)
        r = P.bsreactor.BlocksyncP2PReactor(None, store)
        r.switch = Switch()
        peer = Peer()
        r.add_peer(peer)
        for h in (1, 2, 5, 99):
            r.receive(P.bsreactor.BLOCKSYNC_CHANNEL, peer, json.dumps(
                {"t": "block_req", "h": h}).encode())
        r.receive(P.bsreactor.BLOCKSYNC_CHANNEL, peer,
                  b'{"t": "status_req"}')
        store.close()
        assert not r.switch.stopped
        out[P.name] = peer.sent
    assert out["cometbft_tpu_torch"] == out["cometbft_tpu"]
    kinds = [json.loads(m)["t"] for _, m in out["cometbft_tpu"]]
    assert kinds == ["status_req", "status", "block", "block", "block",
                     "no_block", "status"]


def _votes(P, priv, vs, h, r, vtype, bid, t):
    addr = priv.pub_key().address()
    idx, _ = vs.get_by_address(addr)
    v = P.vote.Vote(vote_type=vtype, height=h, round=r, block_id=bid,
                    timestamp=P.ts.Timestamp(t, 0), validator_address=addr,
                    validator_index=idx)
    v.signature = priv.sign(v.sign_bytes(CHAIN))
    return v


def _consensus_run(P, home, monkeypatch):
    """A manual-ticker ConsensusState at height 1 of a 4-validator
    genesis, its reactor driven by one recording peer."""
    monkeypatch.setattr(P.ts.Timestamp, "now", staticmethod(
        lambda: P.ts.Timestamp(GENESIS_TIME + 50, 0)))
    privs = [P.keys.PrivKey.generate(bytes([i + 70]) * 32)
             for i in range(4)]
    vs = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10)
                             for p in privs])
    state = P.state.State.make_genesis(
        CHAIN, vs, genesis_time=P.ts.Timestamp(GENESIS_TIME, 0))
    ex = P.ex.BlockExecutor(P.kv.KVStoreApplication(),
                            P.state.StateStore(":memory:"))
    cs = P.cs.ConsensusState(state, ex, P.bs.BlockStore(":memory:"),
                             privval=P.pv.FilePV(privs[0]),
                             manual_ticker=True)
    cs._started = True
    r = P.creactor.ConsensusReactor(cs)
    r.GOSSIP_GRACE = 0.0
    sw = Switch(P)
    r.switch = sw
    peer = Peer()
    bid = P.bid.BlockID(b"\xaa" * 32, P.bid.PartSetHeader(1, b"\xbb" * 32))
    r.receive(P.creactor.STATE_CHANNEL, peer, json.dumps(
        {"t": "step", "h": 1, "r": 0, "s": 4}).encode())
    votes = [_votes(P, p, vs, 1, 0, P.canon.PREVOTE_TYPE, bid,
                    GENESIS_TIME + 10 + i) for i, p in enumerate(privs[1:])]
    import queue

    for v in votes:
        cs._handle(("vote", P.cs.VoteMsg(v)), write_wal=False)
        while True:
            try:
                cs._handle(cs.internal_queue.get_nowait(), write_wal=False)
            except queue.Empty:
                break
        r._on_vote_added(v)
    random.seed(5)  # the gossip shuffles the lacked indices
    r._gossip_votes()
    r._announce_maj23()
    r.receive(P.creactor.STATE_CHANNEL, peer, json.dumps({
        "t": "maj23", "h": 1, "r": 0, "vt": P.canon.PREVOTE_TYPE,
        "bid": P.serde.bid_to_j(bid)}).encode())
    sw.broadcasts.append((P.creactor.STATE_CHANNEL, r._step_bytes()))
    # the proposal and its parts, and a catch-up push, over the chain
    store = _store(P, home)
    block = store.load_block(3)
    pbid = block.block_id() if hasattr(block, "block_id") else None
    prop = P.proposal.Proposal(3, 0, -1, pbid,
                               P.ts.Timestamp(GENESIS_TIME + 7, 0))
    prop.signature = privs[0].sign(prop.sign_bytes(CHAIN))
    r._broadcast_own(("proposal", P.cs.ProposalMsg(prop, block)))
    r._broadcast_own(("vote", votes[0]))
    cs.block_store = store
    r._send_catchup(peer, 4)
    store.close()
    assert not sw.stopped
    return peer.sent, sw.broadcasts


def test_consensus_messages_equal(chain, monkeypatch):
    j_sent, j_bc = _consensus_run(JAX, chain, monkeypatch)
    p_sent, p_bc = _consensus_run(PORT, chain, monkeypatch)
    assert p_sent == j_sent
    assert p_bc == j_bc
    kinds = {json.loads(m).get("t", "vote") for _, m in j_sent + j_bc}
    assert kinds >= {"vote", "has_vote", "maj23", "vsb", "step",
                     "proposal", "part", "commit_block"}


def _reactor(P, monkeypatch):
    """A manual-ticker validator's ConsensusState at height 1 of a
    4-validator genesis and its reactor on a recording switch; -> the
    reactor, the validators' keys and a step(peer, h, r) sender."""
    monkeypatch.setattr(P.ts.Timestamp, "now", staticmethod(
        lambda: P.ts.Timestamp(GENESIS_TIME + 50, 0)))
    privs = [P.keys.PrivKey.generate(bytes([i + 70]) * 32)
             for i in range(4)]
    vs = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10)
                             for p in privs])
    state = P.state.State.make_genesis(
        CHAIN, vs, genesis_time=P.ts.Timestamp(GENESIS_TIME, 0))
    ex = P.ex.BlockExecutor(P.kv.KVStoreApplication(),
                            P.state.StateStore(":memory:"))
    cs = P.cs.ConsensusState(state, ex, P.bs.BlockStore(":memory:"),
                             privval=P.pv.FilePV(privs[0]),
                             manual_ticker=True)
    r = P.creactor.ConsensusReactor(cs)
    r.switch = Switch(P)

    def step(peer, h, rnd):
        r.receive(P.creactor.STATE_CHANNEL, peer, json.dumps(
            {"t": "step", "h": h, "r": rnd, "s": 1}).encode())

    return r, privs, step


def _late_peer_run(P, home, monkeypatch):
    """Our proposal for height 1 goes out while one peer stands at
    height 0 and another at 1; then both report height 1 (the late one
    arrives, the other changes round): what each was sent directly."""
    r, privs, step = _reactor(P, monkeypatch)
    sw = r.switch
    late, level = Peer("late"), Peer("level")
    step(late, 0, 0)
    step(level, 1, 0)
    store = _store(P, home)
    block = store.load_block(1)
    store.close()
    prop = P.proposal.Proposal(1, 0, -1, block.block_id(),
                               P.ts.Timestamp(GENESIS_TIME + 7, 0))
    prop.signature = privs[0].sign(prop.sign_bytes(CHAIN))
    r._broadcast_own(("proposal", P.cs.ProposalMsg(prop, block)))
    step(late, 1, 0)
    step(late, 1, 1)
    step(level, 1, 1)
    assert not sw.stopped
    return late.sent, level.sent, sw.broadcasts


def test_a_peer_reaching_our_height_gets_the_proposal(chain, monkeypatch):
    """A peer that reaches our height after our proposal for it went out
    is sent the proposal and its parts once, as they were broadcast; a
    peer that stood at the height when it went out is sent nothing
    again. The JAX reactor sends the late peer nothing (ROADMAP §C)."""
    late, level, bc = _late_peer_run(PORT, chain, monkeypatch)
    kinds = [json.loads(m)["t"] for _, m in bc]
    assert kinds[0] == "proposal" and set(kinds[1:]) == {"part"}
    assert late == bc
    assert level == []
    j_late, j_level, j_bc = _late_peer_run(JAX, chain, monkeypatch)
    assert j_bc == bc
    assert j_late == [] and j_level == []


def _lagging_peer_run(P, home, monkeypatch):
    """We stand at height 6 over the chain's store; one peer reports
    heights 3, 3 (a new round), 4 and 6: what it was sent directly."""
    r, _, step = _reactor(P, monkeypatch)
    store = _store(P, home)
    r.cs.block_store = store
    r.cs.height = 6
    peer = Peer()
    sent = []
    for h, rnd in ((3, 0), (3, 1), (4, 0), (6, 0)):
        step(peer, h, rnd)
        sent.append([json.loads(m) for _, m in peer.sent[len(
            [x for y in sent for x in y]):]])
    store.close()
    assert not r.switch.stopped
    return sent


def test_a_lagging_peer_is_pushed_its_height_at_its_step(chain,
                                                         monkeypatch):
    """A peer that reports a height below ours is pushed that height's
    block and seen commit at once, once a height; a new round or our own
    height pushes nothing. The JAX reactor pushes only from its catch-up
    routine (ROADMAP §C)."""
    sent = _lagging_peer_run(PORT, chain, monkeypatch)
    assert [[(m["t"], m["c"]["height"]) for m in ms] for ms in sent] == [
        [("commit_block", 3)], [], [("commit_block", 4)], []]
    assert _lagging_peer_run(JAX, chain, monkeypatch) == [[], [], [], []]


def _pushes_taken(P, home, monkeypatch):
    """One peer pushes height 3, then 3 again, then (once we stand at
    4) height 4, back to back: the heights handed to consensus."""
    sender, _, _ = _reactor(P, monkeypatch)
    store = _store(P, home)
    sender.cs.block_store = store
    out = Peer()
    for h in (3, 3, 4):
        sender._send_catchup(out, h)
    store.close()
    r, _, _ = _reactor(P, monkeypatch)
    taken = []
    monkeypatch.setattr(r.cs, "receive_commit_block",
                        lambda block, commit: taken.append(commit.height))
    peer = Peer()
    for (chan, msg), h in zip(out.sent, (3, 3, 4)):
        r.cs.height = h
        r.receive(chan, peer, msg)
    assert not r.switch.stopped
    return taken


def test_the_push_rate_limit_holds_one_height(chain, monkeypatch):
    """A peer's repeated push of one height is held to 2 a second; its
    push of the next height is taken at once. The JAX reactor holds
    every push of a peer to 2 a second (ROADMAP §C)."""
    assert _pushes_taken(PORT, chain, monkeypatch) == [3, 4]
    assert _pushes_taken(JAX, chain, monkeypatch) == [3]


def test_mempool_evidence_pex_statesync_messages_equal(chain, monkeypatch):
    out = {}
    for P in (JAX, PORT):
        sent = []
        ctx = tm.host_plane() if P is PORT else __import__(
            "contextlib").nullcontext()
        with ctx:
            # mempool: the pool to a new peer, then a gossiped tx
            mp = P.mempool.Mempool(P.kv.KVStoreApplication())
            for i in range(5):
                assert mp.check_tx(b"m%d=%d" % (i, i)).code == 0
            mr = P.mreactor.MempoolReactor(mp)
            mr.switch = Switch(P)
            peer = Peer()
            mr.switch.peers[peer.peer_id] = peer
            mr.add_peer(peer)
            mr.broadcast_tx(b"late=1")
            sent += peer.sent
        # evidence: a duplicate vote, broadcast
        priv = P.keys.PrivKey.generate(b"\x41" * 32)
        vs = P.val.ValidatorSet([P.val.Validator(priv.pub_key(), 10)])
        bids = [P.bid.BlockID(bytes([c]) * 32, P.bid.PartSetHeader(
            1, bytes([c + 1]) * 32)) for c in (0x10, 0x20)]
        va, vb = (_votes(P, priv, vs, 3, 0, P.canon.PRECOMMIT_TYPE, b,
                         GENESIS_TIME + 30) for b in bids)
        ev = P.evidence.DuplicateVoteEvidence.from_votes(
            va, vb, P.ts.Timestamp(GENESIS_TIME + 31, 0), 10, 10)
        er = P.ereactor.EvidenceReactor(SimpleNamespace(
            pending_evidence=lambda: [ev]))
        er.switch = Switch()
        peer = Peer()
        er.add_peer(peer)
        er.broadcast_evidence(ev)
        sent += peer.sent + er.switch.broadcasts
        # PEX: a book of 12 addresses, sampled under one seed
        book = P.pex.AddrBook(None)
        for i in range(12):
            book.add(P.p2pkey.NetAddress("%040x" % (i + 1), "10.0.0.%d" % i,
                                         26656 + i), source="seed")
        pr = P.pex.PEXReactor(book)
        pr.switch = Switch()
        peer = Peer()
        random.seed(20)
        pr.receive(P.pex.PEX_CHANNEL, peer, b'{"t": "pex_req"}')
        pr._request_addrs(peer)
        sent += peer.sent
        # statesync: snapshot offers and a chunk with its proof
        app = P.kv.KVStoreApplication()
        app.enable_snapshots(2)
        for h in range(1, 5):
            app.finalize_block(P.abci.RequestFinalizeBlock(
                txs=[b"s%d=%d" % (h, h)], height=h,
                time_seconds=GENESIS_TIME + h))
            app.commit()
        sr = P.ssreactor.StatesyncP2PReactor(app, None)
        sr.switch = Switch()
        peer = Peer()
        sr.receive(P.ssreactor.SNAPSHOT_CHANNEL, peer,
                   b'{"t": "snapshots_req"}')
        snaps = [json.loads(m) for _, m in peer.sent]
        for s in snaps:
            for i in range(s["c"]):
                sr.receive(P.ssreactor.CHUNK_CHANNEL, peer, json.dumps(
                    {"t": "chunk_req", "h": s["h"], "f": s["f"],
                     "i": i}).encode())
        sent += peer.sent
        # the handshake's NodeInfo of a p2p node
        node = (tm.port_node if P is PORT else P.node.Node)(
            P.kv.KVStoreApplication(), P.state.State.make_genesis(
                CHAIN, vs, genesis_time=P.ts.Timestamp(GENESIS_TIME, 0)),
            p2p=True, pex=True, node_key=P.p2pkey.NodeKey(
                P.keys.PrivKey.generate(b"\x42" * 32)))
        node.switch.node_info.listen_addr = "127.0.0.1:26656"
        sent.append((0, node.switch.node_info.to_json().encode()))
        node.block_store.close()
        node.state_store.close()
        out[P.name] = sent
    assert out["cometbft_tpu_torch"] == out["cometbft_tpu"]
    kinds = [json.loads(m).get("t") if m[:1] == b"{" else "tx"
             for _, m in out["cometbft_tpu"]]
    for k in ("tx", "duplicate_vote", "pex_addrs", "pex_req", "snapshot",
              "chunk"):
        assert k in kinds, k
