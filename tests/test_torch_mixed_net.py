"""The two packages on one network over TCP, and the files a p2p node
leaves on disk read both ways.

Two JAX validators (the host path) and two port validators
(device="cpu", riding a host verify plane) dial a full mesh with secret
connections and commit at least 5 heights; all four block stores hold the
same block hashes and app hashes, and a tx sent to each package is
committed and queryable at every node. A port node blocksyncs a JAX
node's chain over the wire and a JAX node a port node's. A port node
statesyncs from a JAX network's snapshots (its light client trusts the
JAX node 0's files, opened by the port's stores, through
lightgate.gateway.node_light_provider). node_key.json, addrbook.json and
the statesync chunk cache directory written by one package are read by
the other, both ways.

The RPC is a wire too: on the mixed network a JAX node's and a port
node's JSON-RPC servers answer the same routes at the same heights with
the same bytes, and the same error codes. The seen commit a node stores
at a height is its own (the precommits it held when it committed), so
the live `commit` answers agree on the signed header and the commit's
height, round and block; after the stop, both packages' read-only
servers over one node's stores answer every route, `commit` included,
with the same bytes."""
import hashlib
import importlib
import json
import time
import urllib.request
from types import SimpleNamespace

import pytest

import torch_mirror as tm

MODULES = {"kv": "abci.kvstore", "keys": "crypto.keys",
           "node": "node.node", "pv": "privval.file_pv",
           "state": "state.state", "bs": "store.blockstore",
           "val": "types.validator", "ts": "types.timestamp",
           "ticker": "consensus.ticker", "p2pkey": "p2p.key",
           "pex": "p2p.pex", "chunks": "statesync.chunks",
           "inspect": "inspect"}


def _pkg(base):
    return SimpleNamespace(name=base, **{
        k: importlib.import_module(f"{base}.{m}")
        for k, m in MODULES.items()})


JAX = _pkg("cometbft_tpu")
PORT = _pkg("cometbft_tpu_torch")
GENESIS_TIME = 1_700_000_000


@pytest.fixture
def plane():
    with tm.host_plane() as p:
        yield p


def fast(P):
    return P.ticker.TimeoutParams(
        propose=0.5, propose_delta=0.2, prevote=0.3, prevote_delta=0.1,
        precommit=0.3, precommit_delta=0.1, commit=0.02)


def genesis(P, chain, n, t=GENESIS_TIME):
    """A genesis of n validators; t pins its time (the light client's
    trust root is block 1, whose time is the genesis time)."""
    privs = [P.keys.PrivKey.generate(bytes([i + 1]) * 32)
             for i in range(n)]
    vals = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10)
                               for p in privs])
    return P.state.State.make_genesis(
        chain, vals, genesis_time=P.ts.Timestamp(t, 0)), privs


def make_node(P, i, chain, n, tmp_path, name, validator=True, app=None,
              key=None, t=GENESIS_TIME, **kw):
    state, privs = genesis(P, chain, n, t)
    build = tm.port_node if P is PORT else P.node.Node
    return build(
        app or P.kv.KVStoreApplication(), state,
        privval=P.pv.FilePV(privs[i]) if validator else None,
        home=str(tmp_path / name), timeouts=fast(P), p2p=True,
        node_key=P.p2pkey.NodeKey(P.keys.PrivKey.generate(
            bytes([key or 0xA0 + i]) * 32)), **kw)


def wait(cond, timeout, what):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, what
        time.sleep(0.1)


def mesh(nodes):
    addrs = [n.listen() for n in nodes]
    for n in nodes:
        n.start()
    for i, n in enumerate(nodes):
        for j, a in enumerate(addrs):
            if i != j:
                n.dial(a)
    return addrs


def test_two_jax_two_port_validators_commit_the_same_chain(tmp_path, plane):
    pkgs = [JAX, JAX, PORT, PORT]
    nodes = [make_node(P, i, "mixed-chain", 4, tmp_path, f"n{i}")
             for i, P in enumerate(pkgs)]
    try:
        mesh(nodes)
        wait(lambda: all(n.switch.num_peers() >= 3 for n in nodes), 60,
             "mesh never formed")
        assert nodes[0].broadcast_tx(b"from_jax=1").code == 0
        assert nodes[2].broadcast_tx(b"from_port=2").code == 0
        for n in nodes:
            assert n.consensus.wait_for_height(6, timeout=90), \
                f"stuck at {n.height()}"
        wait(lambda: all(n.query(b"from_jax").value == b"1"
                         and n.query(b"from_port").value == b"2"
                         for n in nodes), 60, "txs not committed")
        for h in range(1, 6):
            blocks = [n.block_store.load_block(h) for n in nodes]
            assert len({b.hash() for b in blocks}) == 1, h
            assert len({b.header.app_hash for b in blocks}) == 1, h
            assert len({n.state_store.load_validators(h).hash()
                        for n in nodes}) == 1
    finally:
        for n in reversed(nodes):
            n.stop()


@pytest.mark.parametrize("server,client", [(JAX, PORT), (PORT, JAX)],
                         ids=["port_syncs_from_jax", "jax_syncs_from_port"])
def test_blocksync_across_packages(server, client, tmp_path, plane):
    srv = make_node(server, 0, "bs-chain", 1, tmp_path, "srv")
    late = None
    try:
        addr = mesh([srv])[0]
        for i in range(4):
            srv.broadcast_tx(b"b%d=%d" % (i, i))
        assert srv.consensus.wait_for_height(8, timeout=60)
        late = make_node(client, 0, "bs-chain", 1, tmp_path, "late",
                         validator=False, blocksync=True, key=0xB0)
        late.listen()
        late.start()
        late.dial(addr)
        target = srv.height() + 1
        wait(lambda: late.height() >= target, 90,
             f"late node stuck at {late.height()} (target {target})")
        for h in range(1, target):
            assert late.block_store.load_block(h).hash() == \
                srv.block_store.load_block(h).hash()
        assert late.query(b"b3").value == b"3"
        assert late.consensus.is_running()
    finally:
        if late is not None:
            late.stop()
        srv.stop()


def test_port_node_statesyncs_from_jax_snapshots(tmp_path, plane):
    from cometbft_tpu_torch.lightgate.gateway import node_light_provider
    from cometbft_tpu_torch.light import client as lc

    nodes = []
    t = int(time.time())
    for i in range(2):
        app = JAX.kv.KVStoreApplication()
        app.enable_snapshots(4)
        nodes.append(make_node(JAX, i, "ss-mixed", 2, tmp_path, f"n{i}",
                               app=app, t=t))
    late = None
    try:
        addrs = mesh(nodes)
        assert nodes[0].consensus.wait_for_height(2, timeout=120)
        nodes[0].broadcast_tx(b"a1=x1")
        assert nodes[0].consensus.wait_for_height(8, timeout=120)
        home = str(tmp_path / "n0")
        view = SimpleNamespace(
            consensus=SimpleNamespace(state=SimpleNamespace(
                chain_id="ss-mixed")),
            block_store=PORT.bs.BlockStore(home + "/blockstore.db"),
            state_store=PORT.state.StateStore(home + "/state.db"))
        provider = node_light_provider(view)
        light = lc.Client("ss-mixed", provider, trusting_period=1e6)
        light.trust_light_block(provider.light_block(1))
        late = make_node(PORT, 0, "ss-mixed", 2, tmp_path, "late",
                         validator=False, blocksync=True, key=0xB0,
                         t=t, statesync_light_client=light)
        late.listen()
        late.start()
        for a in addrs:
            late.dial(a)
        target = nodes[0].height() + 2
        wait(lambda: late.height() >= target, 120,
             f"statesync node stuck at {late.height()} (target {target})")
        # state-synced: no early blocks in its store
        assert late.block_store.load_block(2) is None
        assert late.query(b"a1").value == nodes[0].query(b"a1").value
    finally:
        if late is not None:
            late.stop()
        for n in nodes:
            n.stop()


# -- the JSON-RPC answers, both packages ---------------------------------------


def rpc_raw(url, method, **params):
    """The raw bytes of a JSON-RPC POST answer."""
    body = json.dumps({"jsonrpc": "2.0", "id": 7, "method": method,
                       "params": params}).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def rpc_calls(heights, txs):
    """(method, params) answered alike by any node of one chain at
    `heights`, bar `commit` and the answers that carry the latest
    height (LATEST_CALLS)."""
    calls = [("genesis", {}), ("consensus_params", {"height": 1})]
    for h in heights:
        calls += [("block", {"height": h}), ("header", {"height": h}),
                  ("validators", {"height": h}),
                  ("block_results", {"height": h}),
                  ("tx_search", {"query": f"tx.height={h}"})]
    for tx in txs:
        txh = hashlib.sha256(tx).hexdigest().upper()
        calls += [("tx", {"hash": txh}), ("tx", {"hash": txh,
                                                 "prove": True})]
    # errors: an unknown method, a bad param name and a bad param value
    calls += [("no_such_route", {}), ("block", {"hieght": 1}),
              ("block", {"height": "abc"}), ("tx", {"hash": "00" * 32})]
    return calls


def latest_calls(top, txs):
    """The answers that carry a node's latest height."""
    return [("blockchain", {"min_height": 1, "max_height": top})] + [
        ("abci_query", {"data": tx.split(b"=")[0].hex()}) for tx in txs]


def same_answers(urls, calls):
    for method, params in calls:
        got = [rpc_raw(u, method, **params) for u in urls]
        assert got[0] == got[1], (method, params, got)


def test_rpc_answers_are_byte_equal_across_packages(tmp_path, plane):
    pkgs = [JAX, JAX, PORT, PORT]
    nodes = [make_node(P, i, "rpc-mixed", 4, tmp_path, f"n{i}")
             for i, P in enumerate(pkgs)]
    txs = [b"jk=1", b"pk=2", b"jk2=3"]
    try:
        mesh(nodes)
        urls = [nodes[0].rpc_listen(), nodes[2].rpc_listen()]
        wait(lambda: all(n.switch.num_peers() >= 3 for n in nodes), 60,
             "mesh never formed")
        for n, tx in zip((nodes[0], nodes[2], nodes[1]), txs):
            assert n.broadcast_tx(tx).code == 0
        wait(lambda: all(nodes[i].tx_indexer.get(
            hashlib.sha256(tx).digest()) for i in (0, 2) for tx in txs),
            90, "txs not committed and indexed")
        for n in nodes:
            assert n.consensus.wait_for_height(4, timeout=90), \
                f"stuck at {n.height()}"
        top = min(nodes[0].height(), nodes[2].height())
        heights = list(range(1, top + 1))
        same_answers(urls, rpc_calls(heights, txs))
        # these carry the latest height: compare when the two nodes stand
        # at the same one (their heights read around the answers)
        for method, params in latest_calls(top, txs):
            deadline = time.time() + 30
            while True:
                before = (nodes[0].height(), nodes[2].height())
                got = [rpc_raw(u, method, **params) for u in urls]
                if got[0] == got[1]:
                    break
                level = before[0] == before[1] == nodes[0].height() \
                    == nodes[2].height()
                assert not level and time.time() < deadline, (method, got)
        for h in heights:
            a, b = (json.loads(rpc_raw(u, "commit", height=h))["result"]
                    for u in urls)
            assert a["signed_header"]["header"] == \
                b["signed_header"]["header"]
            for k in ("height", "round", "block_id"):
                assert a["signed_header"]["commit"][k] == \
                    b["signed_header"]["commit"][k]
    finally:
        for n in reversed(nodes):
            n.stop()
    # after the stop: each package's read-only server over the same
    # stores, for one JAX home and one port home
    for name in ("n0", "n2"):
        servers = [P.inspect.InspectServer(str(tmp_path / name))
                   for P in (JAX, PORT)]
        for s in servers:
            s.start()
        try:
            urls = [s.address for s in servers]
            latest = servers[0].node.block_store.height()
            heights = list(range(1, latest + 1))
            same_answers(urls, rpc_calls(heights, txs)
                         + latest_calls(latest, txs) + [
                ("commit", {"height": h}) for h in heights] + [
                ("blockchain", {}), ("status", {}),
                ("broadcast_tx_sync", {"tx": "YT0x"})])
        finally:
            for s in servers:
                s.stop()


# -- files on disk, both ways ----------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_home_files_read_both_ways(writer, reader, tmp_path):
    path = str(tmp_path / "config" / "node_key.json")
    nk = writer.p2pkey.NodeKey.load_or_gen(path, seed=b"\x5e" * 32)
    back = reader.p2pkey.NodeKey.load_or_gen(path)
    assert back.node_id == nk.node_id
    assert back.priv_key.data == nk.priv_key.data

    book_path = str(tmp_path / "addrbook.json")
    book = writer.pex.AddrBook(book_path)
    for i in range(6):
        book.add(writer.p2pkey.NetAddress("%040x" % (i + 9), "10.1.0.%d" % i,
                                          26000 + i), source="src%d" % (i % 2),
                 seed=i == 0)
    book.mark_good("%040x" % 10)
    book.mark_attempt("%040x" % 11)
    book.save()
    read = reader.pex.AddrBook(book_path)
    assert read.size() == book.size() == 6
    keep = ("id", "host", "port", "src", "attempts", "last_success",
            "banned", "bucket", "seed")
    for nid, e in book._addrs.items():
        assert {k: read._addrs[nid][k] for k in keep} == \
            {k: e[k] for k in keep}
    # the reader's own save reads back in the writer's package (a
    # dial cooldown is not persisted across a restart in either)
    read.save()
    assert writer.pex.AddrBook(book_path)._addrs.keys() == \
        book._addrs.keys()

    cache = str(tmp_path / "chunks")
    q1 = writer.chunks.ChunkQueue(3, cache_dir=cache)
    q1.add(0, b"zero", "p1")
    q1.add(2, b"two", "p2")
    q2 = reader.chunks.ChunkQueue(3, cache_dir=cache)
    assert q2.wait_for(0, 0.0) == b"zero"
    assert q2.wait_for(2, 0.0) == b"two"
    assert q2.sender_of(0) == "cache"
    assert q2.allocate() == 1
