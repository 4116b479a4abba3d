"""The port's copies of the node's host libraries against the JAX
package's: libs/pubsub.py, types/event_bus.py, libs/metrics.py,
libs/service.py, types/proposal.py, privval/file_pv.py, abci/proxy.py,
state/indexer.py, state/pruner.py and consensus/heightledger.py.

Each scenario runs on both packages' modules with the same inputs and
compares the outputs: query matches and parse errors over a corpus,
the events each subscriber of an EventBus receives, the promtext of a
NodeMetrics after the same observations (the JAX package's exposition
tests run on the port's too), FilePV's key and state files, signatures
and double-sign refusals (each package loads the other's files),
proposal sign bytes, indexer searches (each package reads the other's
sqlite files), a pruning pass, and the height ledger's dump for one
scripted sequence of step, vote and commit events under ticker clocks.
"""
import hashlib
import importlib
import importlib.util
import itertools
import json
import os
import sqlite3
from pathlib import Path
from types import SimpleNamespace

import pytest

MODULES = {"pubsub": "libs.pubsub", "bus": "types.event_bus",
           "metrics": "libs.metrics", "service": "libs.service",
           "proposal": "types.proposal", "pv": "privval.file_pv",
           "proxy": "abci.proxy", "indexer": "state.indexer",
           "pruner": "state.pruner", "hl": "consensus.heightledger",
           "tracing": "libs.tracing", "keys": "crypto.keys",
           "vote": "types.vote", "bid": "types.block_id",
           "ts": "types.timestamp", "commit": "types.commit",
           "canon": "types.canonical", "abci": "abci.types",
           "kv": "abci.kvstore"}


def _pkg(base):
    return SimpleNamespace(name=base, **{
        k: importlib.import_module(f"{base}.{m}")
        for k, m in MODULES.items()})


JAX = _pkg("cometbft_tpu")
PORT = _pkg("cometbft_tpu_torch")
PACKAGES = (JAX, PORT)
CHAIN = "node-libs-chain"
T0 = 1_700_000_000


def _expo_module():
    """tests/test_metrics_expo.py, loaded by path: its promtext parser and
    checks are the oracle for both packages' exposition."""
    path = Path(__file__).with_name("test_metrics_expo.py")
    spec = importlib.util.spec_from_file_location("_jax_metrics_expo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXPO = _expo_module()


def raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the outcome under comparison
        return (type(e).__name__, str(e))
    return None


# -- pubsub -------------------------------------------------------------------

QUERIES = [
    "tm.event='NewBlock'", "tm.event = 'Tx' AND tx.height>5",
    "tx.height>=3 AND tx.height<=7", "app.key CONTAINS 'ab'",
    "app.key EXISTS", 'app.key="x y"', "tx.height<9223372036854775807",
    "tx.height>9007199254740992", "amount>1.5", "amount<=2",
    "tm.event='Tx' AND app.key='k' AND tx.height=4", "",
    # parse errors
    "tx.height>", "tx.height>abc", "tm.event", "tm.event='a' AND = 'b'",
    "key ~= 'x'",
]
TAGS = [
    {"tm.event": ["NewBlock"]},
    {"tm.event": ["Tx"], "tx.height": ["4"], "app.key": ["k", "abc"]},
    {"tm.event": ["Tx"], "tx.height": ["6"]},
    {"tx.height": ["9007199254740993"]},
    {"tx.height": ["9223372036854775806"], "app.key": ["x y"]},
    {"amount": ["1.75"]}, {"amount": ["2"]}, {"amount": ["garbage"]},
    {"app.key": []}, {},
]


def _matches(P):
    out = []
    for q in QUERIES:
        try:
            query = P.pubsub.Query(q)
        except P.pubsub.QueryError as e:
            out.append(("QueryError", str(e)))
            continue
        out.append([query.matches(t) for t in TAGS])
    return out


def test_pubsub_query_matches_and_errors_equal():
    j, p = _matches(JAX), _matches(PORT)
    assert p == j
    assert sum(isinstance(o, tuple) for o in p) == 5
    assert any(any(row) for row in p if isinstance(row, list))


def _bus_run(P):
    bus = P.bus.EventBus()
    subs = {q: bus.subscribe(f"s{i}", q, capacity=8)
            for i, q in enumerate(["tm.event='NewBlock'", "tm.event='Tx'",
                                   "tx.height>=2", "tm.event EXISTS"])}
    slow = bus.subscribe("slow", "tm.event='Tx'", capacity=2)
    for h in (1, 2, 3):
        bus.publish_new_block({"height": h}, result=f"r{h}")
        bus.publish_new_block_header({"height": h})
        for k in range(2):
            bus.publish_tx(h, b"k%d=v%d" % (h, k), {"code": 0})
        bus.publish_vote({"h": h})
    bus.publish_validator_set_updates(["u"])
    bus.unsubscribe("s0", "tm.event='NewBlock'")
    bus.publish_new_block({"height": 4})
    bus.unsubscribe_all("s1")
    bus.publish_tx(5, b"late", None)

    def drain(sub):
        out = []
        while (m := sub.next(timeout=0)) is not None:
            out.append((m.tags, m.data))
        return out

    return ({q: drain(s) for q, s in subs.items()}, drain(slow),
            [s.cancelled for s in subs.values()])


def test_event_bus_delivers_equal_events():
    j, p = _bus_run(JAX), _bus_run(PORT)
    assert p == j
    received, slow, cancelled = p
    assert len(received["tm.event='NewBlock'"]) == 3
    assert len(slow) == 2  # drop-on-full for a slow subscriber
    assert cancelled == [True, True, False, False]
    tx = received["tx.height>=2"][0]
    assert tx[0]["tx.hash"] == [hashlib.sha256(b"k2=v0").hexdigest().upper()]


# -- metrics ------------------------------------------------------------------


def _populate(P):
    m = P.metrics.NodeMetrics()
    m.height.set(7)
    m.rounds.set(1)
    m.validators.set(4)
    m.block_interval.observe(0.8)
    m.num_txs.set(3)
    m.total_txs.inc(3)
    m.block_size.set(512)
    m.step_duration.observe(0.01, step="propose")
    m.step_duration.observe(0.002, step="prevote")
    m.verify_batches.inc()
    m.verify_sigs.inc(128)
    m.verify_seconds.observe(0.02)
    m.plane_queue_depth.set(2)
    m.plane_batch_size.observe(64)
    m.plane_wait_seconds.observe(0.003)
    m.plane_padding_waste.inc(4)
    m.plane_pack_seconds.observe(0.0004)
    m.plane_h2d_bytes.inc(4096, path="host")
    m.plane_h2d_bytes.inc(80, path="device")
    m.mempool_size.set(9)
    m.mempool_admission.inc(outcome="admitted")
    m.plane_lane_rows.inc(17, lane="consensus")
    m.peers.set(3)
    m.blocksync_syncing.set(0)
    return m


# help texts the port words for its own device (an nvcc build, not a jax
# compile); every other line of the exposition is the JAX package's
PORT_HELP = {"cometbft_device_compiles_total",
             "cometbft_device_compile_pcache_hits_total"}


def _split_help(text):
    helps, rest = {}, []
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, h = line[len("# HELP "):].partition(" ")
            helps[name] = h
        else:
            rest.append(line)
    return helps, rest


def test_node_metrics_promtext_equal_after_the_same_observations():
    j_help, j_rest = _split_help(_populate(JAX).registry.expose_text())
    p_help, p_rest = _split_help(_populate(PORT).registry.expose_text())
    assert p_rest == j_rest
    assert set(p_help) == set(j_help)
    assert {k for k in j_help if p_help[k] != j_help[k]} == PORT_HELP
    assert all("jax" not in h.lower() for h in p_help.values())


@pytest.mark.parametrize("scenario", [
    "full_nodemetrics_promtext_roundtrip", "idle_histograms_expose_zero_rows",
    "label_escaping_roundtrip", "histogram_zero_rows_direct"])
def test_metrics_expo_scenarios_on_the_port(scenario, monkeypatch):
    """The non-scrape tests of tests/test_metrics_expo.py, with the port's
    NodeMetrics, Registry and Histogram in place of the JAX package's."""
    for name in ("NodeMetrics", "Registry", "Histogram"):
        monkeypatch.setattr(EXPO, name, getattr(PORT.metrics, name))
    monkeypatch.setattr(EXPO, "_populated_node_metrics",
                        lambda: _populate(PORT))
    getattr(EXPO, "test_" + scenario)()


def test_port_scrape_samples_the_ports_modules():
    """The scrape reads the port's modules by name: its WAL's fsyncs and
    its failpoints' counters, never the JAX package's."""
    from cometbft_tpu_torch.consensus import wal as pwal
    from cometbft_tpu_torch.libs import failpoints as pfp

    pfp.reset()
    pfp.register("node_libs.scrape", "a test point")
    pfp.arm("node_libs.scrape", "delay", 0.0, count=1)
    try:
        pfp.fail_point("node_libs.scrape")
    finally:
        pfp.reset()
    m = PORT.metrics.NodeMetrics()
    fams = EXPO.parse_promtext(m.expose_text())
    fs = pwal.fsync_stats()
    wal_total = {s[2] for s in fams["cometbft_wal_fsync_total"]["samples"]}
    assert wal_total == {float(fs["count"])}
    assert fams["cometbft_crypto_breaker_open"]["samples"]


# -- service, proposal, FilePV, proxy -----------------------------------------


def _service_run(P):
    class S(P.service.BaseService):
        def __init__(self):
            super().__init__()
            self.calls = []

        def on_start(self):
            self.calls.append("start")

        def on_stop(self):
            self.calls.append("stop")

    s = S()
    out = [s.name, s.is_running()]
    s.start()
    out += [s.is_running(), raised(s.start)]
    s.stop()
    s.stop()
    out += [s.is_running(), s.wait(0), raised(s.start), s.calls]
    return out


def test_base_service_lifecycle_equal():
    assert _service_run(PORT) == _service_run(JAX)


def _bid(P, tag):
    return P.bid.BlockID(bytes([tag]) * 32,
                         P.bid.PartSetHeader(1, bytes([tag + 1]) * 32))


def _proposal_run(P):
    out = []
    for h, r, pol, tag, sig in [(1, 0, -1, 7, b"s" * 64),
                                (9, 3, 1, 8, b"t" * 64),
                                (2, 1, 1, 9, b"u" * 64),
                                (2, 0, -1, 9, b""), (-1, 0, -1, 1, b"s"),
                                (3, 2, -2, 1, b"s")]:
        prop = P.proposal.Proposal(h, r, pol, _bid(P, tag),
                                   P.ts.Timestamp(T0 + h, 5))
        prop.signature = sig
        out.append((prop.sign_bytes(CHAIN).hex(),
                    raised(prop.validate_basic)))
    incomplete = P.proposal.Proposal(1, 0, -1, P.bid.BlockID(),
                                     P.ts.Timestamp(T0, 0), b"s" * 64)
    out.append(raised(incomplete.validate_basic))
    priv = P.keys.PrivKey.generate(b"\x11" * 32)
    prop = P.proposal.Proposal(4, 0, -1, _bid(P, 3), P.ts.Timestamp(T0, 1))
    prop.signature = priv.sign(prop.sign_bytes(CHAIN))
    out.append((prop.signature.hex(), prop.verify(CHAIN, priv.pub_key()),
                prop.verify("other", priv.pub_key())))
    return out


def test_proposal_sign_bytes_and_checks_equal():
    assert _proposal_run(PORT) == _proposal_run(JAX)


def _vote(P, priv, vtype, h, r, tag, secs=0):
    addr = priv.pub_key().address()
    return P.vote.Vote(vote_type=vtype, height=h, round=r,
                       block_id=_bid(P, tag),
                       timestamp=P.ts.Timestamp(T0 + secs, 0),
                       validator_address=addr, validator_index=0)


def _file_pv_run(P, home):
    pv = P.pv.FilePV.generate(str(home), seed=b"\x21" * 32)
    out = []
    for vtype, h, r, tag, secs in [(1, 1, 0, 1, 0), (2, 1, 0, 1, 0),
                                   (2, 1, 0, 1, 0), (2, 1, 0, 2, 0),
                                   (1, 1, 0, 1, 0), (1, 2, 0, 3, 5),
                                   (1, 2, 0, 3, 6)]:
        v = _vote(P, pv.priv_key, vtype, h, r, tag, secs)
        out.append(raised(lambda: out.append(
            pv.sign_vote(CHAIN, v).hex())))
    out.append(pv.sign_proposal(CHAIN, 3, 0, -1, _bid(P, 4),
                                P.ts.Timestamp(T0, 2)).hex())
    out.append(pv.sign_proposal(CHAIN, 3, 0, -1, _bid(P, 4),
                                P.ts.Timestamp(T0, 2)).hex())
    out.append(raised(lambda: pv.sign_proposal(
        CHAIN, 3, 0, -1, _bid(P, 5), P.ts.Timestamp(T0, 2))))
    # a precommit with an extension: the extension signature is made
    ext = _vote(P, pv.priv_key, 2, 4, 0, 6)
    ext.extension = b"ext"
    out.append((pv.sign_vote(CHAIN, ext, sign_extension=True).hex(),
                ext.extension_signature.hex()))
    files = {name: json.load(open(os.path.join(home, name)))
             for name in ("priv_validator_key.json",
                          "priv_validator_state.json")}
    return out, files


def test_file_pv_signatures_refusals_and_files_equal(tmp_path):
    j_out, j_files = _file_pv_run(JAX, tmp_path / "jax")
    p_out, p_files = _file_pv_run(PORT, tmp_path / "port")
    assert p_out == j_out
    assert p_files == j_files
    kinds = [o[0] for o in p_out if isinstance(o, tuple)
             and o and o[0] == "DoubleSignError"]
    assert len(kinds) == 4


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_file_pv_reads_the_other_packages_home(tmp_path, writer, reader):
    home = str(tmp_path / "pv")
    w = writer.pv.FilePV.generate(home, seed=b"\x33" * 32)
    w.sign_vote(CHAIN, _vote(writer, w.priv_key, 2, 5, 1, 9))
    r = reader.pv.FilePV.load(home)
    assert r.pub_key().data == w.pub_key().data
    assert (r.height, r.round, r.step) == (5, 1, 3)
    assert r.signature == w.signature
    # the same vote is re-served; a regression and a conflict are refused
    again = _vote(reader, r.priv_key, 2, 5, 1, 9)
    assert r.sign_vote(CHAIN, again) == w.signature
    assert raised(lambda: r.sign_vote(
        CHAIN, _vote(reader, r.priv_key, 1, 5, 1, 9)))[0] == \
        "DoubleSignError"
    assert raised(lambda: r.sign_vote(
        CHAIN, _vote(reader, r.priv_key, 2, 5, 1, 8)))[0] == \
        "DoubleSignError"


def test_app_conns_in_process_and_the_a8_clients():
    for P in PACKAGES:
        app = P.kv.KVStoreApplication()
        conns = P.proxy.AppConns.in_process(app)
        assert conns.consensus.info(P.abci.RequestInfo()).last_block_height \
            == 0
        with pytest.raises(AttributeError):
            conns.mempool.not_forwarded  # noqa: B018
        conns.close()
    # the out-of-process clients: socket and gRPC, built directly and
    # from a proxy_app address, each answering Info from a served kvstore
    from cometbft_tpu_torch.abci.grpc import ABCIGRPCServer
    from cometbft_tpu_torch.abci.server import ABCISocketServer

    sock = ABCISocketServer(PORT.kv.KVStoreApplication())
    grpc_srv = ABCIGRPCServer(PORT.kv.KVStoreApplication())
    sock.start()
    grpc_srv.start()
    try:
        (sh, sp), (gh, gp) = sock.addr[:2], grpc_srv.addr
        for make in (lambda: PORT.proxy.AppConns.socket(sh, sp),
                     lambda: PORT.proxy.AppConns.grpc(gh, gp),
                     lambda: PORT.proxy.AppConns.from_addr(f"tcp://{sh}:{sp}"),
                     lambda: PORT.proxy.AppConns.from_addr(f"grpc://{gh}:{gp}")):
            conns = make()
            try:
                for c in (conns.consensus, conns.mempool, conns.query,
                          conns.snapshot):
                    assert c.info(PORT.abci.RequestInfo()) \
                        .last_block_height == 0
            finally:
                conns.close()
    finally:
        grpc_srv.stop()
        sock.stop()
    assert raised(lambda: PORT.proxy.AppConns.from_addr("udp://h:1")) == \
        raised(lambda: JAX.proxy.AppConns.from_addr("udp://h:1"))


# -- indexer and pruner -------------------------------------------------------

TX_QUERIES = ["tx.height=2", "tx.height>1 AND tx.height<4", "app.k='a'",
              "app.k CONTAINS 'b'", "app.k EXISTS", "tx.height>=3",
              "app.n>5", "app.n<=10 AND tx.height=3", "tx.height>x"]
BLOCK_QUERIES = ["block.height>1", "block.proposer='AB'",
                 "block.proposer EXISTS AND block.height<3"]


def _fill(P, tx_path, blk_path):
    txi = P.indexer.TxIndexer(tx_path)
    blki = P.indexer.BlockIndexer(blk_path)
    for h in range(1, 5):
        for i in range(3):
            res = P.abci.ExecTxResult(code=i % 2, data=b"d%d" % i,
                                      log=f"log{h}.{i}")
            txi.index(h, i, b"tx-%d-%d" % (h, i), res,
                      {"app.k": [["a", "bb", "abc"][i]],
                       "app.n": [str(h * 3 + i)]})
        blki.index(h, {"block.proposer": ["AB" if h % 2 else "CD"]})
    return txi, blki


def _searches(P, txi, blki):
    out = []
    for q in TX_QUERIES:
        out.append(raised(lambda: out.append(
            [(r["height"], r["index"], r["tx"], r["code"])
             for r in txi.search(q)])))
    total, page = txi.search_paged("app.k EXISTS", page=2, per_page=5,
                                   order="desc")
    out.append((total, [r["tx"] for r in page]))
    out.append(raised(lambda: txi.search_paged("app.k EXISTS", page=9)))
    out.append(txi.get(hashlib.sha256(b"tx-2-1").digest()))
    out.append([blki.search(q) for q in BLOCK_QUERIES])
    return out


def test_indexer_searches_equal_and_files_cross_read(tmp_path):
    runs = {}
    for P in PACKAGES:
        txi, blki = _fill(P, str(tmp_path / f"{P.name}-tx.db"),
                          str(tmp_path / f"{P.name}-blk.db"))
        runs[P.name] = _searches(P, txi, blki)
        txi.close()
        blki.close()
    assert runs["cometbft_tpu_torch"] == runs["cometbft_tpu"]
    # each package searches the other's files alike
    for P, other in ((JAX, "cometbft_tpu_torch"), (PORT, "cometbft_tpu")):
        txi = P.indexer.TxIndexer(str(tmp_path / f"{other}-tx.db"))
        blki = P.indexer.BlockIndexer(str(tmp_path / f"{other}-blk.db"))
        assert _searches(P, txi, blki) == runs[P.name]
        txi.close()
        blki.close()
    for name in ("tx", "blk"):
        schema = [sorted(sqlite3.connect(str(
            tmp_path / f"{P.name}-{name}.db")).execute(
                "SELECT name, sql FROM sqlite_master").fetchall())
            for P in PACKAGES]
        assert schema[0] == schema[1]


def _indexer_service_run(P):
    bus = P.bus.EventBus()
    txi, blki = P.indexer.TxIndexer(), P.indexer.BlockIndexer()
    svc = P.indexer.IndexerService(bus, txi, blki)

    class Hdr:
        height, proposer_address = 2, b"\xab\xcd"

    class Blk:
        header = Hdr()

    res = P.abci.ExecTxResult(code=0)
    for tx in (b"a=1", b"b=2"):
        bus.publish_tx(2, tx, res)
    bus.publish_new_block(Blk())
    import time

    deadline = time.time() + 10
    while (len(txi.search("tx.height=2")) < 2
           or not blki.search("block.height=2")) and time.time() < deadline:
        time.sleep(0.01)
    svc.stop()
    return ([(r["index"], r["tx"]) for r in txi.search("tx.height=2")],
            blki.search("block.proposer='ABCD'"))


def test_indexer_service_feeds_both_indexers_alike():
    assert _indexer_service_run(PORT) == _indexer_service_run(JAX) == (
        [(0, b"a=1"), (1, b"b=2")], [2])


class _Stores:
    def __init__(self):
        self.calls = []

    def prune_blocks(self, h):
        self.calls.append(("blocks", h))
        return h - 1

    def prune(self, h):
        self.calls.append(("index", h))

    def prune_validators(self, h):
        self.calls.append(("validators", h))

    def prune_abci_responses(self, h):
        self.calls.append(("abci", h))


def _pruner_run(P):
    s = _Stores()
    pr = P.pruner.Pruner(s, s, s, s, interval=60.0,
                         evidence_safe_height=lambda: 4)
    out = [pr.prune_once(), pr.retain_height()]
    pr.set_retain_height(10)
    pr.set_retain_height(7)
    out += [pr.retain_height(), pr.prune_once(), s.calls]
    pr.start()
    pr.stop()
    out.append(pr.is_running())
    return out


def test_pruner_pass_equal():
    assert _pruner_run(PORT) == _pruner_run(JAX)


# -- height ledger ------------------------------------------------------------


def _ledger_run(P):
    it = itertools.count(0, 250_000)
    P.tracing.set_clock(lambda: next(it))
    try:
        led = P.hl.HeightLedger(capacity=16)
        CS = P.commit.CommitSig
        for h in (1, 2, 3):
            led.on_step(h, 0, 1)
            led.note_wal_fsync_base(1000 * h)
            led.on_step(h, 0, 4)
            led.note_flush_seq(10 ** 9 + h)
            for v in range(4):
                led.note_vote(0, v, net_ns=v * 100_000)
            led.on_step(h, 0, 6)
            if h == 2:
                led.on_step(h, 1, 2)
                led.on_step(h, 1, 4)
                led.note_vote(1, 3, net_ns=50_000)
                led.on_step(h, 1, 6)
            led.on_step(h, 0 if h != 2 else 1, 8)
            led.on_commit(h)
            sigs = [CS.absent() if i == h else CS(
                2, b"\x01" * 20, P.ts.Timestamp(T0, 0), b"s" * 64)
                for i in range(4)]
            led.note_vote(0, 0)
            led.record_height(h, 0 if h != 2 else 1, f"prop{h}", h, 10 * h,
                              commit_sigs=sigs, fsync_led_ns=5000 * h)
            wants = [led.wants_straggler(h, 0, v) for v in range(5)]
            led.burn_straggler(h, 0, 4)
            led.note_straggler(h, 0, 3, net_ns=1_000)
            led.note_straggler(h, 0, 3, net_ns=1_000)
            led.on_step(h + 1, 0, 1)
        led.record_height(9, 0, "catchup", 0, 0,
                          via=P.hl.VIA_CATCHUP)
        return (led.dump(), led.tail(8), len(led), wants,
                led.top_late_signers(3))
    finally:
        P.tracing.set_clock(None)


def test_height_ledger_dumps_equal():
    j, p = _ledger_run(JAX), _ledger_run(PORT)
    assert p == j
    dump = p[0]
    assert dump["summary"]["heights"] == 4
    assert dump["summary"]["catchup_heights"] == 1
    assert dump["summary"]["multi_round_heights"] == 1
    assert dump["summary"]["absent_votes"] == 3


def test_height_ledger_globals_follow_the_registration():
    for P in PACKAGES:
        a, b = P.hl.HeightLedger(), P.hl.HeightLedger()
        P.hl.set_global_ledger(a)
        P.hl.set_global_ledger(b)
        P.hl.clear_global_ledger(a)
        assert P.hl.global_ledger() is b
        P.hl.clear_global_ledger(b)
        assert P.hl.global_ledger() is b  # _LAST keeps history
        mark = P.hl.ledger_mark()
        assert not P.hl.ledger_advanced(mark)
        assert P.hl.dump_heights()["summary"] == {"heights": 0}
