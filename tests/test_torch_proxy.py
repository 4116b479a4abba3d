"""The port's light proxy (cometbft_tpu_torch/light/proxy.py), with the
RPC client, ProofOps and tx proofs under it, against the JAX package's.

tests/test_light.py:316-407 (the proxy's trust-root rules over an
expired persisted root) and :467 (the proxy riding a mounted gateway) run
on both packages over the same chain, built per package from the same key
seeds: the errors, the heights stored and the verified routes' outputs
must be equal. Then both proxies serve a primary on localhost through
rpc/client.py (HTTPClient and light_provider): the verified commit,
validators, tx (a TxProof against the header's data_hash) and abci_query
(a kv ProofOp chain against the next header's app_hash) routes, and the
proxy's own JSON-RPC server, give equal answers; a forged proof fails on
both with the same message. Every server binds 127.0.0.1 and is closed."""
import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from cometbft_tpu import lightgate as jlg
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.crypto import proof_ops as jpo
from cometbft_tpu.light import client as jlc
from cometbft_tpu.light import proxy as jproxy
from cometbft_tpu.light import store as jstore
from cometbft_tpu.light import verifier as jlv
from cometbft_tpu.rpc import client as jrpc
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import serde as jserde
from cometbft_tpu.types import tx as jtx
from cometbft_tpu.types import validation as jvalidation
from cometbft_tpu.types import validator as jval
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.timestamp import Timestamp as JTimestamp
from cometbft_tpu_torch import lightgate as plg
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.crypto import merkle as pmerkle
from cometbft_tpu_torch.crypto import proof_ops as ppo
from cometbft_tpu_torch.light import client as plc
from cometbft_tpu_torch.light import proxy as pproxy
from cometbft_tpu_torch.light import store as pstore
from cometbft_tpu_torch.light import verifier as plv
from cometbft_tpu_torch.rpc import client as prpc
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import canonical as pcanon
from cometbft_tpu_torch.types import commit as pcommit
from cometbft_tpu_torch.types import serde as pserde
from cometbft_tpu_torch.types import tx as ptx
from cometbft_tpu_torch.types import validation as pvalidation
from cometbft_tpu_torch.types import validator as pval
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.timestamp import Timestamp

JAX = SimpleNamespace(
    name="jax", lg=jlg, keys=jkeys, merkle=jmerkle, po=jpo, lc=jlc,
    proxy=jproxy, store=jstore, lv=jlv, rpc=jrpc, block=jblock,
    canon=jcanon, commit=jcommit, serde=jserde, tx=jtx,
    validation=jvalidation, val=jval, BlockID=JBlockID, PSH=JPSH,
    Timestamp=JTimestamp)
PORT = SimpleNamespace(
    name="port", lg=plg, keys=pkeys, merkle=pmerkle, po=ppo, lc=plc,
    proxy=pproxy, store=pstore, lv=plv, rpc=prpc, block=pblock,
    canon=pcanon, commit=pcommit, serde=pserde, tx=ptx,
    validation=pvalidation, val=pval, BlockID=BlockID, PSH=PartSetHeader,
    Timestamp=Timestamp)

CHAIN_ID = "light-chain"
T0 = 1_700_000_000
KV = [(b"k%02d" % i, b"value-%d" % (i * i)) for i in range(5)]


def keys_for(P, tag, n):
    return [P.keys.PrivKey.generate(bytes([tag, i + 1]) + b"\x07" * 30)
            for i in range(n)]


def kv_state(P):
    """(app_hash, leaves) of the sorted kv state the fake app serves."""
    leaves = [P.po.kv_leaf(k, v) for k, v in KV]
    return P.merkle.hash_from_byte_slices(leaves), leaves


def txs_at(h):
    return [b"tx-%d-%d" % (h, i) for i in range(3)]


class LightChain:
    """tests/test_light.py's LightChain (one stable valset) for package P;
    each header also carries the merkle root of its height's txs and the
    kv state's app hash, so the proxy's tx and query proofs verify."""

    def __init__(self, P, n_heights, keys):
        self.P = P
        vs = P.val.ValidatorSet([P.val.Validator(k.pub_key(), 10)
                                 for k in keys])
        by_addr = {k.pub_key().address(): k for k in keys}
        app_hash, _ = kv_state(P)
        self.blocks = {}
        prev_bid = P.BlockID()
        for h in range(1, n_heights + 1):
            header = P.block.Header(
                chain_id=CHAIN_ID, height=h, time=P.Timestamp(T0 + h, 0),
                last_block_id=prev_bid, validators_hash=vs.hash(),
                next_validators_hash=vs.hash(),
                proposer_address=vs.validators[0].address,
                data_hash=P.merkle.hash_from_byte_slices(txs_at(h)),
                app_hash=app_hash)
            bid = P.BlockID(header.hash(), P.PSH(1, header.hash()))
            sigs = []
            for v in vs.validators:
                ts = P.Timestamp(T0 + h, 42)
                sb = P.canon.canonical_vote_bytes(
                    CHAIN_ID, P.canon.PRECOMMIT_TYPE, h, 0, bid, ts)
                sigs.append(P.commit.CommitSig(
                    P.commit.BLOCK_ID_FLAG_COMMIT, v.address, ts,
                    by_addr[v.address].sign(sb)))
            self.blocks[h] = P.lv.LightBlock(
                P.lv.SignedHeader(header, P.commit.Commit(h, 0, bid, sigs)),
                vs)
            prev_bid = bid

    def provider(self):
        return self.P.lc.Provider(CHAIN_ID, lambda h: self.blocks.get(h))


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))
    return None


# -- tests/test_light.py:316-407 and :467 ------------------------------------


def sc_proxy_refuses_expired_root_without_pinned_hash(P, tmp_path):
    chain = LightChain(P, 5, keys_for(P, 21, 3))
    path = str(tmp_path / f"{P.name}-light.db")
    st = P.store.DBStore(path)
    st.save(chain.blocks[3])
    st.close()
    proxy = P.proxy.LightProxy(CHAIN_ID, "http://127.0.0.1:1", db_path=path)
    try:
        err = _raised(proxy._ensure_trust)
    finally:
        proxy.httpd.server_close()
    assert err[0] == "LightProxyError" and "trusting period" in err[1]
    return err


def sc_proxy_reroots_expired_root_when_explicitly_insecure(P, tmp_path):
    chain = LightChain(P, 5, keys_for(P, 22, 3))
    path = str(tmp_path / f"{P.name}-light.db")
    st = P.store.DBStore(path)
    st.save(chain.blocks[3])
    st.close()
    proxy = P.proxy.LightProxy(CHAIN_ID, "http://127.0.0.1:1",
                               trusted_height=5, db_path=path,
                               insecure_allow_reroot=True)
    try:
        proxy.client.primary = chain.provider()
        proxy._ensure_trust()
        out = (proxy.client.store.latest().height,
               proxy.client.store.heights())
    finally:
        proxy.httpd.server_close()
    assert out[0] == 5
    return out


def sc_proxy_accepts_pinned_hash_reroot(P, tmp_path):
    chain = LightChain(P, 5, keys_for(P, 23, 3))
    path = str(tmp_path / f"{P.name}-light.db")
    st = P.store.DBStore(path)
    st.save(chain.blocks[2])
    st.close()
    good = chain.blocks[4].signed_header.header.hash()
    proxy = P.proxy.LightProxy(CHAIN_ID, "http://127.0.0.1:1",
                               trusted_height=4, trusted_hash=good,
                               db_path=path)
    try:
        proxy.client.primary = chain.provider()
        proxy._ensure_trust()
        out = [proxy.client.store.latest().height]
    finally:
        proxy.httpd.server_close()
    proxy2 = P.proxy.LightProxy(
        CHAIN_ID, "http://127.0.0.1:1", trusted_height=4,
        trusted_hash=b"\x13" * 32,
        db_path=str(tmp_path / f"{P.name}-light2.db"))
    try:
        proxy2.client.primary = chain.provider()
        out.append(_raised(proxy2._ensure_trust))
    finally:
        proxy2.httpd.server_close()
    no_height = _raised(lambda: P.proxy.LightProxy(
        CHAIN_ID, "http://127.0.0.1:1", trusted_hash=good))
    assert out[0] == 4 and "mismatch" in out[1][1]
    return out + [no_height]


def sc_proxy_rides_mounted_gateway(P, tmp_path):
    chain = LightChain(P, 10, keys_for(P, 33, 3))
    gw = P.lg.LightGateway(CHAIN_ID, chain.provider(), trusting_period=1e9,
                           batch_fn=P.validation.oracle_batch_fn())
    gw.client.trust_light_block(chain.blocks[1])
    gw.start()
    proxy = P.proxy.LightProxy(CHAIN_ID, "http://127.0.0.1:1")
    try:
        assert proxy.client is gw.client
        out = [proxy.commit(height=7), gw.client.store.heights(),
               gw.verify(1, 7)["verify_steps"]]
        proxy._trusted_height = 3
        proxy._trusted_hash = b"\x13" * 32
        out.append(_raised(proxy._ensure_trust))
        proxy._trusted_hash = chain.blocks[3].signed_header.header.hash()
        out.append(_raised(proxy._ensure_trust))
    finally:
        gw.stop()
        P.lg.set_global_gateway(None)
        proxy.httpd.server_close()
    out.append(proxy.client is proxy._own_client)
    gw2 = P.lg.LightGateway(CHAIN_ID, chain.provider(), trusting_period=1e9,
                            batch_fn=P.validation.oracle_batch_fn())
    gw2.client.trust_light_block(chain.blocks[1])
    gw2.start()
    legacy = P.proxy.LightProxy(CHAIN_ID, "http://127.0.0.1:1",
                                gateway=False)
    try:
        out.append(legacy.client is legacy._own_client)
    finally:
        gw2.stop()
        P.lg.set_global_gateway(None)
        legacy.httpd.server_close()
    assert out[0]["verified"] is True and 7 in out[1] and out[2] == 0
    assert "mismatch" in out[3][1] and out[4] is None
    assert out[5] is True and out[6] is True
    return out


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_proxy_scenario_matches_the_jax_proxy(name, tmp_path):
    assert SCENARIOS[name](PORT, tmp_path) == SCENARIOS[name](JAX, tmp_path)


# -- a primary on localhost, through rpc/client.py ---------------------------


class FakePrimary:
    """A JSON-RPC primary for package P's chain on 127.0.0.1: status,
    commit, validators (paged), tx (with its TxProof) and abci_query (with
    a kv ProofOp); `forge` makes the tx and query proofs lie."""

    def __init__(self, P, chain):
        self.P = P
        self.chain = chain
        self.forge = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                req = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))).decode())
                try:
                    body = {"result": getattr(outer, req["method"])(
                        **req["params"])}
                except Exception as e:  # noqa: BLE001 - the client's error
                    body = {"error": {"code": -32603, "message": str(e)}}
                raw = json.dumps(dict(body, jsonrpc="2.0",
                                      id=req["id"])).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    @property
    def url(self):
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    def status(self):
        return {"sync_info": {"latest_block_height":
                              str(max(self.chain.blocks))}}

    def commit(self, height):
        sh = self.chain.blocks[height].signed_header
        return {"signed_header": {"header": self.P.serde.header_to_j(
            sh.header), "commit": self.P.serde.commit_to_j(sh.commit)}}

    def validators(self, height, page=1, per_page=100):
        vals = self.chain.blocks[height].validator_set.validators
        rows = vals[(page - 1) * per_page: page * per_page]
        return {"total": len(vals), "validators": [
            {"pub_key": {"type": v.pub_key.key_type,
                         "value": v.pub_key.data.hex()},
             "voting_power": v.voting_power,
             "proposer_priority": v.proposer_priority} for v in rows]}

    def tx(self, hash, prove=True):
        h, i = 6, 1
        txs = txs_at(h)
        if self.forge:
            txs = txs[:i] + [b"forged"] + txs[i + 1:]
        return {"height": h, "hash": hash,
                "proof": self.P.tx.tx_proof(txs, i).to_j()}

    def abci_query(self, path=None, data=None, prove=True):
        P = self.P
        key = bytes.fromhex(data)
        i = [k for k, _ in KV].index(key)
        _, leaves = kv_state(P)
        _, proofs = P.merkle.proofs_from_byte_slices(leaves)
        value = KV[i][1] + (b"!" if self.forge else b"")
        op = P.po.make_kv_op(key, proofs[i])
        return {"response": {
            "code": 0, "key": key.hex(),
            "value": base64.b64encode(value).decode(), "height": 4,
            "proof_ops": {"ops": [op.to_j()]}}}


def _serve(P, forge):
    chain = LightChain(P, 8, keys_for(P, 41, 3))
    primary = FakePrimary(P, chain)
    primary.forge = forge
    proxy = P.proxy.LightProxy(CHAIN_ID, primary.url, trusted_height=1,
                               trusted_hash=chain.blocks[1]
                               .signed_header.header.hash(),
                               trusting_period=1e9, gateway=False)
    proxy.start()
    tx_hash = P.tx.tx_hash(txs_at(6)[1]).hex().upper()
    try:
        if forge:
            return [_raised(lambda: proxy.tx(tx_hash)),
                    _raised(lambda: proxy.abci_query(
                        data=KV[2][0].hex()))]
        rpc = P.rpc.HTTPClient(proxy.address)
        out = [proxy.commit(height=5), proxy.validators(height=3),
               proxy.tx(tx_hash), proxy.abci_query(data=KV[2][0].hex()),
               proxy.status()["light_client"],
               rpc.call("commit", height=7), rpc.commit(8),
               _raised(lambda: rpc.call("nope")),
               proxy.client.store.heights(), proxy.client.verifications]
        lb = P.rpc.light_provider(CHAIN_ID, primary.url).light_block(5)
        out.append(lb.signed_header.header.hash().hex())
        out.append(lb.validator_set.hash().hex())
        return out
    finally:
        proxy.stop()
        primary.close()


@pytest.mark.parametrize("forge", [False, True], ids=["honest", "forged"])
def test_the_proxy_over_an_rpc_primary_matches_the_jax_proxy(forge):
    want = _serve(JAX, forge)
    assert _serve(PORT, forge) == want
    if forge:
        assert "tx proof does not verify" in want[0][1]
        assert "query proof verification failed" in want[1][1]
    else:
        assert want[2]["verified"] is True
        assert want[3]["response"]["verified"] is True
        assert "not found" in want[7][1]


def test_tx_proofs_and_proof_ops_match_the_jax_modules():
    for n in (1, 2, 5, 9):
        txs = [b"t%d" % i * (i + 1) for i in range(n)]
        for i in range(n):
            jp, pp = jtx.tx_proof(txs, i), ptx.tx_proof(txs, i)
            assert pp.to_j() == jp.to_j()
            assert ptx.TxProof.from_j(jp.to_j()).validate(pp.root_hash)
            assert pp.validate(b"\x00" * 32) is jp.validate(b"\x00" * 32)
    _, leaves = kv_state(PORT)
    root, proofs = pmerkle.proofs_from_byte_slices(leaves)
    for P, rt in ((JAX, jpo.default_runtime()), (PORT, ppo.default_runtime())):
        ops = [P.po.ProofOp.from_j(P.po.make_kv_op(KV[1][0],
                                                   proofs[1]).to_j())]
        assert rt.verify_value(ops, root, KV[1][0], KV[1][1]) is None
    outs = {}
    for P in (JAX, PORT):
        rt = P.po.default_runtime()
        op = P.po.make_kv_op(KV[1][0], proofs[1])
        outs[P.name] = [
            _raised(lambda: rt.verify_value([], root, KV[1][0], KV[1][1])),
            _raised(lambda: rt.verify_value([op], root, b"x", KV[1][1])),
            _raised(lambda: rt.verify_value([op], root, KV[1][0], b"bad")),
            _raised(lambda: rt.verify_value([P.po.ProofOp("other", KV[1][0])],
                                            root, KV[1][0], KV[1][1])),
            _raised(lambda: rt.verify_value([op], b"\x01" * 32, KV[1][0],
                                            KV[1][1])),
            _raised(lambda: rt.verify_value(
                [P.po.ProofOp(P.po.OP_KV, KV[1][0], b"{")], root,
                KV[1][0], KV[1][1]))]
    assert outs["port"] == outs["jax"]
    assert all(o is not None for o in outs["port"])
