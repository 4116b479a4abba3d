"""The port's operator surface against the JAX package's, across the two.

The ABCI socket framing is byte for byte the same, and each package's
client drives the other's server through every method, answering as the
client's own app does in process. Each package's remote-signer endpoint
takes the other's signer: votes (with their extensions) and proposals
sign exactly as a local FilePV of either package signs them, and the
signer refuses a double sign. A home made by one package's `init` or
`testnet` loads under the other's load_config, GenesisDoc and FilePV. And
the device rule at the entry point: `python -m cometbft_tpu_torch start`
under `verifier = "tpu"` exits non-zero without a card, naming it, while
the same home under `verifier = "cpu"` starts a host node that serves
/status."""
import dataclasses
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
MODULES = {"abci": "abci.types", "kv": "abci.kvstore", "srv": "abci.server",
           "remote": "privval.remote", "pv": "privval.file_pv",
           "keys": "crypto.keys", "vote": "types.vote",
           "bid": "types.block_id", "ts": "types.timestamp",
           "canon": "types.canonical", "cli": "cmd.cli",
           "config": "config.config", "genesis": "types.genesis",
           "p2pkey": "p2p.key"}


def _pkg(base):
    return SimpleNamespace(name=base, **{
        k: importlib.import_module(f"{base}.{m}")
        for k, m in MODULES.items()})


JAX = _pkg("cometbft_tpu")
PORT = _pkg("cometbft_tpu_torch")
BOTH_WAYS = pytest.mark.parametrize(
    "a,b", [(JAX, PORT), (PORT, JAX)], ids=["jax_port", "port_jax"])


# -- the ABCI socket ------------------------------------------------------------

FRAMES = [{"m": "commit"},
          {"m": "check_tx", "q": {"tx": {"__b": "YT0x"}, "recheck": False}},
          {"r": {"data": "kvstore", "last_block_app_hash": {"__b": ""}}},
          {"err": "unknown method 'x'"},
          {"m": "load_snapshot_chunk", "a": [4, 1, 0]}]


def test_socket_framing_is_byte_equal():
    for doc in FRAMES:
        wire = []
        for P in (JAX, PORT):
            a, b = socket.socketpair()
            with a, b:
                P.srv._send_msg(a, doc)
                a.shutdown(socket.SHUT_WR)
                raw = b""
                while chunk := b.recv(1 << 16):
                    raw += chunk
            wire.append(raw)
            a, b = socket.socketpair()
            with a, b:
                P.srv._send_msg(a, doc)
                assert (JAX if P is PORT else PORT).srv._recv_msg(b) == doc
        assert wire[0] == wire[1], doc
    req = PORT.abci.RequestFinalizeBlock(txs=[b"k=v"], hash=b"\x01" * 32,
                                         height=3, time_seconds=9)
    jreq = JAX.abci.RequestFinalizeBlock(txs=[b"k=v"], hash=b"\x01" * 32,
                                         height=3, time_seconds=9)
    assert json.dumps(PORT.srv._enc(req)) == json.dumps(JAX.srv._enc(jreq))


def _abci_script(P):
    """(method, args) in order: a block's life on a kvstore app."""
    a = P.abci
    txs = [b"alpha=1", b"beta=2"]
    return [
        ("info", (a.RequestInfo(),)),
        ("init_chain", (a.RequestInitChain(chain_id="abci-x",
                                           time_seconds=5),)),
        ("check_tx", (a.RequestCheckTx(tx=txs[0]),)),
        ("check_tx", (a.RequestCheckTx(tx=b"no-equals-sign"),)),
        ("prepare_proposal", (a.RequestPrepareProposal(
            max_tx_bytes=1 << 20, txs=txs, height=1),)),
        ("process_proposal", (a.RequestProcessProposal(
            txs=txs, hash=b"\x02" * 32, height=1),)),
        ("finalize_block", (a.RequestFinalizeBlock(
            txs=txs, hash=b"\x02" * 32, height=1, time_seconds=6),)),
        ("commit", ()),
        ("query", (a.RequestQuery(data=b"alpha"),)),
        ("query", (a.RequestQuery(data=b"beta", prove=True),)),
        ("extend_vote", (a.RequestExtendVote(hash=b"\x02" * 32,
                                             height=2),)),
        ("info", (a.RequestInfo(),)),
        ("list_snapshots", ()),
    ]


@BOTH_WAYS
def test_socket_client_drives_the_other_packages_server(a, b):
    """a's server, b's client; b's own app in process is the oracle."""
    server = a.srv.ABCISocketServer(a.kv.KVStoreApplication())
    server.start()
    client = b.srv.ABCISocketClient(*server.addr[:2])
    local = b.kv.KVStoreApplication()
    try:
        for method, args in _abci_script(b):
            got = getattr(client, method)(*args)
            want = getattr(local, method)(*args)
            assert json.dumps(b.srv._enc(got)) == \
                json.dumps(b.srv._enc(want)), method
    finally:
        client.close()
        server.stop()


# -- the remote signer ----------------------------------------------------------

SEED = b"\x3c" * 32
CHAIN = "signer-chain"


def _vote(P, vtype, height, tag):
    bid = P.bid.BlockID(tag * 32, P.bid.PartSetHeader(1, tag * 32))
    priv = P.keys.PrivKey.generate(SEED)
    return P.vote.Vote(vote_type=vtype, height=height, round=0,
                       block_id=bid, timestamp=P.ts.Timestamp(1_700_000_000,
                                                              7),
                       validator_address=priv.pub_key().address(),
                       validator_index=0)


def _sign_all(P, pv):
    """Signatures of a prevote, a precommit with its extension and a
    proposal, signed through `pv` (a FilePV or a listener endpoint)."""
    out = []
    v = _vote(P, P.canon.PREVOTE_TYPE, 5, b"\xaa")
    out.append(pv.sign_vote(CHAIN, v))
    v = _vote(P, P.canon.PRECOMMIT_TYPE, 5, b"\xaa")
    v.extension = b"ext-5"
    out.append(pv.sign_vote(CHAIN, v, sign_extension=True))
    out.append(v.extension_signature)
    bid = P.bid.BlockID(b"\xbb" * 32, P.bid.PartSetHeader(1, b"\xbb" * 32))
    out.append(pv.sign_proposal(CHAIN, 6, 0, -1, bid,
                                P.ts.Timestamp(1_700_000_001, 0)))
    return out


@BOTH_WAYS
def test_signer_listener_takes_the_other_packages_signer(a, b, tmp_path):
    """a's listener endpoint (the node side), b's signer server (the key
    side): the signatures equal both packages' local FilePVs'."""
    listener = a.remote.SignerListenerEndpoint()
    signer = b.remote.SignerServer(
        b.pv.FilePV.generate(str(tmp_path / "signer"), seed=SEED),
        *listener.addr[:2])
    signer.start()
    try:
        assert listener.wait_for_signer(10)
        assert listener.pub_key().data == \
            a.keys.PrivKey.generate(SEED).pub_key().data
        remote = _sign_all(a, listener)
        for P in (JAX, PORT):
            local = P.pv.FilePV(P.keys.PrivKey.generate(SEED))
            assert _sign_all(P, local) == remote, P.name
        # a conflicting prevote at the signed height: the signer refuses
        with pytest.raises(a.remote.RemoteSignerError, match="DoubleSign"):
            listener.sign_vote(CHAIN, _vote(a, a.canon.PREVOTE_TYPE, 5,
                                            b"\xcc"))
    finally:
        signer.stop()
        listener.close()


# -- CLI homes ------------------------------------------------------------------


def _same_home(a, b, home, chain):
    cfg_path = os.path.join(home, "config", "config.toml")
    ca, cb = a.config.load_config(cfg_path), b.config.load_config(cfg_path)
    assert dataclasses.asdict(ca) == dataclasses.asdict(cb)
    assert cb.base.chain_id == chain
    gpath = os.path.join(home, "config", "genesis.json")
    ga = a.genesis.GenesisDoc.from_file(gpath)
    gb = b.genesis.GenesisDoc.from_file(gpath)
    assert ga.to_json() == gb.to_json()
    assert gb.validator_set().hash() == ga.validator_set().hash()
    cfgdir = os.path.join(home, "config")
    pva, pvb = a.pv.FilePV.load(cfgdir), b.pv.FilePV.load(cfgdir)
    assert pva.pub_key().data == pvb.pub_key().data
    assert pvb.pub_key().data in {v.pub_key.data for v in gb.validators}
    nk = os.path.join(cfgdir, "node_key.json")
    assert a.p2pkey.NodeKey.load_or_gen(nk).node_id == \
        b.p2pkey.NodeKey.load_or_gen(nk).node_id


@BOTH_WAYS
def test_homes_load_under_the_other_package(a, b, tmp_path, capsys):
    """a's `init` and `testnet` write the homes; b loads them."""
    home = str(tmp_path / "single")
    assert a.cli.main(["init", "--home", home, "--chain-id", "home-chain",
                       "--verifier", "cpu"]) == 0
    _same_home(a, b, home, "home-chain")
    out = str(tmp_path / "net")
    assert a.cli.main(["testnet", "--v", "3", "--output", out,
                       "--chain-id", "net-chain"]) == 0
    for i in range(3):
        _same_home(a, b, os.path.join(out, f"node{i}"), "net-chain")
        cfg = b.config.load_config(
            os.path.join(out, f"node{i}", "config", "config.toml"))
        assert len(cfg.p2p.persistent_peers.split(",")) == 2
    capsys.readouterr()


# -- the device rule at the entry point ----------------------------------------


def _home(tmp_path, verifier):
    home = str(tmp_path / "node")
    assert PORT.cli.main(["init", "--home", home, "--chain-id",
                          "start-chain", "--verifier", verifier]) == 0
    path = os.path.join(home, "config", "config.toml")
    cfg = PORT.config.load_config(path)
    cfg.consensus.timeout_propose = 0.4
    cfg.consensus.timeout_commit = 0.01
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.base.blocksync = False
    PORT.config.save_config(cfg, path)
    return home, cfg, path


def _start(home, run_for, **kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT))
    return subprocess.Popen(
        [sys.executable, "-m", "cometbft_tpu_torch", "start", "--home",
         home, "--run-for", str(run_for)],
        cwd=str(ROOT), env=env, text=True, **kw)


def test_start_needs_the_card_unless_the_config_says_cpu(tmp_path, capsys):
    home, cfg, path = _home(tmp_path, "tpu")
    proc = _start(home, 30, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "DeviceError" in err and "CUDA is not available" in err, err
    assert "rpc listening" not in out
    # the same home with [crypto] verifier = "cpu": a host node
    cfg.crypto.verifier = "cpu"
    PORT.config.save_config(cfg, path)
    proc = _start(home, 90, stdout=subprocess.PIPE,
                  stderr=subprocess.DEVNULL)
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("rpc listening on "):
                url = line.split()[-1]
                break
        assert url, "the node never served RPC"
        deadline = time.time() + 60
        height = 0
        while height < 2:
            assert time.time() < deadline, f"stuck at height {height}"
            with urllib.request.urlopen(f"{url}/status", timeout=10) as r:
                st = json.loads(r.read())["result"]
            height = st["sync_info"]["latest_block_height"]
            time.sleep(0.2)
        assert st["node_info"]["network"] == "start-chain"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    capsys.readouterr()
