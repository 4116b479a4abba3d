"""Operator CLI: init / start / testnet / show-node-id / reset.

Reference: cmd/cometbft/commands/ (cobra): init.go, run_node.go,
testnet.go, show_node_id.go, reset.go. `python -m cometbft_tpu_torch <cmd>`.

The port's copy of the JAX package's cmd/cli.py: the same commands, the
same home layout and config files. `start` builds the port's Node, which
under `[crypto] verifier = "tpu"` (the default) verifies on the CUDA card
and raises DeviceError without one; only `verifier = "cpu"` in the config
makes a host node.
"""
from __future__ import annotations

import argparse
import os
import shutil
import signal
import sys
import time

from cometbft_tpu_torch.config.config import (
    Config,
    default_home,
    load_config,
    save_config,
)


def _home_arg(p):
    p.add_argument("--home", default=default_home(),
                   help="node home directory")


def _config_path(home):
    return os.path.join(home, "config", "config.toml")


def cmd_init(args) -> int:
    """init.go: write config.toml, genesis.json, node_key.json,
    priv_validator_key.json."""
    from cometbft_tpu_torch.p2p.key import NodeKey
    from cometbft_tpu_torch.privval.file_pv import FilePV
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.timestamp import Timestamp

    home = args.home
    cfgdir = os.path.join(home, "config")
    datadir = os.path.join(home, "data")
    os.makedirs(cfgdir, exist_ok=True)
    os.makedirs(datadir, exist_ok=True)

    cfg = Config()
    if args.chain_id:
        cfg.base.chain_id = args.chain_id
    cfg.crypto.verifier = args.verifier
    save_config(cfg, _config_path(home))

    pv = FilePV.generate(cfgdir) if not os.path.exists(
        os.path.join(cfgdir, "priv_validator_key.json")
    ) else FilePV.load(cfgdir)
    NodeKey.load_or_gen(os.path.join(cfgdir, "node_key.json"))

    gpath = os.path.join(cfgdir, "genesis.json")
    if not os.path.exists(gpath):
        doc = GenesisDoc(
            chain_id=cfg.base.chain_id,
            genesis_time=Timestamp.now(),
            validators=[GenesisValidator(pv.pub_key(), 10, "validator")],
        )
        doc.save_as(gpath)
    print(f"Initialized node in {home}")
    return 0


def build_node(home: str, cfg=None):
    """Assemble a Node from a home directory (run_node.go -> NewNode)."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.p2p.key import NodeKey
    from cometbft_tpu_torch.privval.file_pv import FilePV
    from cometbft_tpu_torch.types.genesis import GenesisDoc

    cfg = cfg or load_config(_config_path(home))
    # arm configured failpoints before any instrumented module runs a
    # seam (CBT_FAILPOINTS env arming happens lazily regardless), and
    # install the tracer first so node assembly itself is traceable
    cfg.tracing.apply()
    cfg.failpoints.apply()
    # incident watchdog thresholds + the config fingerprint frozen
    # into every snapshot (what this node was RUNNING when it fired)
    cfg.incidents.apply(fingerprint={
        "chain_id": cfg.base.chain_id,
        "moniker": cfg.base.moniker,
        "verifier": cfg.crypto.verifier,
        "verify_plane": cfg.verify_plane.enable,
        "mesh": cfg.verify_plane.mesh,
        "pipeline_flights": cfg.verify_plane.pipeline_flights,
        "mempool_admission": cfg.mempool.admission,
        "tracing": cfg.tracing.enable,
    })
    cfgdir = os.path.join(home, "config")
    doc = GenesisDoc.from_file(os.path.join(cfgdir, "genesis.json"))
    pa = cfg.base.proxy_app
    if pa == "kvstore":
        app = KVStoreApplication()
    elif "://" in pa or ":" in pa:
        # out-of-process app: tcp:// socket or grpc:// server
        # (proxy/client.go DefaultClientCreator address dispatch)
        from cometbft_tpu_torch.abci.proxy import AppConns

        app = AppConns.from_addr(pa)
    else:
        raise SystemExit(
            f"unknown proxy_app {pa!r} (use 'kvstore', 'tcp://h:p' "
            f"for a socket ABCI server, or 'grpc://h:p' for gRPC)"
        )
    import json as _json

    node = Node(
        app,
        doc.make_state(),
        privval=FilePV.load(cfgdir),
        home=os.path.join(home, "data"),
        timeouts=cfg.consensus.timeout_params(),
        batch_fn=cfg.crypto.batch_fn(),
        verify_plane=cfg.verify_plane,
        mempool_config=cfg.mempool,
        lightgate=cfg.lightgate,
        controller=cfg.controller,
        p2p=True,
        node_key=NodeKey.load_or_gen(os.path.join(cfgdir, "node_key.json")),
        blocksync=cfg.base.blocksync,
        app_state_bytes=(_json.dumps(doc.app_state).encode()
                         if doc.app_state else b""),
    )
    # the full doc backs the genesis/genesis_chunked RPCs
    node.genesis_doc = _json.loads(doc.to_json())
    return node, cfg


def _parse_addr(laddr: str):
    hostport = laddr.split("://", 1)[-1]
    host, _, port = hostport.rpartition(":")
    return host or "0.0.0.0", int(port)


def cmd_start(args) -> int:
    """run_node.go: assemble, listen, dial persistent peers, serve RPC."""
    from cometbft_tpu_torch.p2p.key import NetAddress

    node, cfg = build_node(args.home)
    host, port = _parse_addr(cfg.p2p.laddr)
    node.start()
    addr = node.listen(host, port)
    print(f"p2p listening on {addr.host}:{addr.port} (id {addr.node_id})")
    if cfg.rpc.enabled:
        rh, rp = _parse_addr(cfg.rpc.laddr)
        url = node.rpc_listen(rh, rp, unsafe=cfg.rpc.unsafe)
        print(f"rpc listening on {url}")
    for peer in filter(None, cfg.p2p.persistent_peers.split(",")):
        pid, hostport = peer.strip().split("@")
        h, _, p = hostport.rpartition(":")
        node.dial(NetAddress(pid, h, int(p)))

    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop and (args.run_for <= 0
                            or time.time() < args._t0 + args.run_for):
            time.sleep(0.2)
    finally:
        node.stop()
    return 0


def cmd_testnet(args) -> int:
    """testnet.go: generate n validator home dirs wired to each other."""
    from cometbft_tpu_torch.p2p.key import NodeKey
    from cometbft_tpu_torch.privval.file_pv import FilePV
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.timestamp import Timestamp

    n = args.v
    homes = [os.path.join(args.output, f"node{i}") for i in range(n)]
    pvs, keys = [], []
    for home in homes:
        cfgdir = os.path.join(home, "config")
        os.makedirs(cfgdir, exist_ok=True)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
        pvs.append(FilePV.generate(cfgdir))
        keys.append(NodeKey.load_or_gen(
            os.path.join(cfgdir, "node_key.json")))
    doc = GenesisDoc(
        chain_id=args.chain_id or "cbt-testnet",
        genesis_time=Timestamp.now(),
        validators=[GenesisValidator(pv.pub_key(), 10, f"node{i}")
                    for i, pv in enumerate(pvs)],
    )
    # two ports per node (p2p, rpc) so the ranges can never collide
    # (testnet.go allocates per-node port pairs the same way)
    base_p2p, base_rpc = args.p2p_port, args.rpc_port
    p2p_port = lambda i: base_p2p + 2 * i
    rpc_port = lambda i: base_rpc + 2 * i
    for i, home in enumerate(homes):
        cfg = Config()
        cfg.base.chain_id = doc.chain_id
        cfg.base.blocksync = False  # all start at genesis together
        cfg.p2p.laddr = f"tcp://127.0.0.1:{p2p_port(i)}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc_port(i)}"
        cfg.p2p.persistent_peers = ",".join(
            f"{keys[j].node_id}@127.0.0.1:{p2p_port(j)}"
            for j in range(n) if j != i
        )
        save_config(cfg, _config_path(home))
        doc.save_as(os.path.join(home, "config", "genesis.json"))
    print(f"Generated {n}-node testnet in {args.output}")
    return 0


def cmd_show_node_id(args) -> int:
    from cometbft_tpu_torch.p2p.key import NodeKey

    nk = NodeKey.load_or_gen(
        os.path.join(args.home, "config", "node_key.json"))
    print(nk.node_id)
    return 0


def cmd_reset(args) -> int:
    """reset.go unsafe-reset-all: wipe data, keep config + keys."""
    data = os.path.join(args.home, "data")
    if os.path.isdir(data):
        shutil.rmtree(data)
    os.makedirs(data, exist_ok=True)
    state = os.path.join(args.home, "config", "priv_validator_state.json")
    if os.path.exists(state):
        os.remove(state)
    print(f"Reset {data}")
    return 0


def cmd_rollback(args) -> int:
    """rollback.go: rewind state by one height so the node re-applies
    the last block (e.g. after a bad upgrade produced a wrong app hash).
    With --remove-block the block itself is deleted too."""
    from cometbft_tpu_torch.state.state import StateStore
    from cometbft_tpu_torch.store.blockstore import BlockStore

    data = os.path.join(args.home, "data")
    if not os.path.isdir(data):
        print(f"nothing to roll back (no data dir at {data})")
        return 1
    ss = StateStore(os.path.join(data, "state.db"))
    bs = BlockStore(os.path.join(data, "blockstore.db"))
    state = ss.load()
    if state is None or state.last_block_height < 1:
        print("nothing to roll back")
        return 1
    h = state.last_block_height
    rolled = rollback_state(state, ss, bs)
    ss.save(rolled)
    if args.remove_block:
        bs.remove_block(h)
    print(f"Rolled back state to height {rolled.last_block_height} "
          f"and app hash {rolled.app_hash.hex()}")
    return 0


def rollback_state(state, ss, bs):
    """state/rollback.go Rollback: reconstruct the post-(H-1) state from
    block H's header + the validator-set history."""
    from dataclasses import replace

    h = state.last_block_height
    block = bs.load_block(h)
    if block is None:
        raise SystemExit(f"block {h} not found; cannot roll back")
    prev = bs.load_block(h - 1)
    vals = ss.load_validators(h)
    next_vals = ss.load_validators(h + 1) or state.validators
    last_vals = ss.load_validators(h - 1)
    if vals is None:
        raise SystemExit(f"no validator history for height {h}")
    return replace(
        state,
        last_block_height=h - 1,
        last_block_id=block.header.last_block_id,
        last_block_time=(prev.header.time if prev is not None
                         else state.last_block_time),
        validators=vals,
        next_validators=next_vals,
        last_validators=last_vals,
        app_hash=block.header.app_hash,
        last_results_hash=block.header.last_results_hash,
    )


def cmd_compact(args) -> int:
    """compact.go analog: VACUUM every sqlite database in data/."""
    import sqlite3

    data = os.path.join(args.home, "data")
    n = 0
    for name in sorted(os.listdir(data) if os.path.isdir(data) else []):
        if not name.endswith(".db"):
            continue
        path = os.path.join(data, name)
        before = os.path.getsize(path)
        conn = sqlite3.connect(path)
        conn.execute("VACUUM")
        conn.close()
        after = os.path.getsize(path)
        print(f"{name}: {before} -> {after} bytes")
        n += 1
    print(f"Compacted {n} databases")
    return 0


def cmd_reindex_event(args) -> int:
    """reindex_event.go: rebuild the tx + block indexes from stored
    blocks and FinalizeBlock responses — operator recovery after an
    index wipe or an indexing bug. Node must be stopped (the command
    opens the data dir directly, like the reference)."""
    from cometbft_tpu_torch.abci.types import ExecTxResult
    from cometbft_tpu_torch.state.indexer import BlockIndexer, TxIndexer
    from cometbft_tpu_torch.state.state import StateStore
    from cometbft_tpu_torch.store.blockstore import BlockStore

    data = os.path.join(args.home, "data")
    if not os.path.isdir(data):
        print(f"no data dir at {data}", file=sys.stderr)
        return 1
    bs = BlockStore(os.path.join(data, "blockstore.db"))
    ss = StateStore(os.path.join(data, "state.db"))
    txi = TxIndexer(os.path.join(data, "tx_index.db"))
    bli = BlockIndexer(os.path.join(data, "block_index.db"))
    base, head = bs.base(), bs.height()
    start = max(args.start_height or base, base, 1)
    end = min(args.end_height or head, head)
    if start > end:
        print(f"invalid height range [{start}, {end}] "
              f"(store has [{base}, {head}])", file=sys.stderr)
        return 1
    n_txs = 0
    skipped = 0
    for h in range(start, end + 1):
        block = bs.load_block(h)
        if block is None:
            print(f"height {h}: block missing (pruned?), skipping")
            continue
        doc = ss.load_abci_responses(h)
        results = (doc or {}).get("tx_results", [])
        if block.data.txs and len(results) < len(block.data.txs):
            # never fabricate results: indexing a failed tx as code=0
            # would corrupt tx_search (the reference requires stored
            # ABCI responses for every reindexed height)
            print(f"height {h}: FinalizeBlock responses missing/pruned "
                  f"({len(results)}/{len(block.data.txs)} results); "
                  f"skipping its txs")
            skipped += 1
        else:
            for i, tx in enumerate(block.data.txs):
                rj = results[i]
                res = ExecTxResult(
                    code=rj.get("code", 0),
                    data=bytes.fromhex(rj.get("data", "")),
                    log=rj.get("log", ""),
                    gas_wanted=rj.get("gas_wanted", 0),
                    gas_used=rj.get("gas_used", 0),
                )
                txi.index(h, i, tx, res, rj.get("events") or {})
                n_txs += 1
        bli.index(h, {"block.proposer":
                      [block.header.proposer_address.hex().upper()]})
    for dbh in (bs, ss, txi, bli):
        dbh.close()
    print(f"reindexed heights [{start}, {end}]: {n_txs} txs"
          + (f" ({skipped} heights skipped: no stored results)"
             if skipped else ""))
    return 0


def _debug_collect(rpc_url: str, home: str, out_dir: str) -> list:
    """One debug snapshot: RPC state + config + pprof-analog dumps
    (debug/util.go dumpStatus/dumpNetInfo/dumpConsensusState +
    copyConfig)."""
    import urllib.request

    os.makedirs(out_dir, exist_ok=True)
    wrote = []

    def fetch(path, name):
        try:
            with urllib.request.urlopen(rpc_url + path, timeout=5) as r:
                body = r.read()
            p = os.path.join(out_dir, name)
            with open(p, "wb") as f:
                f.write(body)
            wrote.append(name)
        except Exception as e:  # noqa: BLE001 - collect what we can
            print(f"  {name}: unavailable ({e})")

    fetch("/status", "status.json")
    fetch("/net_info", "net_info.json")
    fetch("/dump_consensus_state", "consensus_state.json")
    fetch("/debug/pprof/goroutine", "stacks.txt")
    fetch("/debug/pprof/heap", "heap.txt")
    cfg = os.path.join(home, "config", "config.toml")
    if os.path.exists(cfg):
        shutil.copy(cfg, os.path.join(out_dir, "config.toml"))
        wrote.append("config.toml")
    return wrote


def cmd_debug(args) -> int:
    """debug.go: `debug kill <pid> <out.zip>` (capture state then kill
    the node) and `debug dump <out-dir>` (periodic snapshots)."""
    import tempfile
    import zipfile

    if args.debug_sub == "kill":
        with tempfile.TemporaryDirectory() as td:
            wrote = _debug_collect(args.rpc_laddr, args.home, td)
            with zipfile.ZipFile(args.out, "w") as z:
                for name in wrote:
                    z.write(os.path.join(td, name), name)
        print(f"wrote {args.out} ({len(wrote)} files)")
        try:
            os.kill(args.pid, signal.SIGTERM)
            print(f"sent SIGTERM to {args.pid}")
        except ProcessLookupError:
            print(f"no such pid {args.pid}", file=sys.stderr)
            return 1
        return 0
    # dump mode: one snapshot per --frequency seconds until --count
    os.makedirs(args.out, exist_ok=True)
    n = 0
    while args.count <= 0 or n < args.count:
        ts = time.strftime("%Y%m%d-%H%M%S")
        out = os.path.join(args.out, ts)
        wrote = _debug_collect(args.rpc_laddr, args.home, out)
        print(f"snapshot {ts}: {len(wrote)} files")
        n += 1
        if args.count > 0 and n >= args.count:
            break
        time.sleep(args.frequency)
    return 0


def cmd_inspect(args) -> int:
    """inspect.go: read-only RPC over a stopped node's data dirs."""
    from cometbft_tpu_torch.inspect import InspectServer

    host, port = _parse_addr(args.laddr)
    srv = InspectServer(os.path.join(args.home, "data"), host, port)
    srv.start()
    print(f"inspect rpc listening on {srv.address} (read-only)")
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop and (args.run_for <= 0
                            or time.time() < args._t0 + args.run_for):
            time.sleep(0.2)
    finally:
        srv.stop()
    return 0


def cmd_light(args) -> int:
    """light.go: run a verifying light-client RPC proxy against a
    primary full node + witnesses."""
    from cometbft_tpu_torch.light.proxy import LightProxy

    resumable = False
    if args.home:
        # durable trust (light/store/db/db.go): a persisted store with a
        # non-expired latest block IS a trust root — no TrustOptions
        # needed on restart
        db_path = os.path.join(args.home, "light.db")
        if os.path.exists(db_path):
            from cometbft_tpu_torch.light.store import DBStore
            from cometbft_tpu_torch.light.verifier import header_expired
            from cometbft_tpu_torch.types.timestamp import Timestamp

            st = DBStore(db_path)
            latest = st.latest()
            st.close()
            resumable = latest is not None and not header_expired(
                latest.signed_header.header, 14 * 24 * 3600.0,
                Timestamp.now(),
            )
    if not args.trusted_hash and not args.insecure_trust and not resumable:
        print("light: refusing to start without --trusted-hash; a "
              "lying primary could pick your trust root. Pass "
              "--insecure-trust to accept trust-on-first-use (dev only), "
              "or point --home at a light store with persisted trust.",
              file=sys.stderr)
        return 1
    if args.trusted_hash and args.trusted_height <= 0:
        print("light: --trusted-hash requires --trusted-height > 0 "
              "(the hash pins a specific header, not 'latest')",
              file=sys.stderr)
        return 1

    host, port = _parse_addr(args.laddr)
    proxy = LightProxy(
        chain_id=args.chain_id,
        primary=args.primary,
        witnesses=[w for w in args.witnesses.split(",") if w],
        trusted_height=args.trusted_height,
        trusted_hash=bytes.fromhex(args.trusted_hash)
        if args.trusted_hash else b"",
        host=host, port=port,
        db_path=(os.path.join(args.home, "light.db")
                 if args.home else None),
        # --insecure-trust also covers mid-run expiry of a persisted
        # root; without it the proxy errors instead of re-rooting TOFU
        insecure_allow_reroot=bool(args.insecure_trust),
    )
    proxy.start()
    print(f"light proxy listening on {proxy.address} "
          f"(primary {args.primary})")
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop and (args.run_for <= 0
                            or time.time() < args._t0 + args.run_for):
            time.sleep(0.2)
    finally:
        proxy.stop()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="cometbft_tpu_torch",
        description="CometBFT on an NVIDIA H100 (PyTorch/CUDA port): BFT "
                    "consensus with signature verification batched on "
                    "the card",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("init", help="initialize a node home directory")
    _home_arg(p)
    p.add_argument("--chain-id", default="")
    p.add_argument("--verifier", default="tpu", choices=["tpu", "cpu"])
    p.set_defaults(fn=cmd_init)

    p = sub.add_parser("start", help="run a node")
    _home_arg(p)
    p.add_argument("--run-for", type=float, default=0,
                   help="exit after N seconds (0 = forever)")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("testnet", help="generate a localhost testnet")
    p.add_argument("--v", type=int, default=4, help="validator count")
    p.add_argument("--output", default="./testnet")
    p.add_argument("--chain-id", default="")
    p.add_argument("--p2p-port", type=int, default=26656)
    p.add_argument("--rpc-port", type=int, default=26657)
    p.set_defaults(fn=cmd_testnet)

    p = sub.add_parser("show-node-id", help="print this node's p2p id")
    _home_arg(p)
    p.set_defaults(fn=cmd_show_node_id)

    p = sub.add_parser("unsafe-reset-all",
                       help="wipe chain data (keeps keys + config)")
    _home_arg(p)
    p.set_defaults(fn=cmd_reset)

    p = sub.add_parser("rollback", help="rewind state by one height")
    _home_arg(p)
    p.add_argument("--remove-block", action="store_true",
                   help="also delete the rolled-back block")
    p.set_defaults(fn=cmd_rollback)

    p = sub.add_parser("compact", help="VACUUM the sqlite databases")
    _home_arg(p)
    p.set_defaults(fn=cmd_compact)

    p = sub.add_parser("inspect",
                       help="read-only RPC over a stopped node's data")
    _home_arg(p)
    p.add_argument("--laddr", default="tcp://127.0.0.1:26661")
    p.add_argument("--run-for", type=float, default=0)
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("reindex-event",
                       help="rebuild tx/block indexes from stored "
                            "blocks (reindex_event.go)")
    _home_arg(p)
    p.add_argument("--start-height", type=int, default=0)
    p.add_argument("--end-height", type=int, default=0)
    p.set_defaults(fn=cmd_reindex_event)

    p = sub.add_parser("debug",
                       help="capture node state for an incident "
                            "(debug.go dump/kill)")
    dsub = p.add_subparsers(dest="debug_sub", required=True)
    q = dsub.add_parser("kill", help="collect state then SIGTERM")
    q.add_argument("pid", type=int)
    q.add_argument("out", help="output zip path")
    _home_arg(q)
    q.add_argument("--rpc-laddr", default="http://127.0.0.1:26657")
    q.set_defaults(fn=cmd_debug)
    q = dsub.add_parser("dump", help="periodic state snapshots")
    q.add_argument("out", help="output directory")
    _home_arg(q)
    q.add_argument("--rpc-laddr", default="http://127.0.0.1:26657")
    q.add_argument("--frequency", type=float, default=30.0)
    q.add_argument("--count", type=int, default=0,
                   help="stop after N snapshots (0 = forever)")
    q.set_defaults(fn=cmd_debug)

    from cometbft_tpu_torch.abci.cli import add_abci_subcommands

    add_abci_subcommands(sub)

    p = sub.add_parser("light", help="verifying light-client RPC proxy")
    p.add_argument("chain_id")
    p.add_argument("--primary", required=True,
                   help="primary full-node RPC url")
    p.add_argument("--witnesses", default="",
                   help="comma-separated witness RPC urls")
    p.add_argument("--trusted-height", type=int, default=0)
    p.add_argument("--trusted-hash", default="")
    p.add_argument("--insecure-trust", action="store_true",
                   help="allow trust-on-first-use without a pinned hash")
    p.add_argument("--home", default="",
                   help="light-client home dir; persists verified trust "
                        "to <home>/light.db (light/store/db)")
    # 8888 like the reference light proxy — NOT in the 2665x node-port
    # range (26658 is the conventional ABCI proxy_app port)
    p.add_argument("--laddr", default="tcp://127.0.0.1:8888")
    p.add_argument("--run-for", type=float, default=0)
    p.set_defaults(fn=cmd_light)

    args = parser.parse_args(argv)
    args._t0 = time.time()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
