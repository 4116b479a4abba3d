"""ABCI socket server + client: run the application out of process.

Reference: abci/server/socket_server.go + abci/client/socket_client.go —
a length-prefixed request/response stream over TCP (or unix) sockets;
the node side exposes the same Application interface so BlockExecutor /
Mempool don't know whether the app is in-process.

Wire format here: 4-byte big-endian length + JSON body (bytes fields
base64). The reference's protobuf framing is an implementation detail of
its Go codebase, not a consensus-critical encoding; what matters is the
14-method surface and the strict request/response ordering, which the
client preserves with a connection mutex exactly like the reference's
socket client.

The port's copy of the JAX package's abci/server.py: the same framing
byte for byte, so either package's client talks to the other's server.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import socket
import struct
import threading
from typing import Any, Optional

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.libs.service import BaseService


def _enc(obj: Any):
    if dataclasses.is_dataclass(obj):
        return {k: _enc(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (bytes, bytearray)):
        return {"__b": base64.b64encode(bytes(obj)).decode()}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    return obj


def _dec(obj: Any):
    if isinstance(obj, dict):
        if set(obj.keys()) == {"__b"}:
            return base64.b64decode(obj["__b"])
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


def _send_msg(conn: socket.socket, doc: dict) -> None:
    body = json.dumps(doc).encode()
    conn.sendall(struct.pack(">I", len(body)) + body)


def _recv_msg(conn: socket.socket) -> Optional[dict]:
    hdr = b""
    while len(hdr) < 4:
        chunk = conn.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack(">I", hdr)
    body = b""
    while len(body) < n:
        chunk = conn.recv(min(1 << 20, n - len(body)))
        if not chunk:
            return None
        body += chunk
    return json.loads(body.decode())


# request constructor + response type per method
_METHODS = {
    "info": (abci.RequestInfo, abci.ResponseInfo),
    "init_chain": (abci.RequestInitChain, abci.ResponseInitChain),
    "check_tx": (abci.RequestCheckTx, abci.ResponseCheckTx),
    "prepare_proposal": (abci.RequestPrepareProposal,
                         abci.ResponsePrepareProposal),
    "process_proposal": (abci.RequestProcessProposal,
                         abci.ResponseProcessProposal),
    "finalize_block": (abci.RequestFinalizeBlock,
                       abci.ResponseFinalizeBlock),
    "commit": (None, abci.ResponseCommit),
    "query": (abci.RequestQuery, abci.ResponseQuery),
    "extend_vote": (abci.RequestExtendVote, abci.ResponseExtendVote),
    "verify_vote_extension": (abci.RequestVerifyVoteExtension,
                              abci.ResponseVerifyVoteExtension),
}

# plain-argument methods (the snapshot family takes positional args,
# not request dataclasses): name -> (args_rebuild, resp_rebuild)
_ARG_METHODS = {
    "list_snapshots": (None,
                       lambda r: [abci.Snapshot(**s) for s in r]),
    "offer_snapshot": (lambda a: [abci.Snapshot(**a[0])], None),
    "load_snapshot_chunk": (None, None),
    "apply_snapshot_chunk": (
        None,
        lambda r: r if isinstance(r, bool)
        else abci.ResponseApplySnapshotChunk(**r),
    ),
}


def _rebuild(cls, doc):
    """Dataclass from decoded dict, recursing into typed list fields."""
    if cls is abci.ResponseQuery:
        from cometbft_tpu_torch.crypto.proof_ops import ProofOp

        ops = doc.pop("proof_ops", None) or []
        resp = abci.ResponseQuery(**doc)
        resp.proof_ops = [ProofOp(**o) for o in ops]
        return resp
    if cls is abci.ResponseFinalizeBlock:
        return abci.ResponseFinalizeBlock(
            tx_results=[abci.ExecTxResult(**r) for r in doc["tx_results"]],
            validator_updates=[
                abci.ValidatorUpdate(**u) for u in doc["validator_updates"]
            ],
            app_hash=doc["app_hash"],
        )
    if cls is abci.ResponseInitChain:
        return abci.ResponseInitChain(
            validators=[abci.ValidatorUpdate(**u)
                        for u in doc.get("validators", [])],
            app_hash=doc.get("app_hash", b""),
        )
    if cls is abci.RequestPrepareProposal:
        llc = doc.get("local_last_commit")
        return abci.RequestPrepareProposal(
            max_tx_bytes=doc.get("max_tx_bytes", 0),
            txs=doc.get("txs", []),
            height=doc.get("height", 0),
            proposer_address=doc.get("proposer_address", b""),
            local_last_commit=(abci.ExtendedCommitInfo(
                round=llc["round"],
                votes=[abci.ExtendedVoteInfo(**v) for v in llc["votes"]],
            ) if llc else None),
        )
    if cls is abci.RequestFinalizeBlock:
        dlc = doc.get("decided_last_commit")
        return abci.RequestFinalizeBlock(
            txs=doc.get("txs", []),
            hash=doc.get("hash", b""),
            height=doc.get("height", 0),
            proposer_address=doc.get("proposer_address", b""),
            time_seconds=doc.get("time_seconds", 0),
            decided_last_commit=(abci.CommitInfo(
                round=dlc["round"],
                votes=[abci.VoteInfo(**v) for v in dlc["votes"]],
            ) if dlc else None),
            misbehavior=[abci.Misbehavior(**m)
                         for m in doc.get("misbehavior", [])],
        )
    if cls is abci.RequestInitChain:
        return abci.RequestInitChain(
            time_seconds=doc.get("time_seconds", 0),
            chain_id=doc.get("chain_id", ""),
            validators=[abci.ValidatorUpdate(**u)
                        for u in doc.get("validators", [])],
            app_state_bytes=doc.get("app_state_bytes", b""),
            initial_height=doc.get("initial_height", 1),
        )
    return cls(**doc)


class ABCISocketServer(BaseService):
    """abci/server/socket_server.go: serve an Application over a socket."""

    def __init__(self, app: abci.Application, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__("ABCISocketServer")
        self.app = app
        self._listener = socket.create_server((host, port))
        self.addr = self._listener.getsockname()
        self._threads = []
        # one request at a time across ALL connections: ABCI apps are
        # not required to be concurrency-safe (local_client.go mutex)
        self._app_lock = threading.Lock()

    def on_start(self) -> None:
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="abci-accept")
        t.start()
        self._threads.append(t)

    def on_stop(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while self.is_running():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="abci-conn")
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while self.is_running():
                try:
                    req = _recv_msg(conn)
                except OSError:
                    return
                if req is None:
                    return
                method = req.get("m")
                spec = _METHODS.get(method)
                argspec = _ARG_METHODS.get(method)
                if spec is None and argspec is None:
                    _send_msg(conn, {"err": f"unknown method {method!r}"})
                    continue
                try:
                    with self._app_lock:
                        fn = getattr(self.app, method)
                        if argspec is not None:
                            args = _dec(req.get("a", []))
                            if argspec[0] is not None:
                                args = argspec[0](args)
                            resp = fn(*args)
                        elif spec[0] is None:
                            resp = fn()
                        else:
                            resp = fn(_rebuild(spec[0], _dec(req["q"])))
                    _send_msg(conn, {"r": _enc(resp)})
                except Exception as e:  # noqa: BLE001 - surface app error
                    _send_msg(conn, {"err": repr(e)})


class ABCISocketClient(abci.Application):
    """abci/client/socket_client.go: an Application proxy over a socket.

    Implements the same interface the in-process app does, so Node /
    BlockExecutor / Mempool are agnostic to the process boundary
    (proxy.AppConns' role; all four logical connections share this one
    socket under a mutex, like the reference's local client)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._conn = socket.create_connection((host, port),
                                              timeout=timeout)
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass

    def _call(self, method: str, req=None):
        req_cls, resp_cls = _METHODS[method]
        doc = {"m": method}
        if req_cls is not None:
            doc["q"] = _enc(req)
        with self._lock:
            _send_msg(self._conn, doc)
            resp = _recv_msg(self._conn)
        if resp is None:
            raise ConnectionError("abci socket closed")
        if "err" in resp:
            raise RuntimeError(f"abci app error: {resp['err']}")
        return _rebuild(resp_cls, _dec(resp["r"]))

    def info(self, req):
        return self._call("info", req)

    def init_chain(self, req):
        return self._call("init_chain", req)

    def check_tx(self, req):
        return self._call("check_tx", req)

    def prepare_proposal(self, req):
        return self._call("prepare_proposal", req)

    def process_proposal(self, req):
        return self._call("process_proposal", req)

    def finalize_block(self, req):
        return self._call("finalize_block", req)

    def commit(self):
        return self._call("commit")

    def query(self, req):
        return self._call("query", req)

    def extend_vote(self, req):
        return self._call("extend_vote", req)

    def verify_vote_extension(self, req):
        return self._call("verify_vote_extension", req)

    # snapshot family: positional-arg wire form (_ARG_METHODS)
    def _call_args(self, method: str, *args):
        resp_fix = _ARG_METHODS[method][1]
        with self._lock:
            _send_msg(self._conn, {"m": method, "a": _enc(list(args))})
            resp = _recv_msg(self._conn)
        if resp is None:
            raise ConnectionError("abci socket closed")
        if "err" in resp:
            raise RuntimeError(f"abci app error: {resp['err']}")
        r = _dec(resp["r"])
        return resp_fix(r) if resp_fix else r

    def list_snapshots(self):
        return self._call_args("list_snapshots")

    def offer_snapshot(self, snapshot):
        return self._call_args("offer_snapshot", snapshot)

    def load_snapshot_chunk(self, height, fmt, chunk):
        return self._call_args("load_snapshot_chunk", height, fmt, chunk)

    def apply_snapshot_chunk(self, index, chunk, sender):
        return self._call_args("apply_snapshot_chunk", index, chunk,
                               sender)
