"""Remote signer: keep validator keys in a separate process (HSM shape).

Reference: privval/signer_listener_endpoint.go:223 (the NODE listens and
the signer dials in — the usual HSM deployment), signer_client.go (the
PrivValidator proxy the consensus engine holds), signer_server.go +
signer_dialer_endpoint.go (the key-holding side).

Protocol: the JSON length-prefixed framing shared with the ABCI socket
layer; requests pub_key / sign_vote / sign_proposal, the signer answers
with the signature or a remote error (double-sign protection runs ON THE
SIGNER, where the key and last-sign state live).

The port's copy of the JAX package's privval/remote.py: the same
requests over abci/server.py's framing, so either package's endpoint
serves the other's signer.
"""
from __future__ import annotations

import socket
import threading
from typing import Optional

from cometbft_tpu_torch.abci.server import _recv_msg, _send_msg
from cometbft_tpu_torch.crypto.keys import PubKey
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.types import serde
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.vote import Vote


class RemoteSignerError(Exception):
    pass


class SignerListenerEndpoint:
    """Node-side PrivValidator proxy (signer_listener_endpoint.go:223 +
    signer_client.go): listens, accepts the signer's dial-in, then
    forwards signing requests over the connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 10.0):
        self._listener = socket.create_server((host, port))
        self.addr = self._listener.getsockname()
        self.timeout = timeout
        self._conn: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept, daemon=True, name="privval-accept"
        )
        self._connected = threading.Event()
        self._accept_thread.start()
        self._cached_pub: Optional[PubKey] = None

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                if self._conn is not None:
                    try:
                        self._conn.close()
                    except OSError:
                        pass
                conn.settimeout(self.timeout)
                self._conn = conn
            self._connected.set()

    def wait_for_signer(self, timeout: float = 10.0) -> bool:
        return self._connected.wait(timeout)

    def close(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            if self._conn is not None:
                self._conn.close()

    def _call(self, doc: dict) -> dict:
        with self._lock:
            if self._conn is None:
                raise RemoteSignerError("no signer connected")
            try:
                _send_msg(self._conn, doc)
                resp = _recv_msg(self._conn)
            except OSError as e:
                raise RemoteSignerError(f"signer io error: {e}") from e
        if resp is None:
            raise RemoteSignerError("signer disconnected")
        if "err" in resp:
            raise RemoteSignerError(resp["err"])
        return resp

    # -- PrivValidator surface --------------------------------------------

    def pub_key(self) -> PubKey:
        if self._cached_pub is None:
            r = self._call({"m": "pub_key"})
            self._cached_pub = PubKey(bytes.fromhex(r["pub"]), r["type"])
        return self._cached_pub

    def sign_vote(self, chain_id: str, vote: Vote,
                  sign_extension: bool = False) -> bytes:
        r = self._call({
            "m": "sign_vote", "chain_id": chain_id,
            "vote": serde.vote_to_j(vote),
            "sign_extension": sign_extension,
        })
        # the extension signature is produced signer-side and travels
        # back alongside the vote signature
        vote.extension_signature = bytes.fromhex(r.get("ext_sig", ""))
        return bytes.fromhex(r["sig"])

    def sign_proposal(self, chain_id: str, height: int, round_: int,
                      pol_round: int, block_id: BlockID,
                      ts: Timestamp) -> bytes:
        r = self._call({
            "m": "sign_proposal", "chain_id": chain_id, "height": height,
            "round": round_, "pol_round": pol_round,
            "block_id": serde.bid_to_j(block_id),
            "ts": serde.ts_to_j(ts),
        })
        return bytes.fromhex(r["sig"])


class SignerServer(BaseService):
    """Key-holding side (signer_server.go): dials the node and serves
    signing requests from a local FilePV (which enforces the double-sign
    protection next to the key)."""

    def __init__(self, privval, host: str, port: int,
                 retry_interval: float = 0.5):
        super().__init__("SignerServer")
        self.privval = privval
        self.host, self.port = host, port
        self.retry_interval = retry_interval
        self._thread: Optional[threading.Thread] = None

    def on_start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="signer-server"
        )
        self._thread.start()

    def on_stop(self) -> None:
        if self._thread:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        import time

        while self.is_running():
            try:
                conn = socket.create_connection(
                    (self.host, self.port), timeout=5.0
                )
            except OSError:
                time.sleep(self.retry_interval)
                continue
            try:
                self._serve(conn)
            except OSError:
                pass
            finally:
                conn.close()

    def _serve(self, conn: socket.socket) -> None:
        conn.settimeout(0.5)
        while self.is_running():
            try:
                req = _recv_msg(conn)
            except socket.timeout:
                continue
            if req is None:
                return
            try:
                resp = self._handle(req)
            except Exception as e:  # noqa: BLE001 - incl. DoubleSignError
                resp = {"err": repr(e)}
            _send_msg(conn, resp)

    def _handle(self, req: dict) -> dict:
        m = req.get("m")
        if m == "pub_key":
            pub = self.privval.pub_key()
            return {"pub": pub.data.hex(), "type": pub.key_type}
        if m == "sign_vote":
            vote = serde.vote_from_j(req["vote"])
            sig = self.privval.sign_vote(
                req["chain_id"], vote,
                sign_extension=bool(req.get("sign_extension")),
            )
            return {"sig": sig.hex(),
                    "ext_sig": vote.extension_signature.hex()}
        if m == "sign_proposal":
            sig = self.privval.sign_proposal(
                req["chain_id"], req["height"], req["round"],
                req["pol_round"], serde.bid_from_j(req["block_id"]),
                serde.ts_from_j(req["ts"]),
            )
            return {"sig": sig.hex()}
        raise RemoteSignerError(f"unknown request {m!r}")
