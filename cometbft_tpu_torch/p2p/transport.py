"""Transport: TCP listener/dialer with the upgrade-to-secret handshake.

Reference: p2p/transport.go — MultiplexTransport: Listen/Accept/Dial,
upgrade (secret conn + NodeInfo exchange + filters), handshake timeouts.
"""
from __future__ import annotations

import socket
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.p2p.conn.secret_connection import SecretConnection
from cometbft_tpu_torch.p2p.key import NetAddress, NodeInfo, NodeKey

# Generous by design: the secret-connection handshake runs pure-Python
# X25519/ed25519 on this image (no `cryptography` wheel), and CI hosts
# run the whole multi-node suite on one core — a loaded host can spend
# several seconds per handshake. 10 s flaked under parallel host load;
# the timeout only bounds genuinely dead peers, so erring long is free.
HANDSHAKE_TIMEOUT = 30.0

fp.register("p2p.handshake",
            "secret-conn established, NodeInfo not yet exchanged "
            "(raise = mid-handshake connection drop)")


class TransportError(Exception):
    pass


@dataclass
class UpgradedConn:
    """A fully handshaken peer connection."""

    sconn: SecretConnection
    node_info: NodeInfo
    outbound: bool
    remote_addr: str


class Transport:
    def __init__(self, node_key: NodeKey, node_info: NodeInfo,
                 on_conn: Callable[[UpgradedConn], None]):
        self.node_key = node_key
        self.node_info = node_info
        self.on_conn = on_conn
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- listening ---------------------------------------------------------

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> NetAddress:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(64)
        self._listener = s
        self.node_info.listen_addr = f"{host}:{s.getsockname()[1]}"
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="p2p-accept"
        )
        self._accept_thread.start()
        return NetAddress(self.node_key.node_id, host, s.getsockname()[1])

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                raw, addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._upgrade_safe, args=(raw, addr, False),
                daemon=True,
            ).start()

    def _upgrade_safe(self, raw, addr, outbound: bool) -> None:
        try:
            conn = self._upgrade(raw, outbound, f"{addr[0]}:{addr[1]}")
        except Exception:  # noqa: BLE001 - bad peer, drop silently
            try:
                raw.close()
            except OSError:
                pass
            return
        self.on_conn(conn)

    # -- dialing -----------------------------------------------------------

    def dial(self, addr: NetAddress) -> UpgradedConn:
        raw = socket.create_connection(
            (addr.host, addr.port), timeout=HANDSHAKE_TIMEOUT
        )
        conn = self._upgrade(raw, True, addr.dial_string,
                             expect_id=addr.node_id)
        self.on_conn(conn)
        return conn

    # -- the upgrade -------------------------------------------------------

    def _upgrade(self, raw: socket.socket, outbound: bool,
                 remote_addr: str, expect_id: Optional[str] = None
                 ) -> UpgradedConn:
        raw.settimeout(HANDSHAKE_TIMEOUT)
        sconn = SecretConnection.handshake(raw, self.node_key.priv_key)
        fp.fail_point("p2p.handshake")
        # authenticate the dialed ID against the secret-conn identity
        # (transport.go upgrade: ErrRejected w/ isAuthFailure)
        actual_id = sconn.remote_pub.address().hex()
        if expect_id is not None and actual_id != expect_id:
            raise TransportError(
                f"dialed {expect_id} but peer authenticated as {actual_id}"
            )
        # NodeInfo exchange
        sconn.write_msg(self.node_info.to_json().encode())
        their_info = NodeInfo.from_json(sconn.read_msg().decode())
        if their_info.node_id != actual_id:
            raise TransportError("node_info id != authenticated id")
        err = self.node_info.compatible_with(their_info)
        if err:
            raise TransportError(f"incompatible peer: {err}")
        raw.settimeout(None)
        return UpgradedConn(sconn, their_info, outbound, remote_addr)

    def close(self) -> None:
        self._stop.set()
        if self._listener:
            try:
                self._listener.close()
            except OSError:
                pass
