"""Node identity: ed25519 node key; ID = address hex.

Reference: p2p/key.go (NodeKey: persisted ed25519 key; ID() =
hex(address(pubkey)) — p2p/key.go:35), p2p/node_info.go (DefaultNodeInfo
exchanged during handshake, CompatibleWith checks).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

from cometbft_tpu_torch.crypto.keys import PrivKey


class NodeKey:
    def __init__(self, priv_key: PrivKey):
        self.priv_key = priv_key

    @property
    def node_id(self) -> str:
        """ID = hex of the 20-byte address of the node pubkey."""
        return self.priv_key.pub_key().address().hex()

    @staticmethod
    def load_or_gen(path: Optional[str] = None,
                    seed: Optional[bytes] = None) -> "NodeKey":
        if path and os.path.exists(path):
            with open(path) as f:
                j = json.load(f)
            return NodeKey(PrivKey(bytes.fromhex(j["priv_key"])))
        nk = NodeKey(PrivKey.generate(seed))
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # private key material: 0600, like the reference's key files
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "w") as f:
                json.dump({"id": nk.node_id,
                           "priv_key": nk.priv_key.data.hex()}, f)
        return nk


@dataclass
class NodeInfo:
    """Handshake identity card (p2p/node_info.go DefaultNodeInfo)."""

    node_id: str = ""
    listen_addr: str = ""
    network: str = ""          # chain id
    version: str = "cometbft-tpu/0.2"
    channels: List[int] = field(default_factory=list)
    moniker: str = ""

    def to_json(self) -> str:
        return json.dumps({
            "node_id": self.node_id, "listen_addr": self.listen_addr,
            "network": self.network, "version": self.version,
            "channels": self.channels, "moniker": self.moniker,
        })

    @staticmethod
    def from_json(s: str) -> "NodeInfo":
        j = json.loads(s)
        return NodeInfo(
            j["node_id"], j["listen_addr"], j["network"], j["version"],
            list(j["channels"]), j.get("moniker", ""),
        )

    def compatible_with(self, other: "NodeInfo") -> Optional[str]:
        """CompatibleWith (p2p/node_info.go:215): same network, at least
        one common channel. Returns an error string or None."""
        if self.network != other.network:
            return f"different network: {other.network} != {self.network}"
        if not set(self.channels) & set(other.channels):
            return "no common channels"
        return None


@dataclass(frozen=True)
class NetAddress:
    """id@host:port (p2p/netaddress.go)."""

    node_id: str
    host: str
    port: int

    def __str__(self) -> str:
        return f"{self.node_id}@{self.host}:{self.port}"

    @staticmethod
    def parse(s: str) -> "NetAddress":
        node_id, rest = s.split("@", 1)
        host, port = rest.rsplit(":", 1)
        return NetAddress(node_id, host, int(port))

    @property
    def dial_string(self) -> str:
        return f"{self.host}:{self.port}"
