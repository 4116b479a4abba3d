"""Switch: peer lifecycle + reactor registry + broadcast.

Reference: p2p/switch.go — AddReactor wires channel IDs to reactors
(:86-101), addPeer attaches the peer to every reactor (:711), Broadcast
(:280), StopPeerForError (:338), DialPeersAsync with persistent-peer
redial. The Peer here owns one MConnection over the upgraded secret
connection (p2p/peer.go).
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.p2p import peerledger
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor, MConnection
from cometbft_tpu_torch.p2p.key import NetAddress, NodeInfo, NodeKey
from cometbft_tpu_torch.p2p.transport import Transport, UpgradedConn

_log = logging.getLogger(__name__)

fp.register("p2p.dial",
            "outbound dial about to start (raise/flake = dial failure)")


class Reactor:
    """Base reactor (p2p/base_reactor.go). Subclasses declare
    channel_descriptors() and handle receive()."""

    def __init__(self, name: str):
        self.name = name
        self.switch: Optional["Switch"] = None

    def channel_descriptors(self) -> List[ChannelDescriptor]:
        return []

    def add_peer(self, peer: "Peer") -> None:
        pass

    def remove_peer(self, peer: "Peer", reason: str) -> None:
        pass

    def receive(self, chan_id: int, peer: "Peer", msg: bytes) -> None:
        pass


class Peer:
    """One connected peer: identity + its multiplexed connection."""

    def __init__(self, sw: "Switch", up: UpgradedConn,
                 channels: List[ChannelDescriptor]):
        self.switch = sw
        self.node_info = up.node_info
        self.peer_id = up.node_info.node_id
        self.outbound = up.outbound
        self.remote_addr = up.remote_addr
        # gossip observatory: one ledger record per peer, shared with
        # the MConnection's send/recv routines (p2p/peerledger.py)
        self.ledger_rec = sw.peer_ledger.open_peer(
            self.peer_id[:12], up.outbound)
        self.mconn = MConnection(
            up.sconn, channels,
            on_receive=self._on_receive,
            on_error=self._on_error,
            ledger_rec=self.ledger_rec,
        )
        self._data: Dict[str, object] = {}  # reactor scratch (PeerState)

    def start(self) -> None:
        self.mconn.start()

    def stop(self) -> None:
        self.mconn.stop()

    def send(self, chan_id: int, msg: bytes) -> bool:
        return self.mconn.send(chan_id, msg, block=False)

    def set(self, key: str, val) -> None:
        self._data[key] = val

    def get(self, key: str):
        return self._data.get(key)

    def _on_receive(self, chan_id: int, msg: bytes) -> None:
        reactor = self.switch.reactor_by_channel.get(chan_id)
        if reactor is not None:
            reactor.receive(chan_id, self, msg)

    def _on_error(self, e: Exception) -> None:
        self.switch.stop_peer_for_error(self, str(e))


class Switch(BaseService):
    def __init__(self, node_key: NodeKey, network: str,
                 moniker: str = "node"):
        super().__init__("Switch")
        self.node_key = node_key
        self.reactors: Dict[str, Reactor] = {}
        self.reactor_by_channel: Dict[int, Reactor] = {}
        self.channel_descs: List[ChannelDescriptor] = []
        self.peers: Dict[str, Peer] = {}
        self._peers_lock = threading.Lock()
        self.persistent: Dict[str, NetAddress] = {}
        self.node_info = NodeInfo(
            node_id=node_key.node_id, network=network, moniker=moniker,
        )
        self.transport = Transport(node_key, self.node_info, self._on_conn)
        self.listen_addr: Optional[NetAddress] = None
        self._redial_thread: Optional[threading.Thread] = None
        # gossip observatory (/dump_peers): always on, like the flush
        # and height ledgers
        self.peer_ledger = peerledger.PeerLedger()

    # -- wiring ------------------------------------------------------------

    def add_reactor(self, reactor: Reactor) -> None:
        """AddReactor (switch.go:86): channel IDs must be unique."""
        for d in reactor.channel_descriptors():
            if d.chan_id in self.reactor_by_channel:
                raise ValueError(f"channel {d.chan_id} already claimed")
            self.reactor_by_channel[d.chan_id] = reactor
            self.channel_descs.append(d)
            self.node_info.channels.append(d.chan_id)
        self.reactors[reactor.name] = reactor
        reactor.switch = self

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> NetAddress:
        self.listen_addr = self.transport.listen(host, port)
        return self.listen_addr

    def on_start(self) -> None:
        peerledger.set_global_ledger(self.peer_ledger)
        self._redial_thread = threading.Thread(
            target=self._redial_loop, daemon=True, name="p2p-redial"
        )
        self._redial_thread.start()

    def on_stop(self) -> None:
        self.transport.close()
        with self._peers_lock:
            peers = list(self.peers.values())
        for p in peers:
            p.stop()
            self.peer_ledger.drop_peer(p.ledger_rec, "switch_stop")
        # keep serving history via the module _LAST fallback
        peerledger.clear_global_ledger(self.peer_ledger)

    # -- peer lifecycle ----------------------------------------------------

    def _on_conn(self, up: UpgradedConn) -> None:
        pid = up.node_info.node_id
        with self._peers_lock:
            dup = pid in self.peers or pid == self.node_key.node_id
        if dup:
            # reject BEFORE Peer() opens a ledger record: open_peer's
            # replace semantics would otherwise retire the SURVIVING
            # connection's live record
            try:
                up.sconn._stream.close()
            except Exception:  # noqa: BLE001 - already closing
                pass
            self.peer_ledger.lifecycle(peerledger.EV_DROP, pid[:12],
                                       "duplicate")
            return
        peer = Peer(self, up, self.channel_descs)
        with self._peers_lock:
            if peer.peer_id in self.peers:
                peer.mconn.conn._stream.close()
                self.peer_ledger.drop_peer(peer.ledger_rec, "duplicate")
                return
            self.peers[peer.peer_id] = peer
        peer.start()
        for r in self.reactors.values():
            r.add_peer(peer)
        _log.info("peer %s connected (%s)", peer.peer_id[:12],
                  "out" if peer.outbound else "in")

    def dial_peer(self, addr: NetAddress, persistent: bool = False) -> None:
        if persistent:
            self.persistent[addr.node_id] = addr
        with self._peers_lock:
            if addr.node_id in self.peers:
                return
        self.peer_ledger.lifecycle(peerledger.EV_DIAL,
                                   addr.node_id[:12], str(addr))
        try:
            fp.fail_point("p2p.dial")
            self.transport.dial(addr)
        except Exception as e:  # noqa: BLE001
            self.peer_ledger.lifecycle(peerledger.EV_DIAL_FAIL,
                                       addr.node_id[:12], str(e)[:80])
            _log.warning("dial %s failed: %s", addr, e)

    def dial_peers_async(self, addrs: List[NetAddress],
                         persistent: bool = True) -> None:
        for a in addrs:
            threading.Thread(
                target=self.dial_peer, args=(a, persistent), daemon=True
            ).start()

    def stop_peer_for_error(self, peer: Peer, reason: str) -> None:
        """switch.go:338 StopPeerForError; persistent peers get redialed
        by the redial loop."""
        with self._peers_lock:
            if self.peers.get(peer.peer_id) is not peer:
                return
            del self.peers[peer.peer_id]
        peer.stop()
        self.peer_ledger.drop_peer(peer.ledger_rec, reason)
        for r in self.reactors.values():
            r.remove_peer(peer, reason)
        _log.info("peer %s stopped: %s", peer.peer_id[:12], reason)

    # redial backoff knobs (p2p/switch.go reconnectToPeer: exponential
    # backoff with jitter — without the jitter, every peer of a healed
    # partition redials the same instant and the accept queues thundering-
    # herd; the simnet's heal schedules exposed exactly that)
    REDIAL_BASE = 0.25
    REDIAL_MAX = 10.0

    @staticmethod
    def _next_backoff(delay: float, rng=random):
        """(jittered wait, new base delay) after a failure: exponential
        growth capped at REDIAL_MAX, plus up to 50% random jitter so
        concurrently-failing dialers decorrelate."""
        base = min(Switch.REDIAL_MAX,
                   max(Switch.REDIAL_BASE, delay * 2.0))
        return base * (1.0 + 0.5 * rng.random()), base

    def _redial_loop(self) -> None:
        # node_id -> (next attempt monotonic time, current base delay)
        backoff: Dict[str, tuple] = {}
        while self.is_running():
            now = time.monotonic()
            for node_id, addr in list(self.persistent.items()):
                with self._peers_lock:
                    have = node_id in self.peers
                if have:
                    backoff.pop(node_id, None)
                    continue
                next_try, delay = backoff.get(node_id, (0.0, 0.0))
                if now < next_try:
                    continue
                try:
                    fp.fail_point("p2p.dial")
                    self.transport.dial(addr)
                    backoff.pop(node_id, None)
                except Exception:  # noqa: BLE001
                    wait, base = self._next_backoff(delay)
                    backoff[node_id] = (time.monotonic() + wait, base)
            time.sleep(0.1)

    # -- messaging ---------------------------------------------------------

    def broadcast(self, chan_id: int, msg: bytes,
                  except_peer=None) -> None:
        """Send to every peer (switch.go Broadcast); `except_peer` skips
        the originator when relaying flood-gossiped messages."""
        with self._peers_lock:
            peers = list(self.peers.values())
        for p in peers:
            if p is except_peer:
                continue
            p.send(chan_id, msg)

    def num_peers(self) -> int:
        with self._peers_lock:
            return len(self.peers)
