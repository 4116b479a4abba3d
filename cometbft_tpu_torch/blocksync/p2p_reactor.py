"""Blocksync over p2p: the wire protocol around blocksync.reactor.

Reference: blocksync/reactor.go — BlocksyncChannel 0x40 (:59-66),
StatusRequest/StatusResponse/BlockRequest/BlockResponse/NoBlockResponse
messages, poolRoutine requests (:286), SwitchToConsensus (:391-401).

The verification/apply engine stays in blocksync.reactor.BlocksyncReactor
(fused multi-commit device passes); this module is the transport face:
it answers block/status requests from the store and feeds received
blocks/statuses into the pool.
"""
from __future__ import annotations

import json
import threading
import time
from typing import List, Optional

from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.p2p.switch import Peer, Reactor
from cometbft_tpu_torch.store.blockstore import BlockStore
from cometbft_tpu_torch.types import serde

BLOCKSYNC_CHANNEL = 0x40  # blocksync/reactor.go:59 BlocksyncChannel


class BlocksyncP2PReactor(Reactor):
    """p2p face of blocksync: status + block request/response."""

    def __init__(self, engine: Optional[BlocksyncReactor],
                 block_store: BlockStore,
                 status_interval: float = 2.0):
        super().__init__("BLOCKSYNC")
        self.engine = engine  # None on nodes that only SERVE blocks
        self.block_store = block_store
        self.status_interval = status_interval
        self._peers = {}  # peer_id -> Peer
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._status_thread: Optional[threading.Thread] = None
        if engine is not None:
            engine.on_ban = self._on_ban

    def channel_descriptors(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(BLOCKSYNC_CHANNEL, priority=5,
                                  send_queue_capacity=1000,
                                  recv_message_capacity=64 * 1024 * 1024)]

    # -- peer lifecycle ----------------------------------------------------

    def add_peer(self, peer: Peer) -> None:
        with self._lock:
            self._peers[peer.peer_id] = peer
        peer.send(BLOCKSYNC_CHANNEL, json.dumps({"t": "status_req"}).encode())
        peer.send(BLOCKSYNC_CHANNEL, self._status_bytes())
        if self._status_thread is None and self.engine is not None:
            self._status_thread = threading.Thread(
                target=self._status_routine, daemon=True, name="bs-status"
            )
            self._status_thread.start()

    def remove_peer(self, peer: Peer, reason: str) -> None:
        with self._lock:
            self._peers.pop(peer.peer_id, None)
        if self.engine is not None:
            self.engine.pool.remove_peer(peer.peer_id)

    # -- outbound ----------------------------------------------------------

    def _status_bytes(self) -> bytes:
        return json.dumps({
            "t": "status",
            "base": self.block_store.base(),
            "height": self.block_store.height(),
        }).encode()

    def _status_routine(self) -> None:
        """Re-poll peer statuses while syncing (poolRoutine's ticker)."""
        while not self._stop.is_set():
            time.sleep(self.status_interval)
            if self.engine is None or not self.engine.is_running():
                return
            with self._lock:
                peers = list(self._peers.values())
            for p in peers:
                p.send(BLOCKSYNC_CHANNEL,
                       json.dumps({"t": "status_req"}).encode())

    def _send_request(self, peer_id: str, height: int) -> None:
        with self._lock:
            peer = self._peers.get(peer_id)
        if peer is not None:
            peer.send(BLOCKSYNC_CHANNEL,
                      json.dumps({"t": "block_req", "h": height}).encode())

    def _on_ban(self, peer_id: str) -> None:
        with self._lock:
            peer = self._peers.get(peer_id)
        if peer is not None and self.switch is not None:
            self.switch.stop_peer_for_error(peer, "blocksync: bad block")

    def stop_routines(self) -> None:
        self._stop.set()

    # -- inbound -----------------------------------------------------------

    def receive(self, chan_id: int, peer: Peer, msg: bytes) -> None:
        try:
            j = json.loads(msg.decode())
            t = j.get("t")
            if t == "status_req":
                peer.send(BLOCKSYNC_CHANNEL, self._status_bytes())
            elif t == "status":
                if self.engine is not None:
                    self.engine.add_peer(
                        peer.peer_id, int(j["height"]),
                        lambda h, pid=peer.peer_id: self._send_request(
                            pid, h
                        ),
                    )
            elif t == "block_req":
                h = int(j["h"])
                block = self.block_store.load_block(h)
                if block is None:
                    peer.send(BLOCKSYNC_CHANNEL, json.dumps(
                        {"t": "no_block", "h": h}
                    ).encode())
                else:
                    peer.send(BLOCKSYNC_CHANNEL, json.dumps({
                        "t": "block", "h": h,
                        "b": json.loads(serde.block_to_json(block)),
                    }).encode())
            elif t == "block":
                if self.engine is not None:
                    block = serde.block_from_json(json.dumps(j["b"]))
                    self.engine.receive_block(peer.peer_id, block)
            elif t == "no_block":
                # peer can't serve this height: let the pool re-route
                if self.engine is not None:
                    self.engine.pool.redo_block(int(j["h"]))
            else:
                raise ValueError(f"unknown blocksync message {t!r}")
        except Exception as e:  # noqa: BLE001 - malformed peer message
            self.switch.stop_peer_for_error(peer, f"bad blocksync msg: {e}")
