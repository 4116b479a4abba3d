"""Mempool reactor: tx gossip with per-peer send state.

Reference: mempool/reactor.go — MempoolChannel 0x30, a per-peer send
loop over the clist that skips txs the peer already has (peers map in
mempool.txs metadata). Here each peer carries a sent/seen set: a tx is
sent to a peer at most once, never echoed to its sender, and a freshly
connected peer is brought up to date with the current pool contents.
"""
from __future__ import annotations

import threading
from typing import List

from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.mempool.mempool import Mempool
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.p2p.switch import Peer, Reactor

MEMPOOL_CHANNEL = 0x30
MAX_SENT_TRACK = 50000  # per-peer send-state cap


class MempoolReactor(Reactor):
    def __init__(self, mempool: Mempool):
        super().__init__("MEMPOOL")
        self.mempool = mempool
        self._sent = {}  # peer -> set of tx hashes sent to / seen from
        self._lock = threading.Lock()

    def channel_descriptors(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(MEMPOOL_CHANNEL, priority=5,
                                  send_queue_capacity=1000)]

    # -- peer lifecycle ----------------------------------------------------

    def add_peer(self, peer: Peer) -> None:
        with self._lock:
            self._sent[peer] = set()
        # bring the newcomer up to date (reactor.go's send loop starts
        # from the clist front for a new peer)
        for tx in self.mempool.reap():
            self._send(peer, tx)

    def remove_peer(self, peer: Peer, reason: str) -> None:
        with self._lock:
            self._sent.pop(peer, None)

    # -- gossip ------------------------------------------------------------

    def _send(self, peer: Peer, tx: bytes) -> None:
        h = tmhash.sum(tx)
        with self._lock:
            sent = self._sent.get(peer)
            if sent is None or h in sent:
                return
            if len(sent) > MAX_SENT_TRACK:
                sent.clear()
            sent.add(h)
        peer.send(MEMPOOL_CHANNEL, tx)

    def broadcast_tx(self, tx: bytes) -> None:
        """Called after a local CheckTx accept (rpc broadcast_tx path)."""
        if self.switch is None:
            return
        with self.switch._peers_lock:
            peers = list(self.switch.peers.values())
        for p in peers:
            self._send(p, tx)

    def receive(self, chan_id: int, peer: Peer, msg: bytes) -> None:
        # the sender has this tx: never echo it back. get(), not
        # setdefault(): a message delivered after remove_peer must not
        # resurrect the dead peer's entry (unbounded leak under churn)
        h = tmhash.sum(msg)
        with self._lock:
            sent = self._sent.get(peer)
            if sent is not None:
                if len(sent) > MAX_SENT_TRACK:
                    sent.clear()
                sent.add(h)
        resp = self.mempool.check_tx(msg)
        # relay only txs WE accepted (first sight): the mempool cache
        # makes repeat deliveries no-ops, bounding the flood
        if resp.code == 0:
            self.broadcast_tx(msg)
