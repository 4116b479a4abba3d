"""Evidence reactor: gossips pending evidence to peers.

Reference: evidence/reactor.go — EvidenceChannel 0x38 (:20), broadcast of
evidence lists to peers (:39 broadcastEvidenceRoutine); received evidence
goes through pool.AddEvidence (verify + dedupe) before relay, so invalid
evidence costs the sender its connection and is never amplified.

Both evidence kinds ride this channel: DuplicateVoteEvidence and
LightClientAttackEvidence (the latter carries its conflicting-commit
proof in the wire form, so the receiving pool can re-run
verify_light_client_attack before relaying).
"""
from __future__ import annotations

import json
from typing import List

from cometbft_tpu_torch.evidence.pool import EvidencePool
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.p2p.switch import Peer, Reactor
from cometbft_tpu_torch.types.evidence import (
    EvidenceError,
    evidence_from_j,
    evidence_to_j,
)

EVIDENCE_CHANNEL = 0x38  # evidence/reactor.go:20


class EvidenceReactor(Reactor):
    def __init__(self, pool: EvidencePool):
        super().__init__("EVIDENCE")
        self.pool = pool

    def channel_descriptors(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(EVIDENCE_CHANNEL, priority=6,
                                  send_queue_capacity=100)]

    def add_peer(self, peer: Peer) -> None:
        # send the newcomer everything pending (broadcastEvidenceRoutine
        # walks the clist from the start for each new peer)
        for ev in self.pool.pending_evidence():
            peer.send(EVIDENCE_CHANNEL,
                      json.dumps(evidence_to_j(ev)).encode())

    def broadcast_evidence(self, ev) -> None:
        """Push locally-discovered evidence to every peer (the
        ConsensusState.on_evidence hook)."""
        if self.switch is not None:
            self.switch.broadcast(
                EVIDENCE_CHANNEL, json.dumps(evidence_to_j(ev)).encode()
            )

    def receive(self, chan_id: int, peer: Peer, msg: bytes) -> None:
        try:
            ev = evidence_from_j(json.loads(msg.decode()))
        except Exception as e:  # noqa: BLE001 - undecodable
            self.switch.stop_peer_for_error(peer, f"bad evidence msg: {e}")
            return
        try:
            fresh = self.pool.add_evidence(ev)
        except EvidenceError as e:
            # failed verification = the peer fabricated it
            self.switch.stop_peer_for_error(peer, f"invalid evidence: {e}")
            return
        if fresh:
            self.switch.broadcast(EVIDENCE_CHANNEL, msg)
