"""Statesync over p2p: snapshot discovery + chunk transfer.

Reference: statesync/reactor.go — SnapshotChannel 0x60 / ChunkChannel
0x61, SnapshotsRequest/SnapshotsResponse, ChunkRequest/ChunkResponse.
Serving side answers from the local app; syncing side feeds the Syncer.

PR 18 puts the serving side on the overload contract: every inbound
``snapshots_req``/``chunk_req`` passes the :class:`ServeGate` (a
per-peer token bucket on the ledger clock) and over-budget requests
are answered with EXPLICIT retry-hinted sheds (``chunk_shed`` /
``snapshots_shed`` messages carrying ``retry_after_ms``) instead of
silence — a donor under bootstrap storm degrades honestly, and its
CONSENSUS lane is structurally untouchable because serving work never
enters the verify plane's consensus lane at all. Served chunks carry
merkle inclusion proofs (statesync/snapshots.py) so the restoring peer
verifies each chunk on arrival and punishes only the sender of a bad
one.
"""
from __future__ import annotations

import base64
import json
import threading
import time
from typing import List, Optional

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.p2p.switch import Peer, Reactor
from cometbft_tpu_torch.statesync import stats as ss_stats
from cometbft_tpu_torch.statesync.snapshots import (
    ServeGate,
    SnapshotArchive,
    SnapshotCatalog,
    SnapshotServeOverloaded,
    proof_doc,
    verify_chunk,
)

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61

# bounded client-side honoring of a donor's retry hint: one chunk
# request may be re-issued this many times after explicit sheds before
# the fetch gives up (the fetcher then tries another provider)
MAX_SHED_RETRIES = 2
MAX_RETRY_WAIT_S = 2.0


def _peer_id(peer: Peer) -> str:
    return str(getattr(peer, "node_id", peer))


class StatesyncP2PReactor(Reactor):
    def __init__(self, app: abci.Application, syncer=None,
                 gate: Optional[ServeGate] = None,
                 archive: Optional[SnapshotArchive] = None):
        super().__init__("STATESYNC")
        self.app = app
        self.syncer = syncer  # None on serve-only nodes
        self.gate = gate or ServeGate()
        self.archive = archive  # format-2 merkle snapshots (optional)
        self.catalog = SnapshotCatalog(app)
        # (height, fmt, idx) -> {"ev", "data", "proof", "retry_ms"}
        self._pending = {}
        self._lock = threading.Lock()

    def channel_descriptors(self) -> List[ChannelDescriptor]:
        return [
            ChannelDescriptor(SNAPSHOT_CHANNEL, priority=5,
                              send_queue_capacity=10),
            ChannelDescriptor(CHUNK_CHANNEL, priority=3,
                              send_queue_capacity=100,
                              recv_message_capacity=32 * 1024 * 1024),
        ]

    def add_peer(self, peer: Peer) -> None:
        if self.syncer is not None:
            peer.send(SNAPSHOT_CHANNEL,
                      json.dumps({"t": "snapshots_req"}).encode())

    # -- chunk fetch for the Syncer ---------------------------------------

    def _fetch_chunk(self, peer: Peer, snapshot: abci.Snapshot,
                     idx: int, timeout: float = 10.0,
                     root: Optional[bytes] = None) -> Optional[bytes]:
        key = (snapshot.height, snapshot.format, idx)
        for _ in range(1 + MAX_SHED_RETRIES):
            ev = threading.Event()
            with self._lock:
                self._pending[key] = {"ev": ev, "data": None,
                                      "proof": None, "retry_ms": None}
            peer.send(CHUNK_CHANNEL, json.dumps({
                "t": "chunk_req", "h": snapshot.height,
                "f": snapshot.format, "i": idx,
            }).encode())
            ok = ev.wait(timeout)
            with self._lock:
                entry = self._pending.pop(key, None) or {}
            if not ok:
                return None
            retry_ms = entry.get("retry_ms")
            if retry_ms is not None:
                # an explicit shed is a retry hint, not a failure:
                # honor it (bounded) instead of punishing the donor
                time.sleep(min(retry_ms / 1000.0, MAX_RETRY_WAIT_S))
                continue
            data = entry.get("data")
            if data is None:
                return None
            proof = entry.get("proof")
            if root is not None and proof is not None \
                    and not verify_chunk(root, data, proof):
                return None  # bad chunk: the fetcher punishes THIS peer
            return data
        return None

    # -- serving ------------------------------------------------------------

    def _serve_snapshots(self, peer: Peer) -> None:
        snaps = [(s, None) for s in self.app.list_snapshots()]
        if self.archive is not None:
            snaps += [(s, s.hash) for s in self.archive.list_snapshots()]
        for s, root in snaps:
            if root is None:
                ent = self.catalog.root_and_proofs(s.height, s.format,
                                                   s.chunks)
                root = ent[0] if ent else None
            msg = {"t": "snapshot", "h": s.height, "f": s.format,
                   "c": s.chunks, "hash": s.hash.hex(),
                   "m": s.metadata.hex()}
            if root is not None:
                msg["root"] = root.hex()
            peer.send(SNAPSHOT_CHANNEL, json.dumps(msg).encode())
        ss_stats.bump("snapshots_served")

    def _serve_chunk(self, peer: Peer, h: int, f: int, i: int) -> None:
        proof = None
        if self.archive is not None:
            data = self.archive.load_chunk(h, f, i)
            if data:
                proof = self.archive.proof_for(h, f, i)
        else:
            data = b""
        if not data:
            data = self.app.load_snapshot_chunk(h, f, i)
            if data:
                for s in self.app.list_snapshots():
                    if s.height == h and s.format == f:
                        ent = self.catalog.root_and_proofs(h, f, s.chunks)
                        if ent is not None:
                            proof = ent[1][i]
                        break
        msg = {"t": "chunk", "h": h, "f": f, "i": i,
               "data": base64.b64encode(data).decode()}
        if proof is not None:
            msg["proof"] = proof_doc(proof)
        peer.send(CHUNK_CHANNEL, json.dumps(msg).encode())
        ss_stats.bump("chunks_served")

    # -- inbound -----------------------------------------------------------

    def receive(self, chan_id: int, peer: Peer, msg: bytes) -> None:
        try:
            j = json.loads(msg.decode())
            t = j.get("t")
            if t == "snapshots_req":
                try:
                    self.gate.admit(_peer_id(peer), kind="snapshot")
                except SnapshotServeOverloaded as e:
                    peer.send(SNAPSHOT_CHANNEL, json.dumps({
                        "t": "snapshots_shed",
                        "retry_after_ms": round(e.retry_after_ms, 3),
                    }).encode())
                    return
                fp.fail_point("snapshot.serve")
                self._serve_snapshots(peer)
            elif t == "snapshot":
                if self.syncer is not None:
                    snap = abci.Snapshot(
                        height=int(j["h"]), format=int(j["f"]),
                        chunks=int(j["c"]), hash=bytes.fromhex(j["hash"]),
                        metadata=bytes.fromhex(j.get("m", "")),
                    )
                    root = (bytes.fromhex(j["root"])
                            if j.get("root") else None)
                    self.syncer.add_snapshot(
                        snap,
                        lambda i, p=peer, s=snap, r=root:
                            self._fetch_chunk(
                                p, s, i,
                                timeout=self.syncer.chunk_timeout,
                                root=r),
                        provider_id=_peer_id(peer),
                    )
            elif t == "snapshots_shed":
                pass  # discovery retries ride sync_any's own loop
            elif t == "chunk_req":
                h, f, i = int(j["h"]), int(j["f"]), int(j["i"])
                try:
                    self.gate.admit(_peer_id(peer), kind="chunk")
                except SnapshotServeOverloaded as e:
                    peer.send(CHUNK_CHANNEL, json.dumps({
                        "t": "chunk_shed", "h": h, "f": f, "i": i,
                        "retry_after_ms": round(e.retry_after_ms, 3),
                    }).encode())
                    return
                fp.fail_point("snapshot.serve")
                self._serve_chunk(peer, h, f, i)
            elif t == "chunk":
                key = (int(j["h"]), int(j["f"]), int(j["i"]))
                with self._lock:
                    entry = self._pending.get(key)
                    if entry is not None:
                        entry["data"] = base64.b64decode(j["data"])
                        entry["proof"] = j.get("proof")
                        entry["ev"].set()
            elif t == "chunk_shed":
                key = (int(j["h"]), int(j["f"]), int(j["i"]))
                with self._lock:
                    entry = self._pending.get(key)
                    if entry is not None:
                        entry["retry_ms"] = float(
                            j.get("retry_after_ms", 100.0))
                        entry["ev"].set()
            else:
                raise ValueError(f"unknown statesync message {t!r}")
        except Exception as e:  # noqa: BLE001 - malformed peer message
            self.switch.stop_peer_for_error(peer, f"bad statesync msg: {e}")
