"""Archival snapshot serving: merkle-chunked snapshots + the serve gate.

The serving half of the bootstrap plane (PR 18). Two weaknesses in the
reference-shaped statesync this module fixes:

  * **Unattributable chunks.** The kvstore reference hashes the WHOLE
    snapshot blob, so a single poisoned chunk forces RETRY_SNAPSHOT on
    everything (and the honest provider that served most chunks eats a
    punish strike alongside the liar). Format-2 snapshots hash the
    chunk list into a MERKLE root (crypto/merkle, the block-parts
    discipline) and every served chunk carries its inclusion proof —
    the restoring peer verifies each chunk on arrival, names the exact
    bad one, and punishes only its sender.

  * **Unbounded serving.** The p2p reactor answered every ``chunk_req``
    unconditionally, so a bootstrap storm (hundreds of joining nodes
    sampling a few archival hosts) would starve the donor's own
    consensus. The :class:`ServeGate` is a per-peer token bucket on the
    LEDGER clock: over-budget requests are shed with an EXPLICIT
    retry-hinted verdict (:class:`SnapshotServeOverloaded`, the
    ``PlaneOverloaded`` contract), never silently dropped — and the
    CONSENSUS lane is structurally untouchable because serving work
    never enters it at all.

Snapshot generation rides :class:`SnapshotArchive`: any state blob
(the app's committed state, or a document assembled from the
block/state stores) becomes a chunked, merkle-rooted, servable
snapshot. The archive is store-agnostic on purpose — the persistent
soak app and bench both feed it directly.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.statesync import stats as ss_stats
from cometbft_tpu_torch.verifyplane import PlaneOverloaded

fp.register("snapshot.serve",
            "snapshot/chunk serving seam in the statesync p2p reactor "
            "(after gate admission, before the store read)")

SNAPSHOT_FORMAT_MERKLE = 2
CHUNK_SIZE = 64 * 1024


class SnapshotServeOverloaded(PlaneOverloaded):
    """A serving shed: the donor is over its per-peer serving budget.

    Carries ``retry_after_ms`` (inherited) so the verdict is a retry
    hint, not a failure — the requesting peer backs off instead of
    punishing the donor or hammering it harder."""


# -- merkle-chunked snapshots ----------------------------------------------


def chunk_blob(blob: bytes, chunk_size: int = CHUNK_SIZE) -> List[bytes]:
    return [blob[i:i + chunk_size]
            for i in range(0, max(len(blob), 1), chunk_size)]


def proof_doc(p: merkle.Proof) -> dict:
    """Wire form of a chunk inclusion proof (hex, JSON-safe)."""
    return {"t": p.total, "i": p.index, "l": p.leaf_hash.hex(),
            "a": [a.hex() for a in p.aunts]}


def proof_from_doc(doc: dict) -> merkle.Proof:
    return merkle.Proof(
        total=int(doc["t"]), index=int(doc["i"]),
        leaf_hash=bytes.fromhex(doc["l"]),
        aunts=[bytes.fromhex(a) for a in doc.get("a", [])],
    )


def verify_chunk(root: bytes, chunk: bytes, doc: dict) -> bool:
    """Client-side: does this chunk belong at this index under the
    snapshot's merkle root? A False here names the bad chunk (and its
    sender) without waiting for the whole blob to mis-hash."""
    try:
        return proof_from_doc(doc).verify(root, chunk)
    except (KeyError, ValueError, TypeError):
        return False


class SnapshotArchive:
    """Format-2 snapshots generated from any state blob, kept bounded.

    ``generate(height, blob)`` chunks the blob, roots the chunk list
    (``hash`` = merkle root, so offers are self-authenticating down to
    the chunk), and retains the last ``keep`` snapshots — the same
    bounded retention the kvstore reference applies to its format-1
    set. Thread-safe: generation happens on the commit path while the
    p2p reactor serves from another thread."""

    def __init__(self, keep: int = 3, chunk_size: int = CHUNK_SIZE):
        self.keep = max(1, int(keep))
        self.chunk_size = int(chunk_size)
        # {(height, format): (snapshot, chunks, proofs)}
        self._snaps: Dict[Tuple[int, int], tuple] = {}
        self._lock = threading.Lock()

    def generate(self, height: int, blob: bytes) -> abci.Snapshot:
        chunks = chunk_blob(blob, self.chunk_size)
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        snap = abci.Snapshot(
            height=int(height), format=SNAPSHOT_FORMAT_MERKLE,
            chunks=len(chunks), hash=root,
        )
        with self._lock:
            self._snaps[(snap.height, snap.format)] = (snap, chunks,
                                                       proofs)
            for key in sorted(self._snaps)[:-self.keep]:
                del self._snaps[key]
        return snap

    def list_snapshots(self) -> List[abci.Snapshot]:
        with self._lock:
            return [s for s, _, _ in
                    (self._snaps[k] for k in sorted(self._snaps))]

    def load_chunk(self, height: int, fmt: int, idx: int) -> bytes:
        with self._lock:
            ent = self._snaps.get((height, fmt))
        if ent is None or not 0 <= idx < len(ent[1]):
            return b""
        return ent[1][idx]

    def proof_for(self, height: int, fmt: int,
                  idx: int) -> Optional[merkle.Proof]:
        with self._lock:
            ent = self._snaps.get((height, fmt))
        if ent is None or not 0 <= idx < len(ent[2]):
            return None
        return ent[2][idx]


class SnapshotCatalog:
    """Per-chunk merkle proofs for snapshots an APP serves (format 1
    included): the chunk list is read once through
    ``app.load_snapshot_chunk``, rooted, and cached bounded — so even
    legacy whole-blob-hash snapshots get chunk-level attribution on the
    wire (the root rides the offer metadata; the trusted app-hash check
    at the end of restore still anchors end-to-end integrity)."""

    def __init__(self, app: abci.Application, max_entries: int = 4):
        self.app = app
        self.max_entries = max(1, int(max_entries))
        self._cache: Dict[Tuple[int, int], tuple] = {}
        self._lock = threading.Lock()

    def _build(self, height: int, fmt: int, n_chunks: int):
        chunks = [self.app.load_snapshot_chunk(height, fmt, i)
                  for i in range(n_chunks)]
        return merkle.proofs_from_byte_slices(chunks)

    def root_and_proofs(self, height: int, fmt: int,
                        n_chunks: int) -> Optional[tuple]:
        key = (height, fmt)
        with self._lock:
            ent = self._cache.get(key)
        if ent is not None:
            return ent
        try:
            ent = self._build(height, fmt, n_chunks)
        except Exception:  # noqa: BLE001 - a sick app must not kill serving
            return None
        with self._lock:
            self._cache[key] = ent
            while len(self._cache) > self.max_entries:
                del self._cache[min(self._cache)]
        return ent


# -- the serve gate ---------------------------------------------------------


class ServeGate:
    """Per-peer token bucket for snapshot/chunk serving, on the ledger
    clock (virtual under simnet — a chaos soak's sheds replay
    byte-identically).

    Each peer holds ``burst`` tokens refilled at ``rate_per_s``; a
    request costs one. Over-budget requests raise
    :class:`SnapshotServeOverloaded` with the exact ``retry_after_ms``
    until the next token — the donor degrades HONESTLY under a
    bootstrap storm instead of silently starving. The peer table is
    bounded: least-recently-active peers are evicted past
    ``max_peers`` (a Sybil flood can't grow donor memory)."""

    def __init__(self, rate_per_s: float = 16.0, burst: int = 8,
                 max_peers: int = 256):
        self.rate_per_s = float(rate_per_s)
        self.burst = float(max(1, burst))
        self.max_peers = int(max_peers)
        self._peers: Dict[str, List[float]] = {}  # pid -> [tokens, at_ns]
        self._lock = threading.Lock()
        self.served = 0
        self.sheds = 0

    def admit(self, peer_id: str, kind: str = "chunk") -> None:
        """Charge one token or shed with a retry hint."""
        now = tracing.monotonic_ns()
        with self._lock:
            ent = self._peers.get(peer_id)
            if ent is None:
                ent = self._peers[peer_id] = [self.burst, now]
                if len(self._peers) > self.max_peers:
                    oldest = min(self._peers,
                                 key=lambda p: self._peers[p][1])
                    del self._peers[oldest]
            tokens, at = ent
            tokens = min(self.burst,
                         tokens + (now - at) * self.rate_per_s / 1e9)
            if tokens >= 1.0:
                ent[0], ent[1] = tokens - 1.0, now
                self.served += 1
                return
            ent[0], ent[1] = tokens, now
            self.sheds += 1
            retry_ms = (1.0 - tokens) / self.rate_per_s * 1000.0
        ss_stats.bump("chunks_shed" if kind == "chunk"
                      else "snapshots_shed")
        raise SnapshotServeOverloaded(
            f"serving budget exhausted for peer {peer_id} ({kind})",
            retry_after_ms=retry_ms,
        )

    def stats(self) -> dict:
        with self._lock:
            return {"served": self.served, "sheds": self.sheds,
                    "peers": len(self._peers),
                    "rate_per_s": self.rate_per_s, "burst": self.burst}
