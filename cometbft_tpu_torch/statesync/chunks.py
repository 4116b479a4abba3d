"""Statesync chunk engine: parallel multi-peer fetch with retry.

Reference: statesync/chunks.go — the chunk queue allocates slot indices
to concurrent fetchers, accepts the first copy of each chunk (persisting
it so a restart doesn't refetch), lets the applier retry/refetch, and
tracks which provider served what so bad senders can be punished;
syncer.go:358-445 drives it with one fetcher per peer and a per-chunk
timeout (`chunkTimeout`) that re-requests from a different peer.

The engine is transport-agnostic: providers are callables
`fetch(index) -> Optional[bytes]` keyed by an opaque provider id (the
p2p reactor registers one per peer serving the snapshot).
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.statesync import stats as ss_stats

_log = logging.getLogger(__name__)

fp.register("statesync.fetch",
            "statesync chunk fetch (per provider worker, before the "
            "transport call) — raise/flake fault a provider without "
            "touching the others")


def _mono() -> float:
    """The LEDGER clock in seconds: virtual under the simnet's
    installed module clock, perf_counter otherwise. Chunk request ages
    and applier deadlines used raw ``time.monotonic()`` before PR 18,
    which made the simnet bootstrap scenario non-replayable — the same
    wall-clock-in-a-deadline bug PR 7 fixed for BULK sheds."""
    return tracing.monotonic_ns() / 1e9

# provider is dropped after this many failures (timeout, None, or a
# chunk the app rejected) — syncer.go bans the peer outright
MAX_PROVIDER_FAILURES = 2

PENDING, REQUESTED, RECEIVED = 0, 1, 2


class ChunkQueue:
    """Slot state for one snapshot's chunks (chunks.go chunkQueue).

    Thread-safe: fetcher threads allocate() slots and add() payloads;
    the applier next() blocks for chunk i and retry()s rejects."""

    def __init__(self, n_chunks: int, cache_dir: Optional[str] = None):
        self.n = n_chunks
        self.cache_dir = cache_dir
        self._status = [PENDING] * n_chunks
        self._data: List[Optional[bytes]] = [None] * n_chunks
        self._sender: List[Optional[str]] = [None] * n_chunks
        self._req_at = [0.0] * n_chunks
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            for i in range(n_chunks):
                p = self._path(i)
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        self._data[i] = f.read()
                    self._status[i] = RECEIVED
                    self._sender[i] = "cache"

    def _path(self, i: int) -> str:
        return os.path.join(self.cache_dir, f"chunk-{i:06d}")

    def allocate(self) -> Optional[int]:
        """Next pending slot -> REQUESTED, or None when nothing pending
        (chunks.go Allocate)."""
        with self._lock:
            for i in range(self.n):
                if self._status[i] == PENDING:
                    self._status[i] = REQUESTED
                    self._req_at[i] = _mono()
                    return i
            return None

    def reclaim_expired(self, max_age: float) -> int:
        """REQUESTED slots older than max_age back to PENDING — a hung
        provider must not pin a slot forever (the chunkTimeout
        re-request of syncer.go:415). Returns how many were reclaimed."""
        now = _mono()
        n = 0
        with self._cond:
            for i in range(self.n):
                if self._status[i] == REQUESTED \
                        and now - self._req_at[i] > max_age:
                    self._status[i] = PENDING
                    n += 1
            if n:
                self._cond.notify_all()
        return n

    def add(self, i: int, data: bytes, sender: str) -> bool:
        """First copy of chunk i wins; duplicates return False
        (chunks.go Add). Persists to the cache dir for restart safety."""
        with self._cond:
            if self._status[i] == RECEIVED:
                return False
            if self.cache_dir:
                tmp = self._path(i) + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, self._path(i))
            self._data[i] = data
            self._sender[i] = sender
            self._status[i] = RECEIVED
            ss_stats.bump("chunks_fetched")
            self._cond.notify_all()
            return True

    def release(self, i: int) -> None:
        """REQUESTED -> PENDING (fetch failed; another worker retries)."""
        with self._cond:
            if self._status[i] == REQUESTED:
                self._status[i] = PENDING
                self._cond.notify_all()

    def retry(self, i: int) -> Optional[str]:
        """Discard a received chunk the app rejected so it refetches;
        returns who sent it (to punish). chunks.go Retry + GetSender."""
        with self._cond:
            sender = self._sender[i]
            self._data[i] = None
            self._sender[i] = None
            self._status[i] = PENDING
            if self.cache_dir:
                try:
                    os.unlink(self._path(i))
                except OSError:
                    pass
            self._cond.notify_all()
            return sender

    def wait_for(self, i: int, timeout: float) -> Optional[bytes]:
        """Block until chunk i is RECEIVED (the applier side)."""
        deadline = _mono() + timeout
        with self._cond:
            while self._status[i] != RECEIVED:
                left = deadline - _mono()
                if left <= 0:
                    return None
                self._cond.wait(left)
            return self._data[i]

    def sender_of(self, i: int) -> Optional[str]:
        with self._lock:
            return self._sender[i]

    def done(self) -> bool:
        with self._lock:
            return all(s == RECEIVED for s in self._status)


class ChunkFetcher:
    """Parallel fetch of a ChunkQueue from multiple scored providers.

    One worker per provider (like the reference's per-peer fetch
    routines, syncer.go:358): each worker allocates a slot, asks ITS
    provider, and on timeout/failure releases the slot for another
    worker — so a slow or dead peer degrades throughput instead of
    stalling the sync. Providers accumulate failures and are dropped at
    MAX_PROVIDER_FAILURES."""

    def __init__(self, queue: ChunkQueue,
                 providers: Dict[str, Callable[[int], Optional[bytes]]],
                 chunk_timeout: float = 10.0):
        self.q = queue
        self.providers = dict(providers)
        self.chunk_timeout = chunk_timeout
        self.failures: Dict[str, int] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()

    def punish(self, provider_id: Optional[str]) -> None:
        """Count a failure against a provider; drop it at the limit
        (the syncer calls this for rejected chunks too)."""
        if provider_id is None:
            return
        ss_stats.bump("providers_punished")
        with self._lock:
            self.failures[provider_id] = self.failures.get(
                provider_id, 0) + 1
            if self.failures[provider_id] >= MAX_PROVIDER_FAILURES:
                if self.providers.pop(provider_id, None) is not None:
                    ss_stats.bump("providers_dropped")
                    _log.warning("statesync: dropping provider %s",
                                 provider_id)

    def _alive(self, pid: str) -> bool:
        with self._lock:
            return pid in self.providers

    def _worker(self, pid: str,
                fetch: Callable[[int], Optional[bytes]]) -> None:
        # workers never exit on queue.done(): the applier may RETRY a
        # received chunk the app rejected, turning slots pending again.
        # They idle until stop() (the syncer's finally) shuts them down.
        while not self._stop.is_set() and self._alive(pid):
            i = self.q.allocate()
            if i is None:
                time.sleep(0.05)  # nothing pending right now
                continue
            try:
                fp.fail_point("statesync.fetch")
                data = fetch(i)
            except Exception as e:  # noqa: BLE001 - provider transport
                _log.warning("statesync: provider %s chunk %d: %s",
                             pid, i, e)
                data = None
            if data is None:
                self.q.release(i)
                self.punish(pid)
            elif not self.q.add(i, data, pid):
                pass  # duplicate; someone else was faster

    def start(self) -> None:
        for pid, fetch in list(self.providers.items()):
            th = threading.Thread(
                target=self._worker, args=(pid, fetch),
                daemon=True, name=f"chunk-fetch-{pid}",
            )
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=2.0)

    def has_providers(self) -> bool:
        with self._lock:
            return bool(self.providers)
