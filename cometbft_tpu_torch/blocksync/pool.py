"""BlockPool: sliding-window parallel block requester.

Reference: blocksync/pool.go — 600 outstanding requests (:31-34), max 20
per peer, requesters re-assign on peer failure, PeekTwoBlocks/PopRequest
consumed by the reactor, peer height tracking via status messages.

Transport-agnostic: a peer is registered with a `request(height)`
callback (the p2p reactor wires a real channel; tests wire a local
chain). Blocks come back through add_block.

Robustness (pool.go requestRetrySeconds + bpRequester.redo analog): a
request that a peer never answers TIMES OUT — the requester is released
back to the pool with an exponential-backoff cooldown and reassigned
(preferring a different peer), and a peer that keeps timing out is
dropped from the pool (it can re-register via its next status
message). Without this, one dead/flaky peer pins its assigned heights
forever and the sync wedges.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.types.block import Block

MAX_PENDING_REQUESTS = 600   # pool.go:32 maxPendingRequests
MAX_PER_PEER = 20            # pool.go:33 maxPendingRequestsPerPeer
REQUEST_TIMEOUT = 15.0       # pool.go requestRetrySeconds shape
RETRY_BACKOFF_BASE = 0.05    # first re-request cooldown
RETRY_BACKOFF_MAX = 2.0      # cap so a long outage still retries
PEER_TIMEOUT_LIMIT = 3       # consecutive timeouts before peer removal

fp.register("blocksync.request",
            "issuing a block request to a peer (flake = lost request)")
fp.register("blocksync.deliver",
            "a peer-delivered block arriving at the pool")


@dataclass
class _Peer:
    peer_id: str
    height: int
    request: Callable[[int], None]
    pending: int = 0
    timeouts: int = 0  # consecutive request timeouts


@dataclass
class _Requester:
    height: int
    peer_id: Optional[str] = None
    block: Optional[Block] = None
    attempts: int = 0      # failed/timed-out assignments so far
    deadline: float = 0.0  # when the outstanding request times out
    retry_at: float = 0.0  # backoff gate for the next assignment


class BlockPool:
    def __init__(self, start_height: int,
                 request_timeout: float = REQUEST_TIMEOUT):
        self.height = start_height  # next height to process
        self.request_timeout = request_timeout
        self._peers: Dict[str, _Peer] = {}
        self._banned: set = set()
        self._requesters: Dict[int, _Requester] = {}
        self._max_seen_height = 0  # highest tip EVER advertised
        self._lock = threading.Lock()

    # -- peer management ---------------------------------------------------

    def set_peer_range(self, peer_id: str, height: int,
                       request: Callable[[int], None]) -> None:
        """SetPeerRange (pool.go): register/refresh a peer and its tip."""
        with self._lock:
            if peer_id in self._banned:
                return  # a banned peer can't re-register via status spam
            p = self._peers.get(peer_id)
            if p is None:
                self._peers[peer_id] = _Peer(peer_id, height, request)
            else:
                p.height = max(p.height, height)
            self._max_seen_height = max(self._max_seen_height, height)

    def remove_peer(self, peer_id: str) -> None:
        with self._lock:
            self._remove_peer_locked(peer_id)

    def _remove_peer_locked(self, peer_id: str) -> None:
        self._peers.pop(peer_id, None)
        for r in self._requesters.values():
            if r.peer_id == peer_id and r.block is None:
                r.peer_id = None  # re-assignable

    def ban_peer(self, peer_id: str) -> None:
        """Reactor punishes a peer that served a bad block
        (blocksync/reactor.go:480-496); its pending blocks are dropped."""
        with self._lock:
            self._banned.add(peer_id)
            self._peers.pop(peer_id, None)
            for r in self._requesters.values():
                if r.peer_id == peer_id:
                    r.peer_id = None
                    r.block = None

    # -- request scheduling ------------------------------------------------

    def make_requests(self) -> int:
        """Fill the sliding window: time out stale requests, then assign
        unclaimed heights to peers with capacity. Returns how many
        requests were issued."""
        now = time.monotonic()
        issued = []
        with self._lock:
            self._expire_locked(now)
            window_end = self.height + MAX_PENDING_REQUESTS
            for h in range(self.height, window_end):
                if h > self._max_peer_height():
                    break
                r = self._requesters.get(h)
                if r is None:
                    r = self._requesters[h] = _Requester(h)
                if r.peer_id is not None or r.block is not None:
                    continue
                if r.retry_at > now:
                    continue  # backoff after a timeout/redo
                peer = self._pick_peer(h)
                if peer is None:
                    continue
                r.peer_id = peer.peer_id
                r.deadline = now + self.request_timeout
                peer.pending += 1
                issued.append((peer, h))
        sent = 0
        for peer, h in issued:
            try:
                fp.fail_point("blocksync.request")
                peer.request(h)
                sent += 1
            except Exception:  # noqa: BLE001 - a lost request, not fatal
                # the peer callback failed (dead transport, injected
                # fault): the request never left, so let the timeout
                # machinery reclaim the height instead of wedging it
                pass
        return sent

    def _expire_locked(self, now: float) -> None:
        """Timed-out outstanding requests are released with backoff
        (bpRequester redo); serially-unresponsive peers are dropped.
        A peer's timeout strike counts at most ONCE per sweep — a
        healthy peer with several requests in flight must get
        PEER_TIMEOUT_LIMIT full timeout rounds, not be evicted by one
        hiccup expiring its whole window at once."""
        struck: set = set()
        for r in self._requesters.values():
            if r.peer_id is None or r.block is not None:
                continue
            if now < r.deadline:
                continue
            peer = self._peers.get(r.peer_id)
            r.peer_id = None
            r.attempts += 1
            r.retry_at = now + min(
                RETRY_BACKOFF_BASE * (2 ** (r.attempts - 1)),
                RETRY_BACKOFF_MAX,
            )
            if peer is not None:
                peer.pending = max(0, peer.pending - 1)
                if peer.peer_id not in struck:
                    struck.add(peer.peer_id)
                    peer.timeouts += 1
                    if peer.timeouts >= PEER_TIMEOUT_LIMIT:
                        self._remove_peer_locked(peer.peer_id)

    def _max_peer_height(self) -> int:
        return max((p.height for p in self._peers.values()), default=0)

    def max_peer_height(self) -> int:
        with self._lock:
            return self._max_peer_height()

    def max_seen_height(self) -> int:
        """Highest tip any peer EVER advertised — survives peer
        removal, so the reactor can tell 'no peers yet' from 'my sole
        peer timed out mid-sync'."""
        with self._lock:
            return self._max_seen_height

    def num_peers(self) -> int:
        with self._lock:
            return len(self._peers)

    def _pick_peer(self, height: int) -> Optional[_Peer]:
        best = None
        for p in self._peers.values():
            if p.height < height or p.pending >= MAX_PER_PEER:
                continue
            if best is None or p.pending < best.pending:
                best = p
        return best

    # -- block intake ------------------------------------------------------

    def add_block(self, peer_id: str, block: Block) -> bool:
        """AddBlock (pool.go): only accepted from the peer the height was
        requested from (anti-spam)."""
        try:
            fp.fail_point("blocksync.deliver")
        except fp.FailpointError:
            return False  # injected delivery fault: block lost in flight
        with self._lock:
            r = self._requesters.get(block.header.height)
            if r is None or r.peer_id != peer_id or r.block is not None:
                return False
            r.block = block
            r.attempts = 0
            p = self._peers.get(peer_id)
            if p:
                p.pending = max(0, p.pending - 1)
                p.timeouts = 0  # a delivery proves the peer is alive
            return True

    # -- consumption -------------------------------------------------------

    def peek_blocks(self, max_n: int = 2) -> List[Block]:
        """A run of consecutive available blocks starting at self.height
        (PeekTwoBlocks generalized — the fused multi-commit verifier eats
        as long a run as is ready)."""
        out: List[Block] = []
        with self._lock:
            for h in range(self.height, self.height + max_n):
                r = self._requesters.get(h)
                if r is None or r.block is None:
                    break
                out.append(r.block)
        return out

    def pop_block(self) -> None:
        """Advance past self.height (PopRequest)."""
        with self._lock:
            self._requesters.pop(self.height, None)
            self.height += 1

    def peer_of(self, height: int) -> Optional[str]:
        with self._lock:
            r = self._requesters.get(height)
            return r.peer_id if r else None

    def redo_block(self, height: int) -> Optional[str]:
        """A block failed verification: drop it (and everything above it
        from the same peer) for re-request; returns the offending peer."""
        now = time.monotonic()
        with self._lock:
            r = self._requesters.get(height)
            if r is None:
                return None
            peer = r.peer_id
            for h, req in self._requesters.items():
                if h >= height and req.peer_id == peer:
                    req.block = None
                    req.peer_id = None
                    req.attempts += 1
                    req.retry_at = now + min(
                        RETRY_BACKOFF_BASE * (2 ** (req.attempts - 1)),
                        RETRY_BACKOFF_MAX,
                    )
            return peer

    def is_caught_up(self) -> bool:
        """pool.go IsCaughtUp: blocks up to maxPeerHeight-1 are applied
        (verifying height H needs H+1's LastCommit); consensus takes the
        tip after the switch."""
        with self._lock:
            maxh = self._max_peer_height()
            return maxh > 0 and self.height >= maxh
