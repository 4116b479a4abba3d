"""PEX reactor + address book: peer discovery.

Reference: p2p/pex/pex_reactor.go:130 (request/response of known
addresses on channel 0x00, rate-limited per peer, seed mode) and
p2p/pex/addrbook.go (persisted bucketed address book; pick-random for
dialing). The bucket machinery in the reference exists to bias against
address-poisoning at internet scale; this book keeps the same surface
(add/pick/mark-good/mark-bad, JSON persistence) with a flat store and
per-source caps, which the tests exercise the same way.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Dict, List, Optional

from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.p2p.key import NetAddress
from cometbft_tpu_torch.p2p.switch import Peer, Reactor

PEX_CHANNEL = 0x00  # pex_reactor.go PexChannel
MAX_ADDRS_PER_MSG = 100
MIN_REQUEST_INTERVAL = 5.0  # per-peer rate limit (ensurePeersPeriod shape)


class AddrBook:
    """Persisted two-tier address book (p2p/pex/addrbook.go).

    Entries live in one of two tiers, mirroring the reference's
    new/old bucket split (addrbook.go:32-47):
      * "new"  — heard about via PEX but never connected to; these are
        the attack surface for address poisoning, so they're capped per
        source and evicted first.
      * "old"  — we successfully connected at least once (markGood
        promotes, addrbook.go:474); survive restarts as the primary
        redial set and are never displaced by gossip.
    Persistence is a JSON snapshot (saveToFile/loadFromFile shape,
    addrbook.go:854-947) written on every mark_good, on a periodic
    timer in the PEX reactor, and at shutdown — so a crash loses at
    most the newest gossip, not the tried set.

    Dial failures NEVER delete entries (round-5 advisory: the old
    delete-after-5-failures behavior let a few seconds of total
    unreachability irreversibly empty the persisted book, operator
    seeds included — the reference only evicts under capacity pressure
    or markBad, never on failure alone). Instead, each failure backs
    the entry off exponentially (attempts capped at MAX_ATTEMPTS for
    the backoff exponent) and `pick` skips it until the cooldown
    lapses; repeated failures demote old->new, and only the gossip
    eviction path may drop the most-failed NEW entries over capacity.
    Operator seeds (`seed=True` on add) are exempt even from that.
    """

    MAX_NEW = 1024          # eviction cap for the unproven tier
    MAX_ATTEMPTS = 5        # backoff-exponent cap; old entries demote
                            # to new past it (never deleted)
    BACKOFF_BASE = 2.0      # cooldown after the 1st failed dial
    BACKOFF_MAX = 600.0     # cap: even a dead address retries each 10m

    def __init__(self, path: Optional[str] = None,
                 max_per_source: int = 50):
        self.path = path
        self.max_per_source = max_per_source
        self._addrs: Dict[str, dict] = {}  # node_id -> entry
        self._lock = threading.Lock()
        # serializes whole save() calls: mark_good (per-peer threads),
        # the pex-ensure timer and stop_routines can all save
        # concurrently, and interleaved writes to the same .tmp file
        # would corrupt the book
        self._save_lock = threading.Lock()
        if path and os.path.exists(path):
            self._load()

    def _load(self) -> None:
        with open(self.path) as f:
            doc = json.load(f)
        for e in doc.get("addrs", []):
            e.setdefault("bucket", "new")
            e.setdefault("seed", False)
            # cooldowns don't survive a restart: the ensure routine
            # should redial the whole persisted book immediately
            e["next_dial"] = 0.0
            self._addrs[e["id"]] = e

    def save(self) -> None:
        if not self.path:
            return
        with self._save_lock:
            with self._lock:
                doc = {"addrs": [dict(e) for e in self._addrs.values()]}
            tmp = self.path + ".tmp"
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)

    def add(self, addr: NetAddress, source: str = "",
            seed: bool = False) -> bool:
        with self._lock:
            if addr.node_id in self._addrs:
                if seed:
                    # re-declared operator seed: upgrade in place so a
                    # gossip-learned copy can't shed the protection
                    self._addrs[addr.node_id]["seed"] = True
                return False
            n_from_source = sum(
                1 for e in self._addrs.values()
                if e["src"] == source and e["bucket"] == "new"
            )
            if source and n_from_source >= self.max_per_source:
                return False  # cap what one peer can fill the book with
            self._addrs[addr.node_id] = {
                "id": addr.node_id, "host": addr.host, "port": addr.port,
                "src": source, "attempts": 0, "last_success": 0.0,
                "banned": False, "bucket": "new", "seed": seed,
                "next_dial": 0.0,
            }
            self._evict_new_locked()
            return True

    def _evict_new_locked(self) -> None:
        """Cap the unproven tier (addrbook.go expireNew): drop the
        most-failed, then oldest, new entries over MAX_NEW. Operator
        seeds are never evicted — they are the redial set of last
        resort."""
        news = [e for e in self._addrs.values()
                if e["bucket"] == "new" and not e.get("seed")]
        if len(news) <= self.MAX_NEW:
            return
        news.sort(key=lambda e: (-e["attempts"], e["last_success"]))
        for e in news[: len(news) - self.MAX_NEW]:
            del self._addrs[e["id"]]

    def mark_good(self, node_id: str) -> None:
        """Successful connection: promote to the tried tier
        (addrbook.go:474 MarkGood -> moveToOld)."""
        promoted = False
        with self._lock:
            e = self._addrs.get(node_id)
            if e:
                e["attempts"] = 0
                e["next_dial"] = 0.0
                e["last_success"] = time.time()
                promoted = e["bucket"] != "old"
                e["bucket"] = "old"
        if promoted:
            # tried addresses are the restart redial set — persist them
            # eagerly, not just on the periodic timer
            self.save()

    def mark_attempt(self, node_id: str) -> None:
        """Failed (or started) dial: back off, never delete. The entry
        stays in the book with a cooldown of BACKOFF_BASE * 2^attempts
        (capped), so transient total unreachability — a restart into a
        partitioned network — costs minutes of patience, not the book."""
        with self._lock:
            e = self._addrs.get(node_id)
            if not e:
                return
            e["attempts"] = min(e["attempts"] + 1, self.MAX_ATTEMPTS)
            e["next_dial"] = time.time() + min(
                self.BACKOFF_BASE * (2 ** (e["attempts"] - 1)),
                self.BACKOFF_MAX,
            )
            if e["attempts"] >= self.MAX_ATTEMPTS and \
                    e["bucket"] == "old" and not e.get("seed"):
                # repeatedly unreachable tried peer: demote so gossip
                # churn can eventually displace it (addrbook.go
                # moveToNew on eviction) — still dialable, never lost
                e["bucket"] = "new"

    def mark_bad(self, node_id: str) -> None:
        with self._lock:
            e = self._addrs.get(node_id)
            if e:
                e["banned"] = True

    def pick(self, exclude: Optional[set] = None,
             bias_new: float = 0.3) -> Optional[NetAddress]:
        """Random dialable address (addrbook.go:303 PickAddress):
        choose the tried tier with prob 1-bias_new, then a low-attempt
        candidate at random within the tier. Backed-off entries are
        skipped until their cooldown lapses."""
        exclude = exclude or set()
        now = time.time()
        with self._lock:
            cands = [
                e for e in self._addrs.values()
                if not e["banned"] and e["id"] not in exclude
                and e.get("next_dial", 0.0) <= now
            ]
        if not cands:
            return None
        old = [e for e in cands if e["bucket"] == "old"]
        new = [e for e in cands if e["bucket"] != "old"]
        if old and new:
            tier = new if random.random() < bias_new else old
        else:
            tier = old or new
        tier.sort(key=lambda e: e["attempts"])
        pool = tier[: max(1, len(tier) // 2)]
        e = random.choice(pool)
        return NetAddress(e["id"], e["host"], e["port"])

    def sample(self, n: int = MAX_ADDRS_PER_MSG) -> List[NetAddress]:
        with self._lock:
            entries = [e for e in self._addrs.values() if not e["banned"]]
        random.shuffle(entries)
        return [
            NetAddress(e["id"], e["host"], e["port"])
            for e in entries[:n]
        ]

    def size(self) -> int:
        with self._lock:
            return len(self._addrs)


class PEXReactor(Reactor):
    """pex_reactor.go:130 — gossip addresses, keep the switch peered."""

    def __init__(self, book: AddrBook, ensure_interval: float = 2.0,
                 target_peers: int = 10, seed_mode: bool = False,
                 save_interval: float = 120.0):
        super().__init__("PEX")
        self.book = book
        self.ensure_interval = ensure_interval
        self.target_peers = target_peers
        self.seed_mode = seed_mode
        self.save_interval = save_interval  # addrbook.go saveRoutine 2m
        self._last_save = time.time()
        self._last_request: Dict[str, float] = {}
        self._requested: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def start_routines(self) -> None:
        """Start the ensure-peers loop. Called by the node at start so a
        restarted node redials its persisted book even with zero live
        peers (without this the loop only woke on the first inbound
        peer — a restart into an empty network would never redial)."""
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._ensure_peers_routine, daemon=True,
                    name="pex-ensure",
                )
                self._thread.start()

    def channel_descriptors(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(PEX_CHANNEL, priority=1,
                                  send_queue_capacity=10)]

    def add_peer(self, peer: Peer) -> None:
        # learn the dialing peer's listen address from its NodeInfo
        info = peer.node_info
        if info.listen_addr:
            host, _, port = info.listen_addr.rpartition(":")
            try:
                self.book.add(
                    NetAddress(info.node_id, host or "127.0.0.1",
                               int(port)),
                    source=info.node_id,
                )
            except ValueError:
                pass
        self.book.mark_good(peer.peer_id)
        self._request_addrs(peer)
        self.start_routines()

    def remove_peer(self, peer: Peer, reason: str) -> None:
        with self._lock:
            self._requested.discard(peer.peer_id)

    def stop_routines(self) -> None:
        self._stop.set()
        self.book.save()

    # -- outbound ----------------------------------------------------------

    def _request_addrs(self, peer: Peer) -> None:
        with self._lock:
            self._requested.add(peer.peer_id)
        peer.send(PEX_CHANNEL, json.dumps({"t": "pex_req"}).encode())

    def _ensure_peers_routine(self) -> None:
        """ensurePeersRoutine: keep dialing book addresses until the
        switch has target_peers connections."""
        while not self._stop.is_set():
            time.sleep(self.ensure_interval)
            sw = self.switch
            if sw is None or not sw.is_running():
                continue
            if time.time() - self._last_save >= self.save_interval:
                self._last_save = time.time()
                self.book.save()  # addrbook.go:854 saveRoutine
            if sw.num_peers() >= self.target_peers:
                continue
            have = set(sw.peers.keys()) | {sw.node_key.node_id}
            addr = self.book.pick(exclude=have)
            if addr is None:
                # re-poll a random connected peer for fresh addresses
                peers = list(sw.peers.values())
                if peers:
                    self._request_addrs(random.choice(peers))
                continue
            self.book.mark_attempt(addr.node_id)
            try:
                sw.dial_peer(addr)
            except Exception:  # noqa: BLE001 - dial failures are normal
                pass

    # -- inbound -----------------------------------------------------------

    def receive(self, chan_id: int, peer: Peer, msg: bytes) -> None:
        try:
            j = json.loads(msg.decode())
            t = j.get("t")
            if t == "pex_req":
                now = time.time()
                last = self._last_request.get(peer.peer_id, 0.0)
                if now - last < MIN_REQUEST_INTERVAL:
                    # request flooding (pex_reactor.go rate limiting)
                    self.switch.stop_peer_for_error(
                        peer, "pex request flood"
                    )
                    return
                self._last_request[peer.peer_id] = now
                addrs = self.book.sample()
                peer.send(PEX_CHANNEL, json.dumps({
                    "t": "pex_addrs",
                    "addrs": [
                        {"id": a.node_id, "host": a.host, "port": a.port}
                        for a in addrs
                    ],
                }).encode())
                if self.seed_mode:
                    # seeds serve the book then hang up (seed crawl shape)
                    self.switch.stop_peer_for_error(peer, "seed served")
            elif t == "pex_addrs":
                with self._lock:
                    expected = peer.peer_id in self._requested
                    self._requested.discard(peer.peer_id)
                if not expected:
                    # unsolicited address dump (addr spam) is punishable
                    self.switch.stop_peer_for_error(
                        peer, "unsolicited pex_addrs"
                    )
                    return
                addrs = j.get("addrs", [])[:MAX_ADDRS_PER_MSG]
                for a in addrs:
                    self.book.add(
                        NetAddress(str(a["id"]), str(a["host"]),
                                   int(a["port"])),
                        source=peer.peer_id,
                    )
            else:
                raise ValueError(f"unknown pex message {t!r}")
        except Exception as e:  # noqa: BLE001 - malformed peer message
            self.switch.stop_peer_for_error(peer, f"bad pex msg: {e}")
