"""Tx + block indexers with event-query search.

Reference: state/txindex/kv/kv.go (tx results by hash, searchable by
composite event keys), state/indexer/block/kv (block events by height),
and the IndexerService consuming the event bus
(state/txindex/indexer_service.go). sqlite plays the role of the KV
store; queries use the same AND-joined condition grammar as
libs/pubsub.Query (tx.height=5, app.key='x', CONTAINS).

The port's copy of the JAX package's state/indexer.py: the same
sqlite tables, so either package reads the other's index files.
"""
from __future__ import annotations

import hashlib
import json
import sqlite3
import threading
from typing import List, Optional

from cometbft_tpu_torch.libs.pubsub import CMP, RANGE_OPS, Query, _num


def _match_cond(db, table: str, col: str, c) -> set:
    """Rows of `table` matching one Condition; returns the set of `col`.

    Range comparisons (state/txindex/kv/kv.go:420 matchRange) fetch the
    key's rows and compare numerically host-side — sqlite's CAST turns
    garbage into 0.0, which would phantom-match."""
    if c.op == "=":
        cur = db.execute(
            f"SELECT {col} FROM {table} WHERE key=? AND value=?",
            (c.key, c.value),
        )
    elif c.op == "CONTAINS":
        cur = db.execute(
            f"SELECT {col} FROM {table} WHERE key=? AND value LIKE ?",
            (c.key, f"%{c.value}%"),
        )
    elif c.op in RANGE_OPS:
        # _num compares ints exactly (int64 heights/amounts above 2^53
        # lose precision as floats) — same semantics as pubsub.Query so
        # a subscription and a search over one query string agree
        want = _num(c.value)
        cmp = CMP[c.op]
        cur = db.execute(
            f"SELECT {col}, value FROM {table} WHERE key=?", (c.key,)
        )
        out = set()
        for row in cur.fetchall():
            got = _num(row[1])
            if got is not None and want is not None and cmp(got, want):
                out.add(row[0])
        return out
    else:  # EXISTS
        cur = db.execute(
            f"SELECT {col} FROM {table} WHERE key=?", (c.key,)
        )
    return {r[0] for r in cur.fetchall()}


class TxIndexer:
    """txindex/kv/kv.go analog."""

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._db:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS txs ("
                "hash BLOB PRIMARY KEY, height INTEGER, tx_index INTEGER, "
                "tx BLOB, code INTEGER, data BLOB, log TEXT)"
            )
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS tx_events ("
                "key TEXT, value TEXT, height INTEGER, hash BLOB)"
            )
            self._db.execute(
                "CREATE INDEX IF NOT EXISTS tx_events_kv "
                "ON tx_events(key, value)"
            )

    def index(self, height: int, tx_index: int, tx: bytes, result,
              events: Optional[dict] = None) -> None:
        h = hashlib.sha256(tx).digest()
        with self._lock, self._db:
            self._db.execute(
                "INSERT OR REPLACE INTO txs VALUES (?,?,?,?,?,?,?)",
                (h, height, tx_index, tx, result.code, result.data,
                 result.log),
            )
            self._db.execute(
                "DELETE FROM tx_events WHERE hash=?", (h,)
            )
            base = {"tx.height": [str(height)],
                    "tx.hash": [h.hex().upper()]}
            for k, vs in {**base, **(events or {})}.items():
                for v in vs:
                    self._db.execute(
                        "INSERT INTO tx_events VALUES (?,?,?,?)",
                        (k, v, height, h),
                    )

    def get(self, tx_hash: bytes) -> Optional[dict]:
        with self._lock:
            return self._get_locked(tx_hash)

    def _get_locked(self, tx_hash: bytes) -> Optional[dict]:
        cur = self._db.execute(
            "SELECT height, tx_index, tx, code, data, log FROM txs "
            "WHERE hash=?", (tx_hash,)
        )
        row = cur.fetchone()
        if not row:
            return None
        return {"hash": tx_hash, "height": row[0], "index": row[1],
                "tx": row[2], "code": row[3], "data": row[4],
                "log": row[5]}

    def search(self, query: str, limit: int = 100) -> List[dict]:
        return self.search_paged(query, page=1, per_page=limit)[1]

    def search_paged(self, query: str, page: int = 1, per_page: int = 30,
                     order: str = "asc"):
        """Paginated search -> (total_count, page items).

        Only (hash, height, index) tuples are materialized for the full
        match set; complete rows are loaded for the requested page only
        (rpc/core/tx.go TxSearch page/per_page/order_by)."""
        with self._lock:
            return self._search_locked(query, page, per_page, order)

    def _search_locked(self, query: str, page: int, per_page: int,
                       order: str):
        """AND-joined event conditions -> matching txs."""
        q = Query(query)
        hashes: Optional[set] = None
        for c in q.conditions:
            found = _match_cond(self._db, "tx_events", "hash", c)
            hashes = found if hashes is None else hashes & found
        # deterministic order over light (height, index, hash) tuples
        # (batched IN queries, not one SELECT per hash), then hydrate
        # only the requested page
        keys = []
        hl = list(hashes or [])
        for i in range(0, len(hl), 500):
            chunk = hl[i:i + 500]
            cur = self._db.execute(
                "SELECT hash, height, tx_index FROM txs WHERE hash IN "
                f"({','.join('?' * len(chunk))})", chunk,
            )
            keys += [(r[1], r[2], r[0]) for r in cur.fetchall()]
        keys.sort(reverse=(order == "desc"))
        total = len(keys)
        per_page = max(1, min(per_page, 100))
        total_pages = max(1, -(-total // per_page))
        if not 1 <= page <= total_pages:
            raise ValueError(
                f"page {page} out of range [1, {total_pages}]"
            )
        window = keys[(page - 1) * per_page: page * per_page]
        out = []
        for _, _, h in window:
            item = self._get_locked(h)
            if item:
                out.append(item)
        return total, out

    def prune(self, retain_height: int) -> int:
        with self._lock, self._db:
            self._db.execute(
                "DELETE FROM tx_events WHERE height < ?", (retain_height,)
            )
            cur = self._db.execute(
                "DELETE FROM txs WHERE height < ?", (retain_height,)
            )
            return cur.rowcount

    def close(self) -> None:
        # the lock orders close after any in-flight statement — closing
        # a sqlite connection mid-cursor segfaults CPython (found by
        # tests/test_stress.py)
        with self._lock:
            self._db.close()


class BlockIndexer:
    """state/indexer/block/kv analog: block events by height."""

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._db:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS block_events ("
                "key TEXT, value TEXT, height INTEGER)"
            )
            self._db.execute(
                "CREATE INDEX IF NOT EXISTS block_events_kv "
                "ON block_events(key, value)"
            )

    def index(self, height: int, events: Optional[dict] = None) -> None:
        with self._lock, self._db:
            base = {"block.height": [str(height)]}
            for k, vs in {**base, **(events or {})}.items():
                for v in vs:
                    self._db.execute(
                        "INSERT INTO block_events VALUES (?,?,?)",
                        (k, v, height),
                    )

    def search(self, query: str, limit: int = 100) -> List[int]:
        with self._lock:
            return self._search_locked(query, limit)

    def _search_locked(self, query: str, limit: int = 100) -> List[int]:
        q = Query(query)
        heights: Optional[set] = None
        for c in q.conditions:
            found = _match_cond(self._db, "block_events", "height", c)
            heights = found if heights is None else heights & found
        return sorted(heights or [])[:limit]

    def prune(self, retain_height: int) -> None:
        with self._lock, self._db:
            self._db.execute(
                "DELETE FROM block_events WHERE height < ?",
                (retain_height,),
            )

    def close(self) -> None:
        with self._lock:
            self._db.close()


class IndexerService:
    """Consumes the event bus and feeds both indexers
    (state/txindex/indexer_service.go)."""

    def __init__(self, event_bus, tx_indexer: TxIndexer,
                 block_indexer: BlockIndexer, extra_sinks=None):
        self.bus = event_bus
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        # additional event sinks (state/txindex/indexer_service.go
        # supports kv + psql simultaneously); each gets the same
        # index_tx_events/index_block_events feed as the kv pair
        self.extra_sinks = list(extra_sinks or [])
        self._sub_tx = event_bus.subscribe(
            "indexer", "tm.event='Tx'", capacity=1000
        )
        self._sub_blk = event_bus.subscribe(
            "indexer", "tm.event='NewBlock'", capacity=100
        )
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="indexer"
        )
        self._thread.start()

    def _run(self) -> None:
        counters = {}
        while not self._stop.is_set():
            try:
                self._drain(counters)
            except sqlite3.ProgrammingError:
                # the backing DB was closed under us mid-drain (node
                # shutdown racing a deep commit backlog, e.g. after a
                # sustained tx flood) — nothing further can be indexed
                return

    def _drain(self, counters: dict) -> None:
        msg = self._sub_tx.next(timeout=0.1)
        while msg is not None:
            d = msg.data
            h = d["height"]
            idx = counters.get(h, 0)
            counters[h] = idx + 1
            self.tx_indexer.index(h, idx, d["tx"], d["result"])
            for s in self.extra_sinks:
                try:
                    s.index_tx_events(h, idx, d["tx"], d["result"])
                except Exception:  # noqa: BLE001 - sink is aux
                    pass
            msg = self._sub_tx.next(timeout=0)
        msg = self._sub_blk.next(timeout=0)
        while msg is not None:
            blk = msg.data["block"]
            tags = {"block.proposer":
                    [blk.header.proposer_address.hex().upper()]}
            self.block_indexer.index(blk.header.height, tags)
            for s in self.extra_sinks:
                try:
                    s.index_block_events(blk.header.height, tags)
                except Exception:  # noqa: BLE001 - sink is aux
                    pass
            msg = self._sub_blk.next(timeout=0)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.bus.unsubscribe_all("indexer")
