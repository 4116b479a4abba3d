"""BlockStore: persisted blocks, commits and seen-commits by height.

Reference: store/store.go:53 (BlockStore over cometbft-db), SaveBlock
(:401), LoadBlock/LoadBlockCommit/LoadSeenCommit (:254-300), Base/Height
bookkeeping, PruneBlocks (:301). sqlite3 (stdlib) plays the role of
cometbft-db: single writer, transactional batch save.

The port's copy of the JAX package's store/blockstore.py, over the
port's types/serde.py: the same schema and JSON, so one store file reads
in both packages.
"""
from __future__ import annotations

import sqlite3
import threading
from typing import Optional

from cometbft_tpu_torch.types import serde
from cometbft_tpu_torch.types.block import Block
from cometbft_tpu_torch.types.commit import Commit


class BlockStore:
    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._db:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS blocks ("
                "height INTEGER PRIMARY KEY, hash BLOB, block TEXT, "
                "commit_json TEXT, seen_commit TEXT, ext_commit TEXT)"
            )
            # migrate pre-extension databases (5-column schema)
            cols = [r[1] for r in
                    self._db.execute("PRAGMA table_info(blocks)")]
            if "ext_commit" not in cols:
                self._db.execute(
                    "ALTER TABLE blocks ADD COLUMN ext_commit TEXT"
                )
            self._db.execute(
                "CREATE INDEX IF NOT EXISTS blocks_hash ON blocks(hash)"
            )

    def base(self) -> int:
        with self._lock:
            cur = self._db.execute("SELECT MIN(height) FROM blocks")
            r = cur.fetchone()[0]
            return r if r is not None else 0

    def height(self) -> int:
        with self._lock:
            cur = self._db.execute("SELECT MAX(height) FROM blocks")
            r = cur.fetchone()[0]
            return r if r is not None else 0

    def save_block(self, block: Block, seen_commit: Commit,
                   extended_commit=None) -> None:
        """SaveBlock (store.go:401) / SaveBlockWithExtendedCommit
        (store.go:254): block + its own SeenCommit (+ the ExtendedCommit
        with vote extensions, when enabled); the block's LastCommit rides
        inside the block."""
        h = block.header.height
        ext = (serde.json.dumps(serde.extcommit_to_j(extended_commit))
               if extended_commit is not None else None)
        with self._lock, self._db:
            self._db.execute(
                "INSERT OR REPLACE INTO blocks VALUES (?,?,?,?,?,?)",
                (
                    h,
                    block.hash(),
                    serde.block_to_json(block),
                    serde.json.dumps(serde.commit_to_j(block.last_commit)),
                    serde.json.dumps(serde.commit_to_j(seen_commit)),
                    ext,
                ),
            )

    def save_seen_commit(self, height: int, commit: Commit) -> None:
        """Store a commit with NO block (store.go:277 SaveSeenCommit):
        statesync persists the restore height's commit so a freshly
        synced proposer can build height+1's LastCommit."""
        with self._lock, self._db:
            # upsert ONLY the seen_commit column: a plain REPLACE would
            # null out an existing block row at this height
            self._db.execute(
                "INSERT INTO blocks(height, seen_commit) VALUES (?,?) "
                "ON CONFLICT(height) DO UPDATE SET "
                "seen_commit=excluded.seen_commit",
                (height, serde.json.dumps(serde.commit_to_j(commit))),
            )

    def load_block(self, height: int) -> Optional[Block]:
        with self._lock:
            cur = self._db.execute(
                "SELECT block FROM blocks WHERE height=?", (height,)
            )
            row = cur.fetchone()
            return serde.block_from_json(row[0]) if row and row[0] else None

    def load_block_by_hash(self, h: bytes) -> Optional[Block]:
        with self._lock:
            cur = self._db.execute(
                "SELECT block FROM blocks WHERE hash=?", (h,)
            )
            row = cur.fetchone()
            return serde.block_from_json(row[0]) if row else None

    def load_block_commit(self, height: int) -> Optional[Commit]:
        """The commit FOR block `height`, stored in block height+1's
        LastCommit (store.go LoadBlockCommit loads it directly)."""
        with self._lock:
            cur = self._db.execute(
                "SELECT commit_json FROM blocks WHERE height=?", (height + 1,)
            )
            row = cur.fetchone()
        if row and row[0]:
            return serde.commit_from_j(serde.json.loads(row[0]))
        return self.load_seen_commit(height)

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        with self._lock:
            cur = self._db.execute(
                "SELECT seen_commit FROM blocks WHERE height=?", (height,)
            )
            row = cur.fetchone()
            return (
                serde.commit_from_j(serde.json.loads(row[0]))
                if row and row[0] else None
            )

    def load_extended_commit(self, height: int):
        """LoadBlockExtendedCommit (store.go:286): the seen commit WITH
        vote extensions, present only when extensions were enabled at
        save time."""
        with self._lock:
            cur = self._db.execute(
                "SELECT ext_commit FROM blocks WHERE height=?", (height,)
            )
            row = cur.fetchone()
            return (
                serde.extcommit_from_j(serde.json.loads(row[0]))
                if row and row[0] else None
            )

    def remove_block(self, height: int) -> None:
        """Delete one block row (rollback --remove-block;
        state/rollback.go's store arm)."""
        with self._lock, self._db:
            self._db.execute("DELETE FROM blocks WHERE height=?",
                             (height,))

    def prune_blocks(self, retain_height: int) -> int:
        """Delete blocks below retain_height (store.go:301)."""
        with self._lock, self._db:
            cur = self._db.execute(
                "DELETE FROM blocks WHERE height < ?", (retain_height,)
            )
            return cur.rowcount

    def close(self) -> None:
        with self._lock:
            self._db.close()
