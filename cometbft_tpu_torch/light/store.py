"""Persistent trusted light-block store.

Reference: light/store/db/db.go — the light client persists every
verified (SignedHeader, ValidatorSet) pair so the trust root survives
restarts; without it a restarted light node/proxy would have to be
re-bootstrapped with fresh TrustOptions, defeating the trust-period
security model (db.go:24-47 SaveLightBlock, :121 LightBlock,
:169 LatestLightBlock, :143 FirstLightBlockHeight, :75 Delete,
:200 Prune, :239 Size).

SQLite here (same storage substrate as the state store and indexers):
one row per height holding the JSON-encoded signed header + validator
set. The store is API-compatible with light.client.TrustedStore so the
client takes either.

The port's copy of the JAX package's light/store.py.
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import List, Optional

from cometbft_tpu_torch.light.verifier import LightBlock, SignedHeader
from cometbft_tpu_torch.state.state import _valset_from_j, _valset_to_j
from cometbft_tpu_torch.types import serde


def _lb_to_json(lb: LightBlock) -> str:
    return json.dumps({
        "header": serde.header_to_j(lb.signed_header.header),
        "commit": serde.commit_to_j(lb.signed_header.commit),
        "validators": _valset_to_j(lb.validator_set),
    })


def _lb_from_json(s: str) -> LightBlock:
    j = json.loads(s)
    return LightBlock(
        signed_header=SignedHeader(
            header=serde.header_from_j(j["header"]),
            commit=serde.commit_from_j(j["commit"]),
        ),
        validator_set=_valset_from_j(j["validators"]),
    )


class DBStore:
    """Durable trusted store (light/store/db/db.go parity).

    Same surface as light.client.TrustedStore (save/get/delete/latest/
    heights) plus the reference's first-height, prune and size ops.
    """

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS light_blocks ("
            "height INTEGER PRIMARY KEY, data TEXT NOT NULL)"
        )
        self._db.commit()

    def save(self, lb: LightBlock) -> None:
        data = _lb_to_json(lb)
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO light_blocks (height, data) "
                "VALUES (?, ?)",
                (lb.height, data),
            )
            self._db.commit()

    def get(self, height: int) -> Optional[LightBlock]:
        with self._lock:
            row = self._db.execute(
                "SELECT data FROM light_blocks WHERE height = ?",
                (height,),
            ).fetchone()
        return _lb_from_json(row[0]) if row else None

    def delete(self, height: int) -> None:
        with self._lock:
            self._db.execute(
                "DELETE FROM light_blocks WHERE height = ?", (height,)
            )
            self._db.commit()

    def latest(self) -> Optional[LightBlock]:
        with self._lock:
            row = self._db.execute(
                "SELECT data FROM light_blocks "
                "ORDER BY height DESC LIMIT 1"
            ).fetchone()
        return _lb_from_json(row[0]) if row else None

    def first_height(self) -> int:
        """Lowest stored height, or -1 (db.go:143 FirstLightBlockHeight)."""
        with self._lock:
            row = self._db.execute(
                "SELECT height FROM light_blocks ORDER BY height LIMIT 1"
            ).fetchone()
        return row[0] if row else -1

    def heights(self) -> List[int]:
        with self._lock:
            rows = self._db.execute(
                "SELECT height FROM light_blocks ORDER BY height"
            ).fetchall()
        return [r[0] for r in rows]

    def lowest_at_or_above(self, height: int) -> Optional[LightBlock]:
        """Atomic anchor scan (TrustedStore parity): the stored block
        with the smallest height >= `height`."""
        with self._lock:
            row = self._db.execute(
                "SELECT data FROM light_blocks WHERE height >= ? "
                "ORDER BY height LIMIT 1",
                (height,),
            ).fetchone()
        return _lb_from_json(row[0]) if row else None

    def size(self) -> int:
        with self._lock:
            return self._db.execute(
                "SELECT COUNT(*) FROM light_blocks"
            ).fetchone()[0]

    def prune(self, size: int) -> None:
        """Delete oldest blocks until at most `size` remain (db.go:200).

        The latest block is never pruned — it is the trust root."""
        with self._lock:
            n = self._db.execute(
                "SELECT COUNT(*) FROM light_blocks"
            ).fetchone()[0]
            excess = n - max(size, 1)
            if excess > 0:
                self._db.execute(
                    "DELETE FROM light_blocks WHERE height IN ("
                    "SELECT height FROM light_blocks "
                    "ORDER BY height LIMIT ?)",
                    (excess,),
                )
            self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._db.close()
