"""PostgreSQL event sink: index blocks/txs/events into a relational DB.

Reference: state/indexer/sink/psql/psql.go + schema.sql — the operator-
facing alternative to the kv indexer: every block, transaction result,
event and attribute lands in relational tables (blocks, tx_results,
events, attributes + the event_attributes/block_events/tx_events
views) that operators query with plain SQL or downstream ETL.

The reference sink explicitly does NOT serve tx_search/block_search
(psql.go returns errors for the search methods; reads happen in SQL),
and this one keeps that contract.

Driver strategy: `psycopg2` when installed (real PostgreSQL DSN);
otherwise any DB-API connection works — `PsqlEventSink.sqlite(path)`
rewrites the schema's psql types to sqlite equivalents so the full
sink logic (schema, inserts, dedup, views) is exercised and tested
without a postgres server in the image. The SQL text, table and view
names match schema.sql one-for-one.

The port's copy of the JAX package's state/psql_sink.py: the same
schema and rows. `psycopg2` is imported only by connect().
"""
from __future__ import annotations

import datetime
import hashlib
import json
import threading
from typing import List, Optional

SCHEMA = """
CREATE TABLE IF NOT EXISTS blocks (
  rowid      BIGSERIAL PRIMARY KEY,
  height     BIGINT NOT NULL,
  chain_id   VARCHAR NOT NULL,
  created_at TIMESTAMPTZ NOT NULL,
  UNIQUE (height, chain_id)
);
CREATE INDEX IF NOT EXISTS idx_blocks_height_chain
  ON blocks(height, chain_id);
CREATE TABLE IF NOT EXISTS tx_results (
  rowid BIGSERIAL PRIMARY KEY,
  block_id BIGINT NOT NULL REFERENCES blocks(rowid),
  "index" INTEGER NOT NULL,
  created_at TIMESTAMPTZ NOT NULL,
  tx_hash VARCHAR NOT NULL,
  tx_result BYTEA NOT NULL,
  UNIQUE (block_id, "index")
);
CREATE TABLE IF NOT EXISTS events (
  rowid BIGSERIAL PRIMARY KEY,
  block_id BIGINT NOT NULL REFERENCES blocks(rowid),
  tx_id    BIGINT NULL REFERENCES tx_results(rowid),
  type VARCHAR NOT NULL
);
CREATE TABLE IF NOT EXISTS attributes (
   event_id      BIGINT NOT NULL REFERENCES events(rowid),
   key           VARCHAR NOT NULL,
   composite_key VARCHAR NOT NULL,
   value         VARCHAR NULL,
   UNIQUE (event_id, key)
);
"""

# "IF NOT EXISTS" is sqlite view syntax; postgres wants OR REPLACE
# (the dialect rewrite below swaps it)
VIEWS = """
CREATE OR REPLACE VIEW event_attributes AS
  SELECT block_id, tx_id, type, key, composite_key, value
  FROM events LEFT JOIN attributes ON (events.rowid = attributes.event_id);
CREATE OR REPLACE VIEW block_events AS
  SELECT blocks.rowid as block_id, height, chain_id, type, key,
         composite_key, value
  FROM blocks JOIN event_attributes
    ON (blocks.rowid = event_attributes.block_id)
  WHERE event_attributes.tx_id IS NULL;
CREATE OR REPLACE VIEW tx_events AS
  SELECT height, "index", chain_id, type, key, composite_key, value,
         tx_results.created_at
  FROM blocks JOIN tx_results ON (blocks.rowid = tx_results.block_id)
  JOIN event_attributes ON (tx_results.rowid = event_attributes.tx_id)
  WHERE event_attributes.tx_id IS NOT NULL;
"""


class PsqlSinkError(Exception):
    pass


class PsqlEventSink:
    """psql.go EventSink over any DB-API connection."""

    def __init__(self, conn, chain_id: str, paramstyle: str = "%s",
                 sqlite_dialect: bool = False):
        self.conn = conn
        self.chain_id = chain_id
        self._p = paramstyle
        self._sqlite = sqlite_dialect
        self._lock = threading.Lock()
        schema, views = SCHEMA, VIEWS
        if sqlite_dialect:
            for a, b in (("BIGSERIAL PRIMARY KEY",
                          "INTEGER PRIMARY KEY AUTOINCREMENT"),
                         ("TIMESTAMPTZ", "TEXT"),
                         ("BYTEA", "BLOB"),
                         ("BIGINT", "INTEGER"),
                         ("VARCHAR", "TEXT")):
                schema = schema.replace(a, b)
                views = views.replace(a, b)
            views = views.replace("CREATE OR REPLACE VIEW",
                                  "CREATE VIEW IF NOT EXISTS")
        cur = self.conn.cursor()
        for stmt in (schema + views).split(";"):
            if stmt.strip():
                cur.execute(stmt)
        self.conn.commit()

    # -- constructors ------------------------------------------------------

    @classmethod
    def connect(cls, dsn: str, chain_id: str) -> "PsqlEventSink":
        """Real postgres via psycopg2 (psql.go NewEventSink)."""
        try:
            import psycopg2  # type: ignore
        except ImportError as e:
            raise PsqlSinkError(
                "psycopg2 is not installed; use PsqlEventSink.sqlite() "
                "or install a postgres driver"
            ) from e
        return cls(psycopg2.connect(dsn), chain_id)

    @classmethod
    def sqlite(cls, path: str, chain_id: str) -> "PsqlEventSink":
        """Same sink logic over sqlite (drop-in for tests/dev)."""
        import sqlite3

        conn = sqlite3.connect(path, check_same_thread=False)
        return cls(conn, chain_id, paramstyle="?", sqlite_dialect=True)

    # -- helpers -----------------------------------------------------------

    def _q(self, sql: str) -> str:
        return sql.replace("%s", self._p) if self._p != "%s" else sql

    def _insert_returning(self, cur, sql: str, params) -> int:
        """INSERT and return the new rowid via RETURNING — correct
        under concurrent writers (SELECT MAX(rowid) after INSERT races
        with other connections and can adopt someone else's row). The
        sqlite dialect uses cursor.lastrowid instead: RETURNING only
        landed in sqlite 3.35 (this container ships 3.34), and
        lastrowid is per-connection so it carries no cross-writer race
        — the hazard the RETURNING form exists to close on postgres."""
        if self._sqlite:
            cur.execute(self._q(sql), params)
            return cur.lastrowid
        cur.execute(self._q(sql + " RETURNING rowid"), params)
        return cur.fetchone()[0]

    def _now(self) -> str:
        return datetime.datetime.now(datetime.timezone.utc).isoformat()

    def _insert_events(self, cur, block_id: int, tx_id: Optional[int],
                       events: dict) -> None:
        """events: {composite_key: [values]} (the framework's internal
        event-tag shape) -> events + attributes rows (psql.go
        insertEvents). Composite keys split on the LAST '.' into
        (type, key) like abci Event/EventAttribute."""
        by_type: dict = {}
        for ck, vals in (events or {}).items():
            typ, _, key = ck.rpartition(".")
            typ = typ or ck
            by_type.setdefault(typ, []).append((key, ck, vals))
        for typ, attrs in by_type.items():
            event_id = self._insert_returning(
                cur,
                "INSERT INTO events (block_id, tx_id, type) "
                "VALUES (%s, %s, %s)",
                (block_id, tx_id, typ),
            )
            for key, ck, vals in attrs:
                # one attribute row per key (UNIQUE(event_id, key));
                # multi-valued tags join like the reference's repeated
                # attributes would collapse
                for v in vals[:1]:
                    cur.execute(
                        self._q(
                            "INSERT INTO attributes "
                            "(event_id, key, composite_key, value) "
                            "VALUES (%s, %s, %s, %s)"),
                        (event_id, key, ck, str(v)),
                    )

    # -- EventSink surface (psql.go) ---------------------------------------

    def index_block_events(self, height: int,
                           events: Optional[dict] = None) -> None:
        """IndexBlockEvents (psql.go:129): block row + its events."""
        with self._lock:
            cur = self.conn.cursor()
            cur.execute(
                self._q("SELECT rowid FROM blocks WHERE height = %s "
                        "AND chain_id = %s"),
                (height, self.chain_id),
            )
            row = cur.fetchone()
            if row:
                block_id = row[0]
                # re-delivery (restart replay) REPLACES the height's
                # block-level events instead of duplicating them
                cur.execute(
                    self._q("DELETE FROM attributes WHERE event_id IN "
                            "(SELECT rowid FROM events WHERE "
                            "block_id = %s AND tx_id IS NULL)"),
                    (block_id,),
                )
                cur.execute(
                    self._q("DELETE FROM events WHERE block_id = %s "
                            "AND tx_id IS NULL"),
                    (block_id,),
                )
            else:
                block_id = self._insert_returning(
                    cur,
                    "INSERT INTO blocks (height, chain_id, created_at) "
                    "VALUES (%s, %s, %s)",
                    (height, self.chain_id, self._now()),
                )
            base = {"block.height": [str(height)]}
            self._insert_events(cur, block_id, None,
                                {**base, **(events or {})})
            self.conn.commit()

    def index_tx_events(self, height: int, tx_index: int, tx: bytes,
                        result, events: Optional[dict] = None) -> None:
        """IndexTxEvents (psql.go:165): tx_results row + its events.
        result carries code/data/log (ExecTxResult shape); stored as
        the JSON encoding in tx_result (the reference stores the
        protobuf TxResult — an encoding detail, same content)."""
        tx_hash = hashlib.sha256(tx).hexdigest().upper()
        doc = json.dumps({
            "height": height, "index": tx_index,
            "tx": tx.hex(),
            "result": {"code": getattr(result, "code", 0),
                       "data": getattr(result, "data", b"").hex(),
                       "log": getattr(result, "log", "")},
        }).encode()
        with self._lock:
            cur = self.conn.cursor()
            cur.execute(
                self._q("SELECT rowid FROM blocks WHERE height = %s "
                        "AND chain_id = %s"),
                (height, self.chain_id),
            )
            row = cur.fetchone()
            block_id = row[0] if row else self._insert_returning(
                cur,
                "INSERT INTO blocks (height, chain_id, created_at) "
                "VALUES (%s, %s, %s)",
                (height, self.chain_id, self._now()),
            )
            cur.execute(
                self._q('SELECT rowid FROM tx_results WHERE '
                        'block_id = %s AND "index" = %s'),
                (block_id, tx_index),
            )
            if cur.fetchone() is not None:
                self.conn.commit()
                return  # already indexed (psql.go upsert semantics)
            tx_id = self._insert_returning(
                cur,
                'INSERT INTO tx_results (block_id, "index", '
                "created_at, tx_hash, tx_result) "
                "VALUES (%s, %s, %s, %s, %s)",
                (block_id, tx_index, self._now(), tx_hash, doc),
            )
            base = {"tx.height": [str(height)], "tx.hash": [tx_hash]}
            self._insert_events(cur, block_id, tx_id,
                                {**base, **(events or {})})
            self.conn.commit()

    # search is intentionally unsupported (psql.go SearchTxEvents /
    # SearchBlockEvents return ErrUnsupported — reads are plain SQL)
    def search(self, *_a, **_k):
        raise PsqlSinkError(
            "psql sink does not implement search; query the tables "
            "directly (psql.go contract)"
        )

    def close(self) -> None:
        with self._lock:
            self.conn.close()
