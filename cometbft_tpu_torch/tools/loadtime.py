"""loadtime: tx load generator + per-tx latency report.

Reference: test/loadtime — `load` stamps a timestamp into each tx
payload and drives broadcast_tx at a target rate (load/main.go via
tm-load-test); `report` recomputes per-tx latency from the block store
by subtracting the stamped time from the committing block's time
(report/report.go).

The port's copy of the JAX package's tools/loadtime.py: the same tx
layout, so either package's report reads the other's load txs.
"""
from __future__ import annotations

import os
import statistics
import struct
import time
from dataclasses import dataclass
from typing import List, Optional

_MAGIC = b"loadtm01"
_HEADER = len(_MAGIC) + 8 + 8  # magic || seq(u64) || stamp_ns(u64)


def make_tx(seq: int, size: int = 64,
            stamp_ns: Optional[int] = None) -> bytes:
    """A load tx: magic || seq || wall-clock ns || padding
    (loadtime/payload proto analog, fixed binary layout)."""
    stamp = time.time_ns() if stamp_ns is None else stamp_ns
    body = _MAGIC + struct.pack(">QQ", seq, stamp)
    pad = max(0, size - len(body))
    return body + bytes((seq + i) & 0xFF for i in range(pad))


def parse_tx(tx: bytes):
    """(seq, stamp_ns) or None for non-load txs."""
    if len(tx) < _HEADER or not tx.startswith(_MAGIC):
        return None
    seq, stamp = struct.unpack(">QQ", tx[len(_MAGIC):_HEADER])
    return seq, stamp


def run_load(broadcast, rate: float, duration_s: float,
             size: int = 64) -> int:
    """Drive `broadcast(tx)` at ~rate tx/s for duration_s. Returns the
    number submitted. `broadcast` is any callable — an RPC client's
    broadcast_tx_sync or a node's broadcast_tx."""
    interval = 1.0 / rate if rate > 0 else 0.0
    t0 = time.monotonic()
    seq = 0
    while time.monotonic() - t0 < duration_s:
        broadcast(make_tx(seq, size))
        seq += 1
        next_at = t0 + seq * interval
        delay = next_at - time.monotonic()
        if delay > 0:
            time.sleep(delay)
    return seq


@dataclass
class LatencyReport:
    """report/report.go Report (subset)."""

    n_txs: int
    min_ms: float
    max_ms: float
    avg_ms: float
    p50_ms: float
    stddev_ms: float

    def __str__(self) -> str:
        return (f"{self.n_txs} txs  avg {self.avg_ms:.1f} ms  "
                f"p50 {self.p50_ms:.1f} ms  min {self.min_ms:.1f}  "
                f"max {self.max_ms:.1f}  stddev {self.stddev_ms:.1f}")


def report_from_blockstore(block_store) -> Optional[LatencyReport]:
    """Scan committed blocks for load txs; latency = block time -
    payload stamp (report/report.go:Generate)."""
    lat_ms: List[float] = []
    for h in range(max(1, block_store.base()),
                   block_store.height() + 1):
        blk = block_store.load_block(h)
        if blk is None:
            continue
        block_ns = (blk.header.time.seconds * 10**9
                    + blk.header.time.nanos)
        for tx in blk.data.txs:
            p = parse_tx(tx)
            if p is None:
                continue
            lat_ms.append((block_ns - p[1]) / 1e6)
    if not lat_ms:
        return None
    return LatencyReport(
        n_txs=len(lat_ms),
        min_ms=min(lat_ms),
        max_ms=max(lat_ms),
        avg_ms=statistics.fmean(lat_ms),
        p50_ms=statistics.median(lat_ms),
        stddev_ms=statistics.stdev(lat_ms) if len(lat_ms) > 1 else 0.0,
    )


def main(argv=None) -> int:
    """CLI: `loadtime load --rpc URL --rate R --duration D` and
    `loadtime report --data DIR`."""
    import argparse

    p = argparse.ArgumentParser(prog="loadtime")
    sub = p.add_subparsers(dest="cmd", required=True)
    q = sub.add_parser("load")
    q.add_argument("--rpc", required=True)
    q.add_argument("--rate", type=float, default=100.0)
    q.add_argument("--duration", type=float, default=10.0)
    q.add_argument("--size", type=int, default=64)
    q = sub.add_parser("report")
    q.add_argument("--data", required=True,
                   help="node data dir containing blockstore.db")
    args = p.parse_args(argv)
    if args.cmd == "load":
        from cometbft_tpu_torch.rpc.client import HTTPClient

        http = HTTPClient(args.rpc)
        n = run_load(http.broadcast_tx_sync, args.rate, args.duration,
                     args.size)
        print(f"submitted {n} txs")
        return 0
    from cometbft_tpu_torch.store.blockstore import BlockStore

    bs = BlockStore(os.path.join(args.data, "blockstore.db"))
    rep = report_from_blockstore(bs)
    print(rep if rep else "no load txs found")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
