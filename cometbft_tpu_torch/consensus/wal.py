"""Write-ahead log: crc32 + length framed records, fsync, replay search.

Reference: consensus/wal.go:57-90 (baseWAL over autofile.Group),
Write/WriteSync (:185,202), maxMsgSizeBytes (:28), SearchForEndHeight
(:232), and wal.go:131 EndHeightMessage written at height transitions.

Record frame (wal.go WALEncoder): crc32(payload) uint32 BE | length
uint32 BE | payload. Payloads here are this framework's own compact
tagged encodings (the WAL is node-internal state, not a cross-
implementation wire format).

The port's copy of the JAX package's consensus/wal.py: the same framing,
CRC, record kinds and payload bytes, so either package replays the
other's WAL. The wal.* failpoints register on the port's
libs/failpoints, a registry separate from the JAX package's.
"""
from __future__ import annotations

import logging
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.libs import tracing

_log = logging.getLogger(__name__)

MAX_MSG_SIZE = 1 << 20  # 1MB, wal.go:28

# Process-wide fsync latency accumulator, sampled at scrape time by
# NodeMetrics (the WAL has no metrics handle — same pattern as the
# device breaker). Durations use the REAL clock even under simnet:
# fsync cost is host truth, not simulated time. Locked: multiple WAL
# instances fsync concurrently in multi-node-in-process tests.
_FSYNC_STATS = {"count": 0, "seconds": 0.0, "max_seconds": 0.0}
_FSYNC_LOCK = threading.Lock()


def fsync_stats() -> dict:
    with _FSYNC_LOCK:
        return dict(_FSYNC_STATS)

# crash-prone seams of the WAL itself (libs/fail call sites of the
# reference live one layer up in consensus; these cover the file ops)
fp.register("wal.pre_write", "before a record is buffered")
fp.register("wal.post_write", "after a record is buffered, pre-fsync")
fp.register("wal.pre_fsync", "after flush, before fsync reaches disk")
fp.register("wal.mid_rotate",
            "head renamed to segment, new head not yet open")

# record kinds
END_HEIGHT = 0
MSG_INFO = 1
TIMEOUT_INFO = 2
EVENT = 3


class WALError(Exception):
    pass


@dataclass
class WALRecord:
    kind: int
    data: bytes


HEAD_SIZE_LIMIT = 10 * 1024 * 1024  # autofile defaultHeadSizeLimit
MAX_SEGMENTS = 20                   # rotated files kept (capacity cap)


class WAL:
    """Append-only WAL with size-based rotation (the autofile.Group of
    the reference, wal.go:57 baseWAL over group).

    Rotation happens ONLY at height boundaries (right after an
    ENDHEIGHT record): crash-replay starts at ENDHEIGHT(h-1), so
    aligning segments to heights means a replay never needs a record
    that predates the oldest retained segment while that height is
    still live. Rotated segments are `<path>.NNN` (ascending age) and
    pruned beyond MAX_SEGMENTS."""

    def __init__(self, path: str,
                 head_size_limit: int = HEAD_SIZE_LIMIT,
                 max_segments: int = MAX_SEGMENTS):
        self.path = path
        self.head_size_limit = head_size_limit
        self.max_segments = max_segments
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        dropped = self.repair_tail(path)
        if dropped:
            _log.warning(
                "wal: repaired corrupt tail of %s (%d bytes dropped)",
                path, dropped,
            )
        self._f = open(path, "ab")
        # per-WAL fsync time on the LEDGER clock (tracing.monotonic_ns:
        # virtual under simnet, real monotonic in production) — the
        # height ledger attributes per-height WAL fsync ms from deltas
        # of this accumulator, so the attribution stays byte-identical
        # across simnet replays while the process-wide _FSYNC_STATS
        # above keeps recording host truth for /metrics
        self.fsync_led_ns = 0

    @staticmethod
    def repair_tail(path: str) -> int:
        """Truncate a torn/corrupt tail off the HEAD file so appends
        land after the last valid record. Returns bytes dropped.

        A crash mid-write leaves a torn frame (or fsync'd garbage) at
        the end of the head; the replay decoder stops there, but a
        node that keeps APPENDING after it would write records the
        decoder can never reach — every post-restart record would be
        silently invisible to the next replay. The reference repairs
        this in autofile/group + wal.go's corrupted-WAL handling; here
        the repair runs on open, before the append handle is created.
        """
        if not os.path.exists(path):
            return 0
        size = os.path.getsize(path)
        good_end = WAL._scan_valid_prefix(path)
        if good_end >= size:
            return 0
        with open(path, "r+b") as f:
            f.truncate(good_end)
        return size - good_end

    @staticmethod
    def _scan_valid_prefix(path: str) -> int:
        """Byte offset just past the last valid record frame."""
        good = 0
        with open(path, "rb") as f:
            while True:
                head = f.read(8)
                if len(head) < 8:
                    break
                crc, length = struct.unpack(">II", head)
                if length == 0 or length > MAX_MSG_SIZE:
                    break
                payload = f.read(length)
                if len(payload) < length:
                    break
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    break
                good += 8 + length
        return good

    def write(self, kind: int, data: bytes) -> None:
        """Buffered write (wal.go:185 Write)."""
        fp.fail_point("wal.pre_write")
        payload = bytes([kind]) + data
        if len(payload) > MAX_MSG_SIZE:
            raise WALError(f"msg is too big: {len(payload)}")
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._f.write(struct.pack(">II", crc, len(payload)) + payload)
        fp.fail_point("wal.post_write")

    def write_sync(self, kind: int, data: bytes) -> None:
        """Write + flush + fsync (wal.go:202 WriteSync) — used for every
        message that must survive a crash before the action it describes
        is taken."""
        with tracing.span("wal.write_sync", cat="wal", bytes=len(data)):
            self.write(kind, data)
            self.flush_and_sync()

    def write_end_height(self, height: int) -> None:
        self.write_sync(END_HEIGHT, struct.pack(">q", height))
        if self._f.tell() >= self.head_size_limit:
            self._rotate()

    def _rotate(self) -> None:
        """Head -> numbered segment, fresh head (autofile group
        RotateFile); prune the oldest segments beyond max_segments."""
        self._f.close()
        seqs = self._segments()
        nxt = (seqs[-1] + 1) if seqs else 0
        os.replace(self.path, f"{self.path}.{nxt:03d}")
        fp.fail_point("wal.mid_rotate")
        self._f = open(self.path, "ab")
        seqs.append(nxt)
        for old in seqs[: max(0, len(seqs) - self.max_segments)]:
            try:
                os.remove(f"{self.path}.{old:03d}")
            except OSError:
                pass

    def _segments(self) -> list:
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path) + "."
        out = []
        for name in os.listdir(d):
            if name.startswith(base) and name[len(base):].isdigit():
                out.append(int(name[len(base):]))
        return sorted(out)

    def flush_and_sync(self) -> None:
        self._f.flush()
        fp.fail_point("wal.pre_fsync")
        t0 = time.perf_counter()
        t0_led = tracing.monotonic_ns()
        with tracing.span("wal.fsync", cat="wal"):
            os.fsync(self._f.fileno())
        dt = time.perf_counter() - t0
        d_led = tracing.monotonic_ns() - t0_led
        if d_led > 0:  # a clock-domain swap mid-fsync yields garbage
            self.fsync_led_ns += d_led
        with _FSYNC_LOCK:
            _FSYNC_STATS["count"] += 1
            _FSYNC_STATS["seconds"] += dt
            if dt > _FSYNC_STATS["max_seconds"]:
                _FSYNC_STATS["max_seconds"] = dt

    def close(self) -> None:
        try:
            self.flush_and_sync()
        except (ValueError, OSError):
            pass  # handle already closed (e.g. a crash mid-rotation)
        finally:
            self._f.close()

    # -- replay --------------------------------------------------------------

    @staticmethod
    def _paths(path: str) -> list:
        """All files of the group, oldest first, head last."""
        d = os.path.dirname(path) or "."
        base = os.path.basename(path) + "."
        segs = []
        if os.path.isdir(d):
            for name in os.listdir(d):
                if name.startswith(base) and name[len(base):].isdigit():
                    segs.append(int(name[len(base):]))
        out = [f"{path}.{s:03d}" for s in sorted(segs)]
        if os.path.exists(path):
            out.append(path)
        return out

    @staticmethod
    def iter_records(path: str) -> Iterator[WALRecord]:
        """Decode records across the whole group (rotated segments then
        head); stops at first corruption (torn final write is normal
        after a crash — wal.go decoder's io.ErrUnexpectedEOF)."""
        paths = WAL._paths(path)
        for pi, p in enumerate(paths):
            is_head = pi == len(paths) - 1
            with open(p, "rb") as f:
                while True:
                    head = f.read(8)
                    if not head:
                        break
                    if len(head) < 8:
                        # a torn header is only a normal crash artifact in
                        # the head (last) file; in a rotated segment it
                        # means mid-stream truncation — stop like any
                        # other corruption rather than splicing segments
                        if is_head:
                            break
                        return
                    crc, length = struct.unpack(">II", head)
                    # length==0 can pass the CRC check (crc32(b"")==0)
                    # on a zero-filled tail; real records always carry
                    # a kind byte, so treat it as corruption
                    if length == 0 or length > MAX_MSG_SIZE:
                        return
                    payload = f.read(length)
                    if len(payload) < length:
                        return
                    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                        return
                    yield WALRecord(payload[0], payload[1:])

    @staticmethod
    def search_for_end_height(
        path: str, height: int
    ) -> Optional[int]:
        """Record index right after ENDHEIGHT(height) (wal.go:232), or
        None if not found."""
        found = None
        for i, rec in enumerate(WAL.iter_records(path)):
            if rec.kind == END_HEIGHT:
                (h,) = struct.unpack(">q", rec.data)
                if h == height:
                    found = i + 1
        return found
