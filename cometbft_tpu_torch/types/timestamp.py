"""Timestamp: (seconds, nanos) pair matching google.protobuf.Timestamp.

Stored as raw ints, not a datetime: the pair is signed over byte-exactly
(types/canonical.go), and Go's zero time (0001-01-01T00:00:00Z) encodes
as seconds = -62135596800 — outside datetime-friendly ranges. Reference
canonicalization (types/time/time.go Canonical) is Round(0).UTC(), i.e.
strip monotonic clock + force UTC — a no-op on a plain pair.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Callable, Optional

# Seconds of Go's zero time relative to the Unix epoch.
GO_ZERO_SECONDS = -62135596800

# Pluggable wall-clock source (types/time/time.go Now is similarly a
# package-level seam): the Byzantine simnet installs a logical clock here
# so every Timestamp.now() during a simulation is a deterministic function
# of the schedule, not of the host's wall clock. None = real time.
_NOW_SOURCE: Optional[Callable[[], "Timestamp"]] = None


def set_now_source(fn: Optional[Callable[[], "Timestamp"]]) -> None:
    """Install (or clear, with None) the process-wide time source."""
    global _NOW_SOURCE
    _NOW_SOURCE = fn


@dataclass(frozen=True, order=True)
class Timestamp:
    seconds: int = GO_ZERO_SECONDS
    nanos: int = 0

    @staticmethod
    def now() -> "Timestamp":
        if _NOW_SOURCE is not None:
            return _NOW_SOURCE()
        ns = _time.time_ns()
        return Timestamp(ns // 1_000_000_000, ns % 1_000_000_000)

    def is_zero(self) -> bool:
        return self.seconds == GO_ZERO_SECONDS and self.nanos == 0

    def to_ns(self) -> int:
        return self.seconds * 1_000_000_000 + self.nanos


ZERO = Timestamp()
