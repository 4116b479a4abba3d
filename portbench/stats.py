"""The arithmetic that turns a run's readings into metrics."""
from __future__ import annotations

import math
from typing import Optional, Sequence

from portbench.frozen import opcounts


def mean(xs: Sequence[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def p95(xs: Sequence[float]) -> Optional[float]:
    """The 95th percentile of all values, by nearest rank."""
    if not xs:
        return None
    s = sorted(xs)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def roofline_pct(kernel: str, rows: int, seconds: float) -> Optional[float]:
    """The share of the card's peak that `rows` verified signatures of a
    kernel reach in `seconds` of that kernel's device time."""
    if rows <= 0 or seconds <= 0:
        return None
    work = opcounts.MULADDS_PER_SIGNATURE[kernel] * rows
    return 100.0 * work / opcounts.PEAK_MULADDS_PER_S / seconds


def idle_pct(busy_s: float, window_s: float) -> Optional[float]:
    if window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s / window_s)


def slice_roofline(profile, kernel: str) -> Optional[float]:
    """`roofline_pct` of a kernel over a profiled slice, or None where the
    slice holds none of its events."""
    seconds = profile.kernel_seconds(kernel) if profile else None
    if not seconds:
        return None
    return roofline_pct(kernel, profile.rows.get(kernel, 0), seconds)
