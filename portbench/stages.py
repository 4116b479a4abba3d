"""The stream verifier's stage readings over the measured window, for the
per-layer metrics of its stages (`metrics/chunk_<stage>_ms.stream.py`,
`metrics/call_precheck_ms.stream.py`).

The program keeps them, always on, in `StreamVerifier.stats`:
`host_ms` a chunk, `stage_ms[stage]` a list parallel to it, and
`precheck_ms` a call, as (index of the call's first chunk, ms). The
window's chunks are the run of a live verifier's `host_ms` that holds,
in order, the very float objects of the record's `chunk_host_ms` (the
stream's traffic driver slices them out of that list), so the warm-up's
chunks before it and the profiled slice's after it are left out. Where
the program keeps no such readings (an older program, the control) or
no run matches, a reader returns None and the metric is left out.
"""
from __future__ import annotations

from typing import Optional, Tuple

from portbench import stats


def window(rec) -> Optional[Tuple[dict, int, int]]:
    """(the verifier's stats, first, end) of the window's chunks in its
    `host_ms`, or None."""
    ours = rec.layer.get("chunk_host_ms") or []
    if not ours:
        return None
    from cometbft_tpu_torch.blocksync import pipeline

    live = getattr(pipeline, "live_verifiers", None)
    for sv in live() if live else ():
        st = getattr(sv, "stats", None) or {}
        host = st.get("host_ms", [])
        for a, x in enumerate(host):
            if x is ours[0]:
                b = a + len(ours)
                if b <= len(host) and all(
                        y is z for y, z in zip(host[a:b], ours)):
                    return st, a, b
                break
    return None


def chunk_mean(rec, stage: str) -> Optional[float]:
    """The mean of a chunk stage's milliseconds over the window."""
    found = window(rec)
    if found is None:
        return None
    st, a, b = found
    xs = st.get("stage_ms", {}).get(stage)
    return stats.mean(xs[a:b]) if xs and len(xs) >= b else None


def precheck_mean(rec) -> Optional[float]:
    """The mean precheck milliseconds of the calls whose chunks are the
    window's."""
    found = window(rec)
    if found is None:
        return None
    st, a, b = found
    return stats.mean([ms for k, ms in st.get("precheck_ms", [])
                       if a <= k < b])
