"""Always-on statesync accounting: chunk fetch/apply outcomes,
provider lifecycle, and snapshot-serving verdicts.

Statesync was invisible before this module: the engine punished and
dropped providers, timed out fetches, and restarted whole snapshot
rounds with no counter anywhere an operator could scrape. These are
plain process-global integers (no metrics handle in scope down in the
chunk engine), SAMPLED by ``NodeMetrics._sample`` at scrape time into
the ``cometbft_statesync_*`` families — the same pull model the WAL
fsync and failpoint counters use.

The counters are cumulative for the process. Tests that assert exact
accounting call :func:`reset` (or diff against a :func:`stats`
snapshot) around the section they measure.
"""
from __future__ import annotations

import threading
from typing import Dict

FIELDS = (
    # fetch side (chunks.py / syncer.py)
    "chunks_fetched",         # chunk payloads accepted into the queue
    "chunks_applied",         # chunks the app ACCEPTed during restore
    "fetch_timeouts",         # applier waits that expired with no chunk
    "providers_punished",     # failure strikes counted against providers
    "providers_dropped",      # providers dropped at MAX_PROVIDER_FAILURES
    "retry_snapshot_rounds",  # whole-snapshot RETRY_SNAPSHOT restarts
    "snapshots_offered",      # offers the local app accepted for restore
    "snapshots_restored",     # restores verified against the light client
    # serving side (p2p_reactor.py / snapshots.py serve gate)
    "snapshots_served",       # snapshot listings answered to peers
    "snapshots_shed",         # snapshot listings shed by the serve gate
    "chunks_served",          # chunk requests answered to peers
    "chunks_shed",            # chunk requests shed with a retry hint
)

_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {f: 0 for f in FIELDS}


def bump(field: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[field] = _COUNTS.get(field, 0) + n


def stats() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTS)


def reset() -> None:
    with _LOCK:
        for f in list(_COUNTS):
            _COUNTS[f] = 0
