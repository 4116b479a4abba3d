"""CheckTx admission control: the gate in front of ABCI.

Under a sustained broadcast_tx flood the failure mode is not one big
queue — it is three queues amplifying each other: RPC handler threads
pile up in CheckTx, the mempool fills, and the verify plane's BULK lane
backs up behind them. Admission control turns that collapse into fast,
explicit rejection at the front door:

  * bounded in-flight CheckTx — at most `max_inflight` concurrent
    CheckTx calls are admitted; the rest fast-reject with a
    retry-after hint instead of stacking handler threads;
  * queue-depth watermarks with hysteresis — when the mempool is
    `high_watermark` full the broadcast_tx path flips to fast-reject
    and stays rejecting until it drains below `low_watermark`
    (no reject/accept flapping at the boundary);
  * breaker-aware host-fallback limits — when the device circuit
    breaker is OPEN every signature verify runs on the 1-core host, so
    the inflight bound tightens to `breaker_inflight`: an open breaker
    must cost throughput, never melt the host.

Every rejection carries a `retry_after_ms` hint (the Retry-After
analog), surfaced through the CheckTx log and the JSON-RPC
broadcast_tx responses, so well-behaved clients back off instead of
retry-storming.

The port's copy of the JAX package's mempool/admission.py; its
`breaker_open_fn` reads the port's crypto/batch device breaker.
"""
from __future__ import annotations

import threading
from typing import Callable, NamedTuple, Optional

ADMITTED = "admitted"
REJECT_INFLIGHT = "rejected_inflight"
REJECT_WATERMARK = "rejected_watermark"
REJECT_BREAKER = "rejected_breaker"


class Decision(NamedTuple):
    admitted: bool
    outcome: str          # ADMITTED / REJECT_* (metrics label)
    retry_after_ms: float  # backoff hint; 0 when admitted


class AdmissionController:
    """Shared by the mempool (local CheckTx, reactor gossip intake) and
    the RPC broadcast_tx path. Thread-safe; decisions are count-based
    (no clocks), so simnet runs of the same schedule reject the same
    txs deterministically."""

    def __init__(self,
                 max_inflight: int = 64,
                 breaker_inflight: int = 8,
                 high_watermark: float = 0.9,
                 low_watermark: float = 0.7,
                 retry_after_ms: float = 500.0,
                 fill_fn: Optional[Callable[[], float]] = None,
                 breaker_open_fn: Optional[Callable[[], bool]] = None):
        self.max_inflight = max(1, int(max_inflight))
        self.breaker_inflight = max(1, int(breaker_inflight))
        self.high_watermark = float(high_watermark)
        self.low_watermark = min(float(low_watermark),
                                 self.high_watermark)
        self.retry_after_ms = float(retry_after_ms)
        # fill_fn: current mempool fill fraction in [0, 1]
        self._fill_fn = fill_fn or (lambda: 0.0)
        # breaker_open_fn: True while the device breaker is OPEN
        self._breaker_open_fn = breaker_open_fn or (lambda: False)
        self._lock = threading.Lock()
        self._inflight = 0
        self._saturated = False  # watermark hysteresis latch
        self.counts = {ADMITTED: 0, REJECT_INFLIGHT: 0,
                       REJECT_WATERMARK: 0, REJECT_BREAKER: 0}

    # -- the gate ----------------------------------------------------------

    def try_acquire(self) -> Decision:
        """One CheckTx wants in. Pair every admitted=True with a
        release() (the mempool does this in a finally)."""
        try:
            fill = float(self._fill_fn())
        except Exception:  # noqa: BLE001 - a sick gauge must not gate
            fill = 0.0
        try:
            breaker_open = bool(self._breaker_open_fn())
        except Exception:  # noqa: BLE001
            breaker_open = False
        with self._lock:
            # watermark hysteresis: latch at high, release at low
            if self._saturated:
                if fill <= self.low_watermark:
                    self._saturated = False
            elif fill >= self.high_watermark:
                self._saturated = True
            if self._saturated:
                self.counts[REJECT_WATERMARK] += 1
                return Decision(False, REJECT_WATERMARK,
                                self.retry_after_ms)
            limit = (self.breaker_inflight if breaker_open
                     else self.max_inflight)
            if self._inflight >= limit:
                outcome = (REJECT_BREAKER if breaker_open
                           else REJECT_INFLIGHT)
                self.counts[outcome] += 1
                return Decision(False, outcome, self.retry_after_ms)
            self._inflight += 1
            self.counts[ADMITTED] += 1
            return Decision(True, ADMITTED, 0.0)

    def release(self) -> None:
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1

    # -- controller actuator (libs/controller) -----------------------------

    def set_watermarks(self, high: float, low: float) -> tuple:
        """Retune the fill watermarks live (the self-tuning control
        plane tightens them under CONSENSUS pressure and relaxes them
        back). Both move under the lock the gate reads them under, and
        the low <= high invariant is preserved unconditionally — a bad
        caller degrades to a coherent gate, never an inverted one.
        The saturation latch is left alone: the next try_acquire
        re-evaluates it against the new marks."""
        with self._lock:
            self.high_watermark = min(1.0, max(0.01, float(high)))
            self.low_watermark = min(max(0.0, float(low)),
                                     self.high_watermark)
            return (self.high_watermark, self.low_watermark)

    # -- observability -----------------------------------------------------

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def saturated(self) -> bool:
        with self._lock:
            return self._saturated

    def stats(self) -> dict:
        with self._lock:
            return {
                "inflight": self._inflight,
                "saturated": self._saturated,
                "counts": dict(self.counts),
                "max_inflight": self.max_inflight,
                "breaker_inflight": self.breaker_inflight,
                "high_watermark": self.high_watermark,
                "low_watermark": self.low_watermark,
            }
