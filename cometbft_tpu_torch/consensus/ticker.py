"""TimeoutTicker: schedules consensus step timeouts.

Reference: consensus/ticker.go (timeoutTicker: one outstanding timeout,
newer (height, round, step) overrides older) and config/config.go
Consensus timeouts (TimeoutPropose 3s + 500ms/round, Prevote/Precommit
1s + 500ms/round, Commit 1s).

Two implementations: a real threading.Timer ticker and a manual one for
deterministic step-machine tests (the swappable-ticker hook the
reference exposes via cs.timeoutTicker / state.go:122-125 test overrides).

The port's copy of the JAX package's consensus/ticker.py.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass(frozen=True, order=True)
class TimeoutInfo:
    height: int
    round: int
    step: int  # RoundStep* constant
    duration: float = 0.0


@dataclass
class TimeoutParams:
    propose: float = 3.0
    propose_delta: float = 0.5
    prevote: float = 1.0
    prevote_delta: float = 0.5
    precommit: float = 1.0
    precommit_delta: float = 0.5
    commit: float = 1.0

    def propose_timeout(self, round_: int) -> float:
        return self.propose + self.propose_delta * round_

    def prevote_timeout(self, round_: int) -> float:
        return self.prevote + self.prevote_delta * round_

    def precommit_timeout(self, round_: int) -> float:
        return self.precommit + self.precommit_delta * round_


class TimeoutTicker:
    """Real ticker: one live timer; newer HRS replaces older
    (ticker.go timeoutRoutine)."""

    def __init__(self, fire: Callable[[TimeoutInfo], None]):
        self._fire = fire
        self._timer: Optional[threading.Timer] = None
        self._current: Optional[TimeoutInfo] = None
        self._lock = threading.Lock()

    def schedule(self, ti: TimeoutInfo) -> None:
        with self._lock:
            # ticker.go timeoutRoutine: ignore timeouts for an older or
            # equal (height, round, step) than the scheduled one — a
            # lower-step schedule must never cancel a later-step timer
            # (e.g. prevote-wait displacing the round's one-shot
            # precommit-wait would deadlock the round)
            if self._current is not None:
                cur = self._current
                if (ti.height, ti.round, ti.step) <= (
                    cur.height, cur.round, cur.step
                ):
                    return
            if self._timer is not None:
                self._timer.cancel()
            self._current = ti
            self._timer = threading.Timer(ti.duration, self._fire, [ti])
            self._timer.daemon = True
            self._timer.start()

    def stop(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None


class ManualTicker:
    """Deterministic ticker for tests: schedules are recorded; the test
    fires them explicitly."""

    def __init__(self, fire: Callable[[TimeoutInfo], None]):
        self._fire = fire
        self.scheduled = []

    def schedule(self, ti: TimeoutInfo) -> None:
        self.scheduled.append(ti)

    def fire_next(self) -> Optional[TimeoutInfo]:
        if not self.scheduled:
            return None
        ti = self.scheduled.pop(0)
        self._fire(ti)
        return ti

    def stop(self) -> None:
        self.scheduled.clear()
