"""Low-overhead span/event tracer with Chrome trace-event export.

The Prometheus surface (libs/metrics.py) answers "how much, on
average"; it cannot answer "where did THIS flush's 4 ms go" or "why did
this simnet schedule wedge". This module is the missing axis: named
spans and instants recorded into a bounded in-memory ring buffer, and
exported as Chrome trace-event JSON (load the file straight into
https://ui.perfetto.dev). Committee-consensus measurement work (arXiv:
2302.00418) and the FPGA verification-engine paper (arXiv:2112.02229)
both attribute their wins via per-stage latency decomposition — this is
that instrument, built into the node.

Design rules:

  * OFF BY DEFAULT, and near-free while off: every hook is a module
    function that loads one global and returns a shared no-op context
    manager when no tracer is installed. Call sites fire per flush /
    per step / per fsync — never per signature.
  * Clock is ``time.perf_counter_ns`` by default. The simnet installs
    ``Timestamp.now().to_ns()`` (its virtual clock) via
    :func:`set_clock`, so the same (seed, schedule) produces an
    IDENTICAL trace — a wedged schedule's trace is replayable evidence,
    not a heisen-log. ``deterministic=True`` additionally pins tid/pid
    so two runs export byte-identical JSON.
  * Bounded: the ring buffer (``capacity`` events, deque) makes the
    tracer safe to leave enabled on a long-lived node; ``/dump_traces``
    on the RPC surface serves whatever the ring currently holds.

Event vocabulary (Chrome trace-event phases):

  span(name)            -> one "X" (complete) event, ts+dur
  instant(name)         -> one "i" event
  flight_begin/end(id)  -> "b"/"e" async events correlated by id; used
                           for verify-plane flights so pack(k+1)
                           VISIBLY overlaps device-flight(k) in the UI

An opt-in ``torch.profiler`` bracket (:func:`profiler_start` /
:func:`profiler_stop`, armed by ``[tracing] profile_dir``) wraps
verify-plane flights so device traces line up with the host spans; each
bracket writes one Chrome trace into ``profile_dir``.

The port's copy of the JAX package's libs/tracing.py; only the profiler
bracket differs (the JAX package brackets with ``jax.profiler``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional

DEFAULT_CAPACITY = 16384


class _NullSpan:
    """Shared no-op context manager: the disabled-path cost of a span
    is one global load + one `with` on this singleton."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tr", "name", "cat", "args", "t0")

    def __init__(self, tr: "Tracer", name: str, cat: str, args: dict):
        self.tr = tr
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.t0 = self.tr._clock()
        return self

    def __exit__(self, *exc):
        self.tr._complete(self.name, self.cat, self.t0,
                          self.tr._clock() - self.t0, self.args)
        return False


class Tracer:
    """A bounded ring of Chrome trace events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Callable[[], int]] = None,
                 deterministic: bool = False):
        self.capacity = max(16, int(capacity))
        self.deterministic = bool(deterministic)
        self._events: deque = deque(maxlen=self.capacity)
        self._clock = clock or _CLOCK or time.perf_counter_ns
        self.dropped = 0  # events pushed past a full ring

    # -- clock -------------------------------------------------------------

    def set_clock(self, fn: Optional[Callable[[], int]]) -> None:
        """Install a ns clock (None restores perf_counter_ns)."""
        self._clock = fn or time.perf_counter_ns

    def _tid(self) -> int:
        return 0 if self.deterministic else threading.get_ident()

    # -- recording ---------------------------------------------------------

    def _push(self, ev: dict) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def _complete(self, name: str, cat: str, t0_ns: int, dur_ns: int,
                  args: dict) -> None:
        ev = {"ph": "X", "name": name, "cat": cat or "app",
              "ts": t0_ns / 1000.0, "dur": dur_ns / 1000.0,
              "pid": 1, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._push(ev)

    def span(self, name: str, cat: str = "", **args) -> _Span:
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        ev = {"ph": "i", "name": name, "cat": cat or "app",
              "ts": self._clock() / 1000.0, "s": "t",
              "pid": 1, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._push(ev)

    def flight_begin(self, name: str, fid, cat: str = "", **args) -> None:
        ev = {"ph": "b", "name": name, "cat": cat or "app",
              "id": str(fid), "ts": self._clock() / 1000.0,
              "pid": 1, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._push(ev)

    def flight_end(self, name: str, fid, cat: str = "", **args) -> None:
        ev = {"ph": "e", "name": name, "cat": cat or "app",
              "id": str(fid), "ts": self._clock() / 1000.0,
              "pid": 1, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._push(ev)

    # -- export ------------------------------------------------------------

    def events(self) -> List[dict]:
        # list(deque) is one C-level call that holds the GIL end to
        # end (deque iteration never calls back into Python), so the
        # snapshot is atomic against concurrent _push appends — no
        # lock on the hot path. Anything fancier than list() here
        # (e.g. a comprehension over self._events) would break that.
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0

    def tail(self, n: int = 40) -> List[str]:
        """The last n event names (with phase), newest last — compact
        enough to ride a simnet replay blob."""
        evs = list(self._events)[-n:]
        return [f"{e['name']}({e['ph']})" for e in evs]

    def chrome_trace(self) -> dict:
        """Perfetto/chrome://tracing-loadable document."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


# --------------------------------------------------------------------------
# the process-global tracer (None = tracing disabled)
# --------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None
# module-default clock: installed by the simnet BEFORE/while a tracer
# exists so deterministic runs never see a wall-clock timestamp
_CLOCK: Optional[Callable[[], int]] = None
# bumped whenever the clock monotonic_ns() resolves to can change
# domain (set_clock / enable / disable): two monotonic_ns() readings
# are only comparable when taken under the same generation
_CLOCK_GEN: int = 0


def enable(capacity: int = DEFAULT_CAPACITY,
           clock: Optional[Callable[[], int]] = None,
           deterministic: bool = False) -> Tracer:
    """Install (and return) a fresh global tracer."""
    global _TRACER, _CLOCK_GEN
    _TRACER = Tracer(capacity, clock, deterministic)
    _CLOCK_GEN += 1
    return _TRACER


def disable() -> None:
    global _TRACER, _CLOCK_GEN
    _TRACER = None
    _CLOCK_GEN += 1


def enabled() -> bool:
    return _TRACER is not None


def tracer() -> Optional[Tracer]:
    return _TRACER


def set_clock(fn: Optional[Callable[[], int]]) -> None:
    """Install a ns clock for the current AND any future tracer. The
    simnet passes ``lambda: Timestamp.now().to_ns()`` so traces run on
    the virtual clock; None restores perf_counter_ns."""
    global _CLOCK, _CLOCK_GEN
    _CLOCK = fn
    _CLOCK_GEN += 1
    t = _TRACER
    if t is not None:
        t.set_clock(fn)


def clock_ns() -> Optional[int]:
    """The installed tracer's clock reading, or None when tracing is
    off. Callers that stamp their own correlation timestamps (e.g. the
    verify plane's submit-to-pack queue wait) MUST use this instead of
    a wall clock so the stamps stay on the trace timeline — and stay
    deterministic under the simnet's virtual clock."""
    t = _TRACER
    return None if t is None else t._clock()


def monotonic_ns() -> int:
    """Always-available ns clock for ALWAYS-ON accounting (the verify
    plane's flush ledger): the tracer's clock when one is enabled (so
    ledger stamps share the trace timeline), else the module clock when
    installed (virtual under simnet — ledgers of the same (seed,
    schedule) replay identically), else time.perf_counter_ns. Unlike
    :func:`clock_ns` this never returns None: the ledger records every
    flush whether or not tracing is on."""
    t = _TRACER
    if t is not None:
        return t._clock()
    c = _CLOCK
    return c() if c is not None else time.perf_counter_ns()


def module_clock_installed() -> bool:
    """True when a module-default clock is installed (the simnet's
    virtual clock). Real-clock background pollers (the incident
    watchdog ticker) gate on this: a wall-clock poke evaluated against
    virtual-clock stamps would fire garbage incidents AND break simnet
    replay determinism."""
    return _CLOCK is not None


def clock_gen() -> int:
    """Generation counter for :func:`monotonic_ns`'s clock domain.
    Holders of a stored stamp (the verify plane's submit-time
    queued_ms anchor) compare generations before differencing two
    readings: a simnet clock install/restore between stamp and use
    would otherwise difference a virtual-epoch ns against a
    perf_counter ns and produce a garbage duration."""
    return _CLOCK_GEN


def span(name: str, cat: str = "", **args):
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, cat, **args)


def flight_begin(name: str, fid, cat: str = "", **args) -> None:
    t = _TRACER
    if t is not None:
        t.flight_begin(name, fid, cat, **args)


def flight_end(name: str, fid, cat: str = "", **args) -> None:
    t = _TRACER
    if t is not None:
        t.flight_end(name, fid, cat, **args)


def export_chrome() -> dict:
    t = _TRACER
    if t is None:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    return t.chrome_trace()


def write(path: str) -> None:
    t = _TRACER
    if t is not None:
        t.write(path)


def tail(n: int = 40) -> List[str]:
    t = _TRACER
    return [] if t is None else t.tail(n)


# --------------------------------------------------------------------------
# opt-in torch.profiler bracket ([tracing] profile_dir)
# --------------------------------------------------------------------------

_PROFILE_DIR: str = ""
_PROFILE_LOCK = threading.Lock()
_PROFILING = False
_PROFILER = None   # the running torch.profiler.profile, while _PROFILING
_PROFILES = 0      # traces written by this process (file name ordinal)


def set_profile_dir(path: str) -> None:
    global _PROFILE_DIR
    _PROFILE_DIR = path or ""


def profile_dir() -> str:
    return _PROFILE_DIR


def profiler_start() -> bool:
    """Start a torch.profiler capture (host and, with a card, CUDA
    activity) for profile_dir (no-op unless a dir is configured AND
    tracing is enabled — the capture exists to line device timelines up
    with host spans, and gating on the tracer keeps `enable = false`
    genuinely free even with a profile_dir configured). Returns True when
    THIS call started a capture — the caller that got True must call
    :func:`profiler_stop` when its bracketed work lands (one capture at a
    time, so overlapping flights share one capture)."""
    global _PROFILING, _PROFILER
    if not _PROFILE_DIR or _TRACER is None:
        return False
    with _PROFILE_LOCK:
        if _PROFILING:
            return False
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        except Exception:  # noqa: BLE001 - profiling must never fault
            return False
        _PROFILER = prof
        _PROFILING = True
        return True


def profiler_stop() -> None:
    """Stop the running capture and write it as a Chrome trace,
    ``<profile_dir>/plane-<pid>-<n>.json``."""
    global _PROFILING, _PROFILER, _PROFILES
    with _PROFILE_LOCK:
        if not _PROFILING:
            return
        prof, _PROFILER, _PROFILING = _PROFILER, None, False
        try:
            prof.stop()
            os.makedirs(_PROFILE_DIR, exist_ok=True)
            _PROFILES += 1
            prof.export_chrome_trace(os.path.join(
                _PROFILE_DIR, f"plane-{os.getpid()}-{_PROFILES}.json"))
        except Exception:  # noqa: BLE001 - profiling must never fault
            pass
