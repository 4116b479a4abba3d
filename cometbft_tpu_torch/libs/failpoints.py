"""Deterministic fault injection: named failpoints at crash-prone seams.

Reference: libs/fail/fail.go — `fail.Fail("name")` call sites compiled
into the consensus write path, armed via the FAIL_TEST_INDEX env var so
CI can kill the process at every index and assert WAL recovery
(consensus/replay_test.go crashWALandCheckpointer).

This build generalizes the mechanism:

  * call sites register a NAMED point once at import
    (``register("wal.pre_fsync", "...")``) and evaluate it with
    ``fail_point("wal.pre_fsync")`` — a dict lookup when nothing is
    armed, so production cost is negligible;
  * points are armed programmatically (``arm(name, action, ...)``) or
    via the ``CBT_FAILPOINTS`` env var / ``[failpoints] spec`` config
    key, syntax::

        name=action[:arg][*count][;name2=...]

    e.g. ``CBT_FAILPOINTS="wal.pre_fsync=crash*1;p2p.dial=flake:3"``;
  * actions: ``crash`` (kill the process — overridable with
    :func:`set_crash_handler` so in-process tests can simulate the
    kill), ``raise`` (raise :class:`FailpointError`), ``delay:SECONDS``
    (sleep), ``flake:K`` (raise on every K-th evaluation —
    deterministic, no RNG);
  * ``*count`` bounds how many times the point FIRES before it
    self-disarms (the per-point trigger count of the reference's
    FAIL_TEST_INDEX loop).

Everything is thread-safe; hit/fire counters are exposed for tests and
the ops surface.

The port's copy of the JAX package's libs/failpoints.py; its
process-global registry is separate from the JAX package's.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

_log = logging.getLogger(__name__)

ENV_VAR = "CBT_FAILPOINTS"

ACTIONS = ("crash", "raise", "delay", "flake")


class FailpointError(Exception):
    """Raised by a fired ``raise``/``flake`` failpoint."""


class SimulatedCrash(FailpointError):
    """In-process stand-in for a process kill.

    Tests install ``set_crash_handler(simulated_crash)`` so an armed
    ``crash`` point unwinds the current thread instead of calling
    ``os._exit`` — the consensus receive routine treats it as fatal
    (the node halts) but pytest survives to restart the node and
    assert WAL recovery.
    """


def _default_crash(name: str) -> None:
    # the reference's fail.Fail calls os.Exit(1): no atexit, no flush,
    # no graceful anything — exactly the crash being simulated
    _log.error("failpoint %s: crashing process", name)
    os._exit(3)


def simulated_crash(name: str) -> None:
    raise SimulatedCrash(f"failpoint {name}: simulated crash")


@dataclass
class _Point:
    name: str
    action: str = ""         # "" = registered but disarmed
    arg: float = 0.0         # delay seconds / flake period
    remaining: int = -1      # fires left; -1 = unlimited
    hits: int = 0            # evaluations while armed
    fires: int = 0           # times the action actually ran
    doc: str = ""


def _default_fire_hook(name: str, action: str) -> None:
    """Every fired failpoint becomes a trace instant: a fault-injection
    run's trace shows exactly which seam faulted when, interleaved with
    the consensus/WAL spans it perturbed."""
    from cometbft_tpu_torch.libs import tracing

    tracing.instant("failpoint.fire", cat="failpoints",
                    point=name, action=action)


@dataclass
class FailpointRegistry:
    _points: Dict[str, _Point] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _armed: int = 0          # fast-path gate: 0 -> fail_point is a no-op
    _crash: Callable[[str], None] = _default_crash
    _env_loaded: bool = False
    # fired-point observer (trace/metric hook); None = the module
    # default (trace instant). swap_registry propagates it so per-node
    # simnet registries keep tracing through swaps.
    _fire_hook: Optional[Callable[[str, str], None]] = None

    # -- registration ------------------------------------------------------

    def register(self, name: str, doc: str = "") -> None:
        """Declare a failpoint name (idempotent). Call sites register at
        import so `names()` lists every seam the build can fault."""
        with self._lock:
            p = self._points.get(name)
            if p is None:
                self._points[name] = _Point(name, doc=doc)
            elif doc and not p.doc:
                p.doc = doc

    def names(self) -> Dict[str, str]:
        with self._lock:
            return {p.name: p.doc for p in self._points.values()}

    # -- arming ------------------------------------------------------------

    def arm(self, name: str, action: str, arg: float = 0.0,
            count: int = -1) -> None:
        if action not in ACTIONS:
            raise ValueError(
                f"unknown failpoint action {action!r}; want one of "
                f"{ACTIONS}"
            )
        if action == "flake" and arg < 1:
            arg = 2.0  # every 2nd call — a flake that never fires is a bug
        with self._lock:
            p = self._points.get(name)
            if p is None:
                p = self._points[name] = _Point(name)
            if not p.action:
                self._armed += 1
            p.action, p.arg, p.remaining = action, arg, count
            p.hits = p.fires = 0
        _log.warning("failpoint ARMED: %s=%s arg=%s count=%s",
                     name, action, arg, count)

    def disarm(self, name: str) -> None:
        with self._lock:
            p = self._points.get(name)
            if p is not None and p.action:
                p.action = ""
                self._armed -= 1

    def reset(self) -> None:
        """Disarm everything and zero counters (test teardown)."""
        with self._lock:
            for p in self._points.values():
                p.action = ""
                p.hits = p.fires = 0
                p.remaining = -1
            self._armed = 0
            self._env_loaded = True  # a reset also cancels env arming

    def set_crash_handler(self, fn: Optional[Callable[[str], None]]) -> None:
        self._crash = fn or _default_crash

    # -- spec parsing ------------------------------------------------------

    def arm_from_spec(self, spec: str) -> int:
        """Arm from a ``name=action[:arg][*count]`` list; returns how
        many points were armed. Unknown names are allowed (the module
        owning the seam may not be imported yet) — arming creates the
        point and the call site attaches when it registers."""
        clauses = parse_spec(spec)
        for name, action, arg, count in clauses:
            self.arm(name, action, arg, count)
        return len(clauses)

    def load_env(self) -> None:
        """Arm from CBT_FAILPOINTS once (first fail_point evaluation)."""
        with self._lock:
            if self._env_loaded:
                return
            self._env_loaded = True
        spec = os.environ.get(ENV_VAR, "")
        if spec:
            self.arm_from_spec(spec)

    # -- the call-site hook ------------------------------------------------

    def fail_point(self, name: str) -> None:
        """Evaluate a failpoint. No-op unless armed."""
        if not self._env_loaded:
            self.load_env()
        if not self._armed:
            return
        with self._lock:
            p = self._points.get(name)
            if p is None or not p.action:
                return
            p.hits += 1
            action, arg = p.action, p.arg
            if action == "flake" and p.hits % max(int(arg), 1) != 0:
                return
            if p.remaining == 0:
                return
            if p.remaining > 0:
                p.remaining -= 1
                if p.remaining == 0:
                    p.action = ""  # self-disarm after the last fire
                    self._armed -= 1
            p.fires += 1
            crash = self._crash
        _log.warning("failpoint FIRED: %s (%s)", name, action)
        try:
            (self._fire_hook or _default_fire_hook)(name, action)
        except Exception:  # noqa: BLE001 - observer must not alter faults
            pass
        if action == "crash":
            crash(name)
        elif action == "raise" or action == "flake":
            raise FailpointError(f"failpoint {name} fired")
        elif action == "delay":
            time.sleep(arg)

    def stats(self, name: str) -> Optional[dict]:
        with self._lock:
            p = self._points.get(name)
            if p is None:
                return None
            return {"name": p.name, "action": p.action, "arg": p.arg,
                    "remaining": p.remaining, "hits": p.hits,
                    "fires": p.fires}

    def counters(self) -> Dict[str, dict]:
        """Per-point trigger counts for EVERY registered point — the
        ops surface /metrics samples this at scrape time (the counts
        were always tracked; they were just unreachable)."""
        with self._lock:
            return {p.name: {"hits": p.hits, "fires": p.fires,
                             "armed": bool(p.action)}
                    for p in self._points.values()}

    def set_fire_hook(
        self, fn: Optional[Callable[[str, str], None]]
    ) -> None:
        """Install a fired-point observer (None restores the default
        trace-instant hook)."""
        self._fire_hook = fn


def parse_spec(spec: str):
    """Parse ``name=action[:arg][*count][;...]`` into (name, action,
    arg, count) tuples. Raises ValueError on malformed clauses or
    unknown actions — config load uses this to validate without
    arming."""
    out = []
    for clause in (spec or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise ValueError(
                f"bad failpoint clause {clause!r}: want name=action"
            )
        name, rhs = clause.split("=", 1)
        count = -1
        if "*" in rhs:
            rhs, cnt = rhs.rsplit("*", 1)
            count = int(cnt)
        arg = 0.0
        if ":" in rhs:
            rhs, a = rhs.split(":", 1)
            arg = float(a)
        action = rhs.strip()
        if action not in ACTIONS:
            raise ValueError(
                f"unknown failpoint action {action!r}; want one of "
                f"{ACTIONS}"
            )
        out.append((name.strip(), action, arg, count))
    return out


# The process-global registry: call sites use the module-level helpers.
_REGISTRY = FailpointRegistry()


def registry() -> FailpointRegistry:
    return _REGISTRY


def swap_registry(reg: FailpointRegistry) -> FailpointRegistry:
    """Install `reg` as the process-global registry and return the old
    one. The Byzantine simnet uses this to give every simulated node its
    OWN failpoint registry: the (single-threaded) scheduler swaps a
    node's registry in around that node's event execution, so a
    ``Failpoint(node=2, ...)`` schedule op faults only node 2's seams.
    Callers must restore the previous registry (try/finally).

    Trace/metric hooks survive swaps: registries are swapped as whole
    objects with their own hooks intact, so the restore direction can
    never contaminate the original registry with a per-node hook —
    custom hooks reach per-node registries at :func:`fresh_registry`
    creation instead."""
    global _REGISTRY
    old = _REGISTRY
    _REGISTRY = reg
    return old


def fresh_registry(crash_handler=None) -> FailpointRegistry:
    """A standalone registry that never arms from the environment —
    per-node simnet registries, isolated from CBT_FAILPOINTS. The
    current global registry's CUSTOM fire hook (if any) is inherited
    at creation, so trace/metric observation keeps working through
    registry swaps; the default trace-instant hook needs no
    inheritance (a None hook already falls back to it)."""
    reg = FailpointRegistry()
    reg._env_loaded = True
    reg._fire_hook = _REGISTRY._fire_hook
    if crash_handler is not None:
        reg.set_crash_handler(crash_handler)
    return reg


def register(name: str, doc: str = "") -> None:
    _REGISTRY.register(name, doc)


def fail_point(name: str) -> None:
    _REGISTRY.fail_point(name)


def arm(name: str, action: str, arg: float = 0.0, count: int = -1) -> None:
    _REGISTRY.arm(name, action, arg, count)


def disarm(name: str) -> None:
    _REGISTRY.disarm(name)


def reset() -> None:
    _REGISTRY.reset()


def arm_from_spec(spec: str) -> int:
    return _REGISTRY.arm_from_spec(spec)


def set_crash_handler(fn: Optional[Callable[[str], None]]) -> None:
    _REGISTRY.set_crash_handler(fn)


def counters() -> Dict[str, dict]:
    return _REGISTRY.counters()
