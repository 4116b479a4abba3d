"""Closed-loop self-tuning control plane: the ledgers become sensors,
the knobs become actuators.

Every performance knob the overload machinery grew over the last
rounds (`bulk_window_ms`, `gateway_window_ms`, `bulk_deadline_ms`,
admission watermarks, `pipeline_flights`) is hand-set in TOML — so a
diurnal 10x load swing either sheds needlessly at the trough or melts
at the peak. This module closes the loop: an operator declares an SLO
(`[controller] slo_commit_p99_ms` plus per-lane wait targets) and the
controller adjusts ONLY the sheddable actuators from live ledger
signals:

  * under CONSENSUS pressure (height-ledger commit p99 over the SLO,
    or mempool fill climbing toward the admission watermark — BEFORE a
    shed_storm fires, not after) it widens the BULK/GATEWAY coalescing
    windows (more amortization per flush, the device spends more of
    its time on consensus) and tightens the admission watermarks /
    bulk shed deadline (load-shed earlier at the front door);
  * when commit p99 has headroom again it relaxes every moved actuator
    back toward its configured base — never past it;
  * it grows `pipeline_flights` toward its config ceiling when the
    flush ledger shows low `util` on an `h2d_ms`-bound deck, and
    shrinks the deck when the incident recorder fires a
    `compile_storm` (each extra flight is another shape to keep
    compiled);
  * CONSENSUS lane bounds are STRUCTURALLY off-limits: the controller
    holds no CONSENSUS actuator, and the plane's setter rejects the
    lane outright — no decision path can create CONSENSUS sheds.

Flap control is the admission-hysteresis template: a pressure
latch (enter high, exit low — never oscillate at one boundary) plus a
per-actuator cooldown measured in evaluations, and every actuator is
clamped to config-validated [min, max] bounds so a runaway loop
degrades to the static config, never past it.

Determinism: the controller is count-based and poked from the same
deterministic seams as the incident recorder — consensus step
transitions (`controller.poke`, next to `incidents.poke` in
consensus/state.py) and verify-plane dispatcher drain cycles
(`controller.poke_drain`). Every stamp rides
``tracing.monotonic_ns()`` (virtual under simnet), and every sensor it
reads is itself deterministic under simnet, so the same
(seed, schedule) replays the entire decision stream byte-identically.
Drain pokes only ever evaluate the flight-deck actuator (whose grow
signal requires fused device flushes — inert on host-path planes), so
the nondeterministic real-thread drain cadence can never perturb a
simnet decision stream.

Every decision — trigger signal values, actuator, old -> new value,
cooldown state — lands in a bounded decision ledger served at
GET+JSON-RPC ``/dump_controller`` (``_LAST`` survives stop, like the
flush ledger), feeds the ``controller_*`` /metrics families, and a
move inside an incident's window rides the incident snapshot
(``controller_tail`` in libs/incidents).

The port's copy of the JAX package's libs/controller.py; its
process-global registry is separate from the JAX package's.
"""
from __future__ import annotations

import sys
import threading
from collections import deque
from typing import Dict, List, Optional

from cometbft_tpu_torch.libs import tracing

DECISION_CAPACITY = 256

# actuator direction labels (metrics + decision records)
DIR_UP = "up"
DIR_DOWN = "down"

# the sheddable actuator set — CONSENSUS has no entry by construction
ACT_BULK_WINDOW = "bulk_window_ms"
ACT_GATEWAY_WINDOW = "gateway_window_ms"
ACT_BULK_DEADLINE = "bulk_deadline_ms"
ACT_ADMISSION = "admission_high_watermark"
ACT_FLIGHTS = "pipeline_flights"
ACTUATORS = (ACT_BULK_WINDOW, ACT_GATEWAY_WINDOW, ACT_BULK_DEADLINE,
             ACT_ADMISSION, ACT_FLIGHTS)


class _Actuator:
    """One knob the controller may move: its live apply function, the
    configured base it relaxes back to, and the clamp bounds a runaway
    loop can never escape."""

    __slots__ = ("name", "value", "base", "lo", "hi", "apply",
                 "moves", "last_move")

    def __init__(self, name: str, value: float, lo: float, hi: float,
                 apply_fn):
        self.name = name
        self.value = float(value)
        self.base = float(value)
        self.lo = float(lo)
        self.hi = float(hi)
        self.apply = apply_fn
        self.moves = 0
        self.last_move = -(1 << 30)  # eligible immediately

    def clamp(self, v: float) -> float:
        return min(self.hi, max(self.lo, v))


class Controller:
    """The closed loop. Holds attached handles (plane, admission,
    height ledger); every poke is cheap (counter bump) until the
    decision interval elapses, and evaluation itself is a handful of
    dict reads — no thread of its own, ever."""

    def __init__(self,
                 slo_commit_p99_ms: float = 500.0,
                 slo_gateway_wait_ms: float = 250.0,
                 slo_bulk_wait_ms: float = 1000.0,
                 decision_interval: int = 8,
                 cooldown: int = 4,
                 pressure_low: float = 0.5,
                 fill_high: float = 0.6,
                 fill_low: float = 0.3,
                 window_step: float = 1.5,
                 watermark_step: float = 0.08,
                 deadline_step: float = 0.75,
                 util_low: float = 0.5,
                 deck_min_flushes: int = 8,
                 capacity: int = DECISION_CAPACITY):
        self.slo_commit_p99_ms = float(slo_commit_p99_ms)
        # the per-lane wait targets double as widen ceilings: the
        # controller may never widen a lane's coalescing window past
        # half its wait SLO (a window IS added latency on that lane)
        self.slo_gateway_wait_ms = float(slo_gateway_wait_ms)
        self.slo_bulk_wait_ms = float(slo_bulk_wait_ms)
        self.decision_interval = max(1, int(decision_interval))
        self.cooldown = max(0, int(cooldown))
        self.pressure_low = float(pressure_low)
        self.fill_high = float(fill_high)
        self.fill_low = float(fill_low)
        self.window_step = max(1.01, float(window_step))
        self.watermark_step = max(0.001, float(watermark_step))
        self.deadline_step = min(0.99, max(0.01, float(deadline_step)))
        self.util_low = float(util_low)
        self.deck_min_flushes = max(1, int(deck_min_flushes))
        self._ring: deque = deque(maxlen=max(8, int(capacity)))
        self._lock = threading.Lock()
        self._seq = 0
        self._actuators: Dict[str, _Actuator] = {}
        # pressure latch (the admission hysteresis template: enter high,
        # exit low — never flap at one boundary)
        self._pressed = False
        # poke counters (count-based cadence, no clocks)
        self._pokes = 0
        self._drain_pokes = 0
        self._evals = 0
        # the deck actuator's own cooldown clock: deck evaluations
        # arrive from BOTH seams, so its cooldown must tick on both
        self._deck_ticks = 0
        # SLO-violation accrual (sampled at evaluation cadence on the
        # ledger clock, so it replays under simnet)
        self._violation_ns = 0
        self._last_eval_ns = 0
        self._gen = tracing.clock_gen()
        # deltas: sheds seen at the previous evaluation, compile
        # storms seen at the previous deck evaluation, fused flushes
        # at the last deck move (grow needs fresh evidence)
        self._last_sheds = 0
        self._last_storms = 0
        self._deck_fused_mark = 0
        # attached sensor/actuator handles (None = module-global
        # fallback at read time)
        self._plane = None
        self._admission = None
        self._height_ledger = None
        # per-(actuator, direction) decision counts (metrics source)
        self.decision_counts: Dict[tuple, int] = {}

    # -- wiring ------------------------------------------------------------

    def attach(self, plane=None, admission=None, height_ledger=None,
               bounds: Optional[dict] = None,
               flights_max: Optional[int] = None) -> None:
        """Bind live handles and build the actuator table from their
        CURRENT values (= the configured base the loop relaxes back
        to). `bounds` maps actuator name -> (min, max); missing bounds
        default to [base, base] (that actuator never moves).
        CONSENSUS lane knobs are structurally absent from the table."""
        bounds = bounds or {}
        with self._lock:
            self._plane = plane
            self._admission = admission
            self._height_ledger = height_ledger
            self._actuators = {}
            if plane is not None:
                base_bw = plane.bulk_window * 1000.0
                lo, hi = bounds.get(ACT_BULK_WINDOW,
                                    (base_bw, base_bw))
                self._actuators[ACT_BULK_WINDOW] = _Actuator(
                    ACT_BULK_WINDOW, base_bw, lo,
                    min(hi, self.slo_bulk_wait_ms / 2.0),
                    lambda v, p=plane: p.set_lane_window_ms("bulk", v))
                base_gw = plane.gateway_window * 1000.0
                lo, hi = bounds.get(ACT_GATEWAY_WINDOW,
                                    (base_gw, base_gw))
                self._actuators[ACT_GATEWAY_WINDOW] = _Actuator(
                    ACT_GATEWAY_WINDOW, base_gw, lo,
                    min(hi, self.slo_gateway_wait_ms / 2.0),
                    lambda v, p=plane: p.set_lane_window_ms(
                        "gateway", v))
                base_bd = plane.bulk_deadline * 1000.0
                if base_bd > 0:  # 0 = deadline shedding disabled
                    lo, hi = bounds.get(ACT_BULK_DEADLINE,
                                        (base_bd, base_bd))
                    self._actuators[ACT_BULK_DEADLINE] = _Actuator(
                        ACT_BULK_DEADLINE, base_bd, lo, hi,
                        lambda v, p=plane: p.set_lane_deadline_ms(
                            "bulk", v))
                fmax = plane.flights_max if flights_max is None \
                    else int(flights_max)
                self._actuators[ACT_FLIGHTS] = _Actuator(
                    ACT_FLIGHTS, plane.flights, 1,
                    max(1, fmax),
                    lambda v, p=plane: p.set_flights(int(v)))
            if admission is not None:
                base_hw = admission.high_watermark
                spread = base_hw - admission.low_watermark
                lo, hi = bounds.get(ACT_ADMISSION, (base_hw, base_hw))
                self._actuators[ACT_ADMISSION] = _Actuator(
                    ACT_ADMISSION, base_hw, lo, hi,
                    lambda v, a=admission, s=spread:
                        a.set_watermarks(v, v - s))

    # -- the deterministic seams -------------------------------------------

    def poke(self, height: int = 0, round_: int = 0) -> None:
        """Consensus step transition (the incidents.poke seam). Counter
        bump until the decision interval elapses, then one evaluation
        of every pressure actuator + the deck."""
        with self._lock:
            self._pokes += 1
            if self._pokes % self.decision_interval:
                return
            now = tracing.monotonic_ns()
            gen = tracing.clock_gen()
            if gen != self._gen:
                # clock domain changed (simnet install/restore): any
                # accrual against the old domain is garbage — re-arm
                self._gen = gen
                self._last_eval_ns = now
                return
            self._evals += 1
            self._evaluate_pressure(now, height)
            self._evaluate_deck(now, height, src="step")

    def poke_drain(self) -> None:
        """Verify-plane dispatcher drain cycle. Only the flight-deck
        actuator is evaluated here: its grow signal needs fused device
        flushes, so on host-path planes (simnet) drain pokes decide
        nothing — the real-thread drain cadence can never perturb a
        deterministic decision stream."""
        with self._lock:
            self._drain_pokes += 1
            if self._drain_pokes % self.decision_interval:
                return
            now = tracing.monotonic_ns()
            if tracing.clock_gen() != self._gen:
                return
            self._evaluate_deck(now, 0, src="drain", deck_only=True)

    # -- sensors (all deterministic under simnet) --------------------------

    def _read_plane(self):
        if self._plane is not None:
            return self._plane
        vp = sys.modules.get("cometbft_tpu_torch.verifyplane.plane")
        return vp and (vp._GLOBAL or vp._LAST)

    def _commit_p99_ms(self) -> Optional[float]:
        led = self._height_ledger
        if led is None:
            hl = sys.modules.get("cometbft_tpu_torch.consensus.heightledger")
            led = hl and hl.global_ledger()
        if led is None or not len(led):
            return None
        try:
            return led.summary()["commit_latency_ms"]["p99"]
        except Exception:  # noqa: BLE001 - a sick sensor never decides
            return None

    def _fill(self) -> float:
        adm = self._admission
        if adm is None:
            return 0.0
        try:
            return float(adm._fill_fn())
        except Exception:  # noqa: BLE001
            return 0.0

    def _shed_total(self, plane) -> int:
        if plane is None:
            return 0
        try:
            return sum(n for lane, n in plane.sheds.items()
                       if lane != "consensus")
        except Exception:  # noqa: BLE001
            return 0

    # -- evaluation --------------------------------------------------------

    def _evaluate_pressure(self, now: int, height: int) -> None:
        plane = self._read_plane()
        p99 = self._commit_p99_ms()
        ratio = (p99 / self.slo_commit_p99_ms) if p99 else 0.0
        fill = self._fill()
        sheds = self._shed_total(plane)
        shed_delta = sheds - self._last_sheds
        self._last_sheds = sheds
        # SLO-violation accrual: evaluation-to-evaluation spans spent
        # over the commit-p99 SLO, on the ledger clock
        if p99 is not None and p99 > self.slo_commit_p99_ms \
                and self._last_eval_ns:
            self._violation_ns += max(0, now - self._last_eval_ns)
        self._last_eval_ns = now
        # the hysteresis latch: enter on violated SLO OR fill climbing
        # toward the watermark (the pre-shed_storm trigger), exit only
        # when BOTH have headroom
        if self._pressed:
            if ratio <= self.pressure_low and fill <= self.fill_low:
                self._pressed = False
        elif ratio >= 1.0 or fill >= self.fill_high:
            self._pressed = True
        trigger = {"p99_ms": p99, "slo_ms": self.slo_commit_p99_ms,
                   "fill": round(fill, 4), "shed_delta": shed_delta,
                   "pressed": self._pressed}
        if self._pressed:
            self._move(ACT_ADMISSION, DIR_DOWN, trigger, now, height)
            self._move(ACT_BULK_WINDOW, DIR_UP, trigger, now, height)
            self._move(ACT_GATEWAY_WINDOW, DIR_UP, trigger, now,
                       height)
            self._move(ACT_BULK_DEADLINE, DIR_DOWN, trigger, now,
                       height)
        elif shed_delta == 0:
            # headroom AND the last window shed nothing: walk every
            # displaced actuator one step back toward its base
            self._move(ACT_ADMISSION, DIR_UP, trigger, now, height,
                       relax=True)
            self._move(ACT_BULK_WINDOW, DIR_DOWN, trigger, now,
                       height, relax=True)
            self._move(ACT_GATEWAY_WINDOW, DIR_DOWN, trigger, now,
                       height, relax=True)
            self._move(ACT_BULK_DEADLINE, DIR_UP, trigger, now,
                       height, relax=True)

    def _evaluate_deck(self, now: int, height: int, src: str = "step",
                       deck_only: bool = False) -> None:
        self._deck_ticks += 1
        act = self._actuators.get(ACT_FLIGHTS)
        plane = self._read_plane()
        if act is None or plane is None:
            return
        # shrink on a compile_storm: each extra flight is another
        # shape to keep compiled, and the storm says shapes are NOT
        # staying compiled
        inc = sys.modules.get("cometbft_tpu_torch.libs.incidents")
        storms = 0
        if inc is not None:
            try:
                storms = int(inc.recorder().fired.get(
                    "compile_storm", 0))
            except Exception:  # noqa: BLE001
                storms = 0
        if storms > self._last_storms:
            self._last_storms = storms
            trigger = {"compile_storms": storms, "src": src}
            self._move(ACT_FLIGHTS, DIR_DOWN, trigger, now, height)
            return
        # grow toward the config ceiling when the fused deck is
        # underutilized AND h2d-bound (staging the next flush while
        # one flies is exactly what another flight buys)
        try:
            dev = plane.ledger.summary().get("device") or {}
        except Exception:  # noqa: BLE001
            return
        fused = int(dev.get("fused_flushes", 0))
        if fused - self._deck_fused_mark < self.deck_min_flushes:
            return  # not enough fresh fused evidence since last move
        util = (dev.get("util") or {}).get("p50", 0.0)
        h2d = (dev.get("h2d_ms") or {}).get("p50", 0.0)
        dms = (dev.get("dev_ms") or {}).get("p50", 0.0)
        if util < self.util_low and h2d >= dms and h2d > 0:
            trigger = {"util_p50": util, "h2d_p50_ms": h2d,
                       "dev_p50_ms": dms, "fused_flushes": fused,
                       "src": src}
            if self._move(ACT_FLIGHTS, DIR_UP, trigger, now, height):
                self._deck_fused_mark = fused

    def _move(self, name: str, direction: str, trigger: dict,
              now: int, height: int, relax: bool = False) -> bool:
        """One clamped, cooldown-gated step of one actuator. Returns
        True when a decision actually landed. Caller holds _lock."""
        act = self._actuators.get(name)
        if act is None:
            return False
        clock = self._deck_ticks if name == ACT_FLIGHTS \
            else self._evals
        if clock - act.last_move <= self.cooldown:
            return False
        cur = act.value
        if name in (ACT_BULK_WINDOW, ACT_GATEWAY_WINDOW):
            new = cur * self.window_step if direction == DIR_UP \
                else cur / self.window_step
        elif name == ACT_BULK_DEADLINE:
            new = cur * self.deadline_step if direction == DIR_DOWN \
                else cur / self.deadline_step
        elif name == ACT_ADMISSION:
            new = cur - self.watermark_step if direction == DIR_DOWN \
                else cur + self.watermark_step
        else:  # ACT_FLIGHTS
            new = cur - 1 if direction == DIR_DOWN else cur + 1
        if relax:
            # relaxing may only return TOWARD base, never past it
            if direction == DIR_UP and new > act.base:
                new = act.base
            if direction == DIR_DOWN and new < act.base:
                new = act.base
        new = round(act.clamp(new), 4)
        if new == round(cur, 4):
            return False
        try:
            act.apply(new)
        except Exception:  # noqa: BLE001 - a refused apply is a
            return False  # non-decision, never a crash
        act.value = new
        act.moves += 1
        act.last_move = clock
        seq = self._seq
        self._seq += 1
        key = (name, direction)
        self.decision_counts[key] = self.decision_counts.get(key, 0) + 1
        self._ring.append({
            "seq": seq,
            "at_ms": round(now / 1e6, 3),
            "height": height,
            "actuator": name,
            "direction": direction,
            "old": round(cur, 4),
            "new": new,
            "relax": bool(relax),
            "trigger": dict(trigger),
            "cooldowns": {a.name: max(
                0, self.cooldown - ((self._deck_ticks
                                     if a.name == ACT_FLIGHTS
                                     else self._evals)
                                    - a.last_move) + 1)
                for a in self._actuators.values()},
        })
        tracing.instant("controller_move", cat="controller",
                        actuator=name, direction=direction)
        return True

    # -- readers -----------------------------------------------------------

    @property
    def slo_violation_s(self) -> float:
        with self._lock:
            return round(self._violation_ns / 1e9, 3)

    def actuator_values(self) -> Dict[str, float]:
        with self._lock:
            return {a.name: a.value for a in self._actuators.values()}

    def decisions(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def tail(self, n: int = 8) -> List[str]:
        """Compact decision lines — ride simnet replay blobs and
        incident snapshots."""
        with self._lock:
            decs = list(self._ring)[-n:]
        return [f"#{d['seq']} {d['actuator']} {d['direction']} "
                f"{d['old']}->{d['new']} h={d['height']} "
                f"at={d['at_ms']}ms" for d in decs]

    def mark(self) -> tuple:
        with self._lock:
            return (id(self), self._seq)

    def advanced(self, mark: tuple) -> bool:
        return self.mark() != mark

    def dump(self) -> dict:
        """The /dump_controller document."""
        with self._lock:
            return {
                "decisions": list(self._ring),
                "actuators": {
                    a.name: {"value": a.value, "base": a.base,
                             "min": a.lo, "max": a.hi,
                             "moves": a.moves}
                    for a in self._actuators.values()},
                "slo": {
                    "commit_p99_ms": self.slo_commit_p99_ms,
                    "gateway_wait_ms": self.slo_gateway_wait_ms,
                    "bulk_wait_ms": self.slo_bulk_wait_ms},
                "state": {
                    "pressed": self._pressed,
                    "pokes": self._pokes,
                    "drain_pokes": self._drain_pokes,
                    "evals": self._evals,
                    "decisions_total": self._seq,
                    "slo_violation_s": round(
                        self._violation_ns / 1e9, 3),
                    "decision_interval": self.decision_interval,
                    "cooldown": self.cooldown},
            }


# --------------------------------------------------------------------------
# the process-global controller (node lifecycle / simnet scenario owns
# it) — the plane's _GLOBAL/_LAST pattern: dumps survive stop()
# --------------------------------------------------------------------------

_GLOBAL: Optional[Controller] = None
_LAST: Optional[Controller] = None
_GLOBAL_LOCK = threading.Lock()


def set_global_controller(ctrl: Optional[Controller]) -> None:
    global _GLOBAL, _LAST
    with _GLOBAL_LOCK:
        _GLOBAL = ctrl
        if ctrl is not None:
            _LAST = ctrl


def clear_global_controller(ctrl: Controller) -> None:
    """Unregister `ctrl` if (and only if) it is the current global — a
    stopping node must not tear down another node's controller."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is ctrl:
            _GLOBAL = None


def global_controller() -> Optional[Controller]:
    return _GLOBAL


# convenience module-level seam hooks (one global load + a no-op when
# no controller is mounted — the always-off cost)

def poke(height: int = 0, round_: int = 0) -> None:
    c = _GLOBAL
    if c is not None:
        c.poke(height, round_)


def poke_drain() -> None:
    c = _GLOBAL
    if c is not None:
        c.poke_drain()


def dump_controller() -> dict:
    """The decision ledger of the current global controller — or,
    after a stop, of the LAST one (post-mortems read history)."""
    c = _GLOBAL or _LAST
    if c is None:
        return {"decisions": [], "actuators": {}, "slo": {},
                "state": {"pokes": 0, "evals": 0,
                          "decisions_total": 0}}
    return c.dump()


def controller_tail(n: int = 8) -> List[str]:
    c = _GLOBAL or _LAST
    return [] if c is None else c.tail(n)


def controller_mark() -> tuple:
    c = _GLOBAL or _LAST
    if c is None:
        return (None, -1)
    return c.mark()


def controller_advanced(mark: tuple) -> bool:
    return controller_mark() != mark
