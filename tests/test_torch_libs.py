"""The port's copies of the host libs the verify plane runs on (tracing,
failpoints, controller, incidents, deviceledger, bits, quantiles, staging,
the table cache's snapshot) against the JAX package's: each scenario below
is one of the JAX package's test scenarios (tests/test_tracing.py,
test_failpoints.py, test_controller.py, test_zdevice_smoke.py), run on both
packages' modules with the same inputs; both runs must pass the scenario's
own checks and return the same outputs. Clocks are installed tickers, so
timestamps compare exactly. The seams that differ (the torch.profiler
bracket, the kernel build feeding the compile ledger) have port-only
tests at the end."""
import importlib
import itertools
import random
import threading
import time
from types import SimpleNamespace

import pytest

MODULES = {"tracing": "libs.tracing", "fp": "libs.failpoints",
           "cp": "libs.controller", "inc": "libs.incidents",
           "dl": "libs.deviceledger", "bits": "libs.bits",
           "q": "libs.quantiles", "staging": "libs.staging",
           "tc": "ops.table_cache", "vp": "verifyplane.plane",
           "tenants": "verifyplane.tenants", "keys": "crypto.keys"}


def _pkg(base: str) -> SimpleNamespace:
    return SimpleNamespace(base=base, **{
        k: importlib.import_module(f"{base}.{m}") for k, m in MODULES.items()})


JAX = _pkg("cometbft_tpu")
PORT = _pkg("cometbft_tpu_torch")


def _reset(P):
    P.tracing.disable()
    P.tracing.set_clock(None)
    P.tracing.set_profile_dir("")
    P.fp.reset()
    P.fp.set_crash_handler(None)


@pytest.fixture(autouse=True)
def _clean():
    for P in (JAX, PORT):
        _reset(P)
    yield
    for P in (JAX, PORT):
        _reset(P)


def ticker(step: int = 1000):
    """A ns clock that advances `step` per reading."""
    it = itertools.count(0, step)
    return lambda: next(it)


def raised(fn) -> str:
    """The name of the exception fn() raises, or "" when it returns."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the name is the output
        return type(e).__name__
    return ""


def signed_rows(P, n=4, seed=0x61):
    """n (PubKey, msg, sig) rows of package P's key type, signed with the
    JAX package's keys (the same bytes on both packages)."""
    rows = []
    for i in range(n):
        priv = JAX.keys.PrivKey.generate(bytes([seed + i]) * 32)
        msg = b"libs-%d" % i
        rows.append((P.keys.PubKey(priv.pub_key().data), msg,
                     priv.sign(msg)))
    return rows


# ---------------------------------------------------------------------------
# tracing (tests/test_tracing.py)
# ---------------------------------------------------------------------------


def tracing_disabled_is_noop(P, tmp):
    t = P.tracing
    assert not t.enabled()
    with t.span("never", cat="x", k=1) as s:
        assert s is None
    t.instant("never")
    t.flight_begin("never", 1)
    t.flight_end("never", 1)
    return t.export_chrome(), t.tail()


def tracing_span_instant_flight_export(P, tmp):
    t = P.tracing
    t.enable(capacity=128, clock=ticker(), deterministic=True)
    with t.span("outer", cat="t", height=3):
        t.instant("mark", cat="t", n=1)
        with t.span("inner", cat="t"):
            pass
    t.flight_begin("fly", 7, cat="t", rows=4)
    t.flight_end("fly", 7, cat="t")
    evs = t.export_chrome()["traceEvents"]
    by = {e["name"]: e for e in evs}
    assert by["outer"]["ph"] == "X" and by["outer"]["args"] == {"height": 3}
    assert by["outer"]["dur"] >= by["inner"]["dur"] >= 0
    b = [e for e in evs if e["ph"] == "b"][0]
    e = [e for e in evs if e["ph"] == "e"][0]
    assert b["id"] == e["id"] == "7"
    names = [ev["name"] for ev in evs]
    assert names.index("inner") < names.index("outer")
    return t.export_chrome()


def tracing_ring_buffer_bounds_and_drop_count(P, tmp):
    tr = P.tracing.enable(capacity=16, clock=ticker(), deterministic=True)
    for i in range(40):
        P.tracing.instant(f"e{i}")
    evs = tr.events()
    assert len(evs) == 16 and tr.dropped == 24
    return [e["name"] for e in evs], tr.dropped


def tracing_deterministic_mode_and_custom_clock(P, tmp):
    ticks = iter(range(0, 10_000, 1000))
    P.tracing.enable(capacity=32, clock=lambda: next(ticks),
                     deterministic=True)
    with P.tracing.span("a"):
        P.tracing.instant("b")
    evs = P.tracing.export_chrome()["traceEvents"]
    assert [e["ts"] for e in evs] == [1.0, 0.0] and evs[1]["dur"] == 2.0
    return evs


def tracing_write_and_tail(P, tmp):
    import json

    P.tracing.enable(capacity=32, clock=ticker(), deterministic=True)
    P.tracing.instant("alpha")
    with P.tracing.span("beta"):
        pass
    tmp.mkdir(parents=True, exist_ok=True)
    path = str(tmp / "trace.json")
    P.tracing.write(path)
    with open(path) as f:
        doc = json.load(f)
    return doc, P.tracing.tail(1)


def tracing_profiler_bracket_noop_without_dir(P, tmp):
    P.tracing.set_profile_dir("")
    started = P.tracing.profiler_start()
    P.tracing.profiler_stop()  # must not raise
    P.tracing.set_profile_dir(str(tmp))
    # configured but tracing off: still no capture
    return started, P.tracing.profiler_start(), P.tracing.profile_dir() != ""


def tracing_plane_flush_lifecycle_spans(P, tmp):
    P.tracing.enable(capacity=256)
    plane = P.vp.VerifyPlane(window_ms=0.5, use_device=False)
    plane.start()
    try:
        (pub, msg, sig), = signed_rows(P, 1)
        got = plane.submit(pub, msg, sig).result(10.0)
    finally:
        plane.stop()
    by = {}
    for e in P.tracing.export_chrome()["traceEvents"]:
        by.setdefault(e["name"], []).append(e)
    packs, settles = by["plane.pack"], by["plane.settle"]
    assert packs[0]["args"]["flush"] == settles[0]["args"]["flush"]
    assert packs[0]["args"]["queued_ms"] >= 0
    return (got, sorted(by), packs[0]["args"]["rows"],
            packs[0]["args"]["subs"])


def tracing_queued_ms_ignores_cross_clock_stamps(P, tmp):
    rows = signed_rows(P, 1, seed=0x62)
    p = P.vp.VerifyPlane(window_ms=0.5, use_device=False)
    sub = P.vp._Submission(rows, None, 0, False)
    P.tracing.set_clock(lambda: 1_700_000_000_000_000_000)
    try:
        flight = p._stage([sub])
        verdicts, _ = flight.finish()
        led = flight.led
    finally:
        P.tracing.set_clock(None)
    return list(verdicts), led[P.vp._L_QUEUED], led[P.vp._L_PATH]


# ---------------------------------------------------------------------------
# failpoints (tests/test_failpoints.py)
# ---------------------------------------------------------------------------


def fp_unarmed_is_noop(P, tmp):
    P.fp.register("t.point", "doc")
    P.fp.fail_point("t.point")
    return P.fp.registry().names()["t.point"]


def fp_raise_action_and_counts(P, tmp):
    P.fp.register("t.raise")
    P.fp.arm("t.raise", "raise", count=2)
    out = [raised(lambda: P.fp.fail_point("t.raise")) for _ in range(3)]
    return out, P.fp.registry().stats("t.raise")


def fp_delay_action(P, tmp):
    P.fp.arm("t.delay", "delay", arg=0.02)
    t0 = time.monotonic()
    P.fp.fail_point("t.delay")
    return time.monotonic() - t0 >= 0.02


def fp_flake_is_deterministic(P, tmp):
    P.fp.arm("t.flake", "flake", arg=3)
    fired = [raised(lambda: P.fp.fail_point("t.flake")) for _ in range(9)]
    assert fired == ["", "", "FailpointError"] * 3
    return fired


def fp_crash_handler_override(P, tmp):
    crashes = []
    P.fp.set_crash_handler(crashes.append)
    P.fp.arm("t.crash", "crash", count=1)
    P.fp.fail_point("t.crash")
    P.fp.fail_point("t.crash")
    return crashes


def fp_simulated_crash_handler(P, tmp):
    P.fp.set_crash_handler(P.fp.simulated_crash)
    P.fp.arm("t.simcrash", "crash")
    return raised(lambda: P.fp.fail_point("t.simcrash"))


def fp_spec_parse_and_arm(P, tmp):
    spec = "a.b=crash*1; c.d=delay:0.5 ;e.f=flake:4*2"
    return (P.fp.parse_spec(spec), P.fp.arm_from_spec(spec),
            P.fp.registry().stats("c.d"))


def fp_spec_rejects_garbage(P, tmp):
    return [raised(lambda: P.fp.parse_spec("no-equals-sign")),
            raised(lambda: P.fp.parse_spec("a.b=explode")),
            raised(lambda: P.fp.arm("x", "explode"))]


def fp_disarm_and_reset(P, tmp):
    P.fp.arm("t.x", "raise")
    P.fp.disarm("t.x")
    out = [raised(lambda: P.fp.fail_point("t.x"))]
    P.fp.arm("t.x", "raise")
    P.fp.arm("t.y", "raise")
    P.fp.reset()
    out += [raised(lambda: P.fp.fail_point(n)) for n in ("t.x", "t.y")]
    return out


def fp_counters_surface_every_point(P, tmp):
    P.fp.register("t.counted", "doc")
    P.fp.arm("t.counted", "raise", count=1)
    out = [raised(lambda: P.fp.fail_point("t.counted")),
           raised(lambda: P.fp.fail_point("t.counted"))]
    return out, P.fp.counters()["t.counted"]


def fp_fired_points_emit_trace_instants(P, tmp):
    P.tracing.enable(capacity=32, clock=ticker(), deterministic=True)
    P.fp.arm("t.traced", "raise", count=1)
    out = raised(lambda: P.fp.fail_point("t.traced"))
    evs = P.tracing.export_chrome()["traceEvents"]
    return out, [e for e in evs if e["name"] == "failpoint.fire"]


def fp_registry_swap_keeps_fire_hooks_intact(P, tmp):
    seen = []
    P.fp.registry().set_fire_hook(lambda n, a: seen.append((n, a)))
    try:
        node_reg = P.fp.fresh_registry(P.fp.simulated_crash)
        old = P.fp.swap_registry(node_reg)
        try:
            assert node_reg._fire_hook is old._fire_hook
            P.fp.arm("n.point", "raise", count=1)
            first = raised(lambda: P.fp.fail_point("n.point"))
        finally:
            restored = P.fp.swap_registry(old)
        P.fp.arm("t.after", "raise", count=1)
        second = raised(lambda: P.fp.fail_point("t.after"))
    finally:
        P.fp.registry().set_fire_hook(None)
    return first, second, seen, restored is node_reg


def fp_plane_dispatch_failpoint_degrades_to_host(P, tmp):
    """The `verifyplane.dispatch` point: a raised fault degrades the flush
    to the inline host path, with real verdicts."""
    rows = signed_rows(P, 3, seed=0x70)
    rows[1] = (rows[1][0], rows[1][1], b"\x5a" * 64)
    P.fp.arm("verifyplane.dispatch", "raise", count=1)
    plane = P.vp.VerifyPlane(window_ms=1.0, use_device=False)
    plane.start()
    try:
        got = plane.submit_many(rows).result(10.0)
    finally:
        plane.stop()
    return got, [r["path"] for r in plane.ledger.records()]


# ---------------------------------------------------------------------------
# controller (tests/test_controller.py), against fakes
# ---------------------------------------------------------------------------


class FakeLedger:
    def __init__(self):
        self.p99 = 0.0

    def __len__(self):
        return 1

    def summary(self):
        return {"commit_latency_ms": {"p99": self.p99}}


class FakeFlushLedger:
    def __init__(self):
        self.device = {}

    def summary(self):
        return {"device": self.device} if self.device else {}


class FakePlane:
    def __init__(self, bulk_ms=8.0, gw_ms=4.0, deadline_ms=400.0,
                 flights=1, flights_max=4):
        self.bulk_window = bulk_ms / 1000.0
        self.gateway_window = gw_ms / 1000.0
        self.bulk_deadline = deadline_ms / 1000.0
        self.flights = flights
        self.flights_max = flights_max
        self.sheds = {"consensus": 0, "gateway": 0, "bulk": 0}
        self.ledger = FakeFlushLedger()
        self.applied = []

    def set_lane_window_ms(self, lane, ms):
        self.applied.append(("window", lane, ms))
        if lane == "bulk":
            self.bulk_window = ms / 1000.0
        else:
            self.gateway_window = ms / 1000.0
        return ms

    def set_lane_deadline_ms(self, lane, ms):
        self.applied.append(("deadline", lane, ms))
        self.bulk_deadline = ms / 1000.0
        return ms

    def set_flights(self, n):
        self.applied.append(("flights", n))
        self.flights = min(self.flights_max, max(1, int(n)))
        return self.flights


class FakeAdmission:
    def __init__(self, high=0.9, low=0.7):
        self.high_watermark = high
        self.low_watermark = low
        self.fill = 0.0
        self._fill_fn = lambda: self.fill

    def set_watermarks(self, high, low):
        self.high_watermark = min(1.0, max(0.01, float(high)))
        self.low_watermark = min(max(0.0, float(low)), self.high_watermark)
        return (self.high_watermark, self.low_watermark)


def make_controller(P, plane=None, admission=None, ledger=None, **kw):
    P.tracing.set_clock(ticker(1_000_000))
    kw.setdefault("decision_interval", 1)
    kw.setdefault("cooldown", 0)
    c = P.cp.Controller(**kw)
    c.attach(plane=plane, admission=admission, height_ledger=ledger,
             bounds={P.cp.ACT_BULK_WINDOW: (8.0, 24.0),
                     P.cp.ACT_GATEWAY_WINDOW: (4.0, 12.0),
                     P.cp.ACT_BULK_DEADLINE: (50.0, 400.0),
                     P.cp.ACT_ADMISSION: (0.2, 0.9)})
    # storms fired earlier in the process are history, not signal
    c._last_storms = int(P.inc.recorder().fired.get("compile_storm", 0))
    return c


def cp_attach_builds_only_sheddable_actuators(P, tmp):
    c = make_controller(P, FakePlane(), FakeAdmission(), FakeLedger())
    names = sorted(c.actuator_values())
    assert not any("consensus" in n for n in names)
    return names


def cp_consensus_lane_setters_rejected(P, tmp):
    p = P.vp.VerifyPlane(use_device=False)
    try:
        return [raised(lambda: p.set_lane_window_ms("consensus", 10.0)),
                raised(lambda: p.set_lane_deadline_ms("consensus", 10.0)),
                p.set_lane_window_ms("bulk", 12.0)]
    finally:
        p.stop()


def cp_pressure_latch_tightens_then_relaxes_to_base(P, tmp):
    plane, adm, led = FakePlane(), FakeAdmission(), FakeLedger()
    c = make_controller(P, plane, adm, led, slo_commit_p99_ms=100.0)
    base = c.actuator_values()
    led.p99 = 250.0
    c.poke(1, 0)
    pressed = c.actuator_values()
    led.p99 = 80.0
    c.poke(2, 0)
    held = c.dump()["state"]["pressed"]
    led.p99 = 10.0
    for h in range(3, 20):
        c.poke(h, 0)
    assert c.actuator_values() == pytest.approx(base)
    return base, pressed, held, c.dump()["state"], plane.applied


def cp_relax_never_passes_base(P, tmp):
    plane, adm, led = FakePlane(), FakeAdmission(), FakeLedger()
    c = make_controller(P, plane, adm, led, slo_commit_p99_ms=100.0)
    for h in range(40):
        c.poke(h, 0)
    return c.actuator_values(), c.dump()["state"]["decisions_total"]


def cp_fill_pressure_triggers_before_shed_storm(P, tmp):
    plane, adm, led = FakePlane(), FakeAdmission(), FakeLedger()
    c = make_controller(P, plane, adm, led, fill_high=0.6, fill_low=0.3)
    adm.fill = 0.7
    c.poke(1, 0)
    return c.dump()["state"]["pressed"], c.actuator_values()


def cp_cooldown_gates_repeat_moves(P, tmp):
    plane, adm, led = FakePlane(), FakeAdmission(), FakeLedger()
    c = make_controller(P, plane, adm, led, slo_commit_p99_ms=100.0,
                        cooldown=3)
    led.p99 = 500.0
    totals = []
    for h in range(1, 6):
        c.poke(h, 0)
        totals.append(c.dump()["state"]["decisions_total"])
    assert totals[0] > 0 and totals[0] == totals[3] < totals[4]
    return totals


def cp_runaway_loop_clamps_at_bounds(P, tmp):
    plane, adm, led = FakePlane(), FakeAdmission(), FakeLedger()
    c = make_controller(P, plane, adm, led, slo_commit_p99_ms=100.0)
    led.p99 = 10_000.0
    for h in range(60):
        c.poke(h, 0)
    vals = c.actuator_values()
    assert vals[P.cp.ACT_ADMISSION] == pytest.approx(0.2)
    return vals, adm.high_watermark, plane.applied


def cp_window_ceiling_capped_by_wait_slo(P, tmp):
    plane, adm, led = FakePlane(), FakeAdmission(), FakeLedger()
    c = make_controller(P, plane, adm, led, slo_commit_p99_ms=100.0,
                        slo_bulk_wait_ms=20.0, slo_gateway_wait_ms=10.0)
    led.p99 = 10_000.0
    for h in range(60):
        c.poke(h, 0)
    vals = c.actuator_values()
    assert vals[P.cp.ACT_BULK_WINDOW] <= 10.0
    return vals


def cp_decision_interval_gates_evaluation(P, tmp):
    plane, adm, led = FakePlane(), FakeAdmission(), FakeLedger()
    c = make_controller(P, plane, adm, led, decision_interval=4,
                        slo_commit_p99_ms=100.0)
    led.p99 = 500.0
    evals = []
    for h in range(4):
        c.poke(h, 0)
        evals.append(c.dump()["state"]["evals"])
    return evals


def cp_deck_grows_on_low_util_h2d_bound(P, tmp):
    plane = FakePlane(flights=1, flights_max=4)
    c = make_controller(P, plane, FakeAdmission(), FakeLedger(),
                        deck_min_flushes=4)
    plane.ledger.device = {"fused_flushes": 10, "util": {"p50": 0.2},
                           "h2d_ms": {"p50": 3.0}, "dev_ms": {"p50": 1.0}}
    seen = []
    c.poke(1, 0)
    seen.append(plane.flights)
    c.poke(2, 0)
    seen.append(plane.flights)
    for h in range(3, 10):
        plane.ledger.device["fused_flushes"] += 10
        c.poke(h, 0)
        seen.append(plane.flights)
    assert seen[:2] == [2, 2] and max(seen) <= plane.flights_max
    return seen


def cp_deck_shrinks_on_compile_storm(P, tmp):
    plane = FakePlane(flights=3, flights_max=4)
    c = make_controller(P, plane, FakeAdmission(), FakeLedger())
    rec = P.inc.recorder()
    rec.fired["compile_storm"] = c._last_storms + 1
    try:
        c.poke(1, 0)
    finally:
        rec.fired["compile_storm"] = max(
            0, rec.fired.get("compile_storm", 1) - 1)
    return plane.flights


def cp_decision_ring_bounded_and_dump_shape(P, tmp):
    plane, adm, led = FakePlane(), FakeAdmission(), FakeLedger()
    c = make_controller(P, plane, adm, led, slo_commit_p99_ms=100.0,
                        capacity=8)
    for h in range(200):
        led.p99 = 500.0 if h % 2 else 1.0
        c.poke(h, 0)
    d = c.dump()
    assert len(d["decisions"]) <= 8
    assert sum(c.decision_counts.values()) == d["state"]["decisions_total"]
    return d


def cp_refused_apply_is_a_non_decision(P, tmp):
    class RefusingAdmission(FakeAdmission):
        def set_watermarks(self, high, low):
            raise RuntimeError("refused")

    adm, led = RefusingAdmission(), FakeLedger()
    c = make_controller(P, None, adm, led, slo_commit_p99_ms=100.0)
    led.p99 = 500.0
    c.poke(1, 0)
    return c.dump()["state"]["decisions_total"], adm.high_watermark


def cp_module_globals_and_dump_survive_clear(P, tmp):
    cp = P.cp
    plane, adm, led = FakePlane(), FakeAdmission(), FakeLedger()
    c = make_controller(P, plane, adm, led, slo_commit_p99_ms=100.0)
    old_global, old_last = cp._GLOBAL, cp._LAST
    try:
        cp.set_global_controller(c)
        led.p99 = 500.0
        cp.poke(1, 0)
        mark = cp.controller_mark()
        advanced = cp.controller_advanced(mark)
        cp.clear_global_controller(c)
        cleared = cp.global_controller() is None
        dumped = cp.dump_controller()["state"]["pokes"]
        tail = cp.controller_tail(4)
        cp.poke(2, 0)
        return advanced, cleared, dumped, tail, c.dump()["state"]["pokes"]
    finally:
        cp._GLOBAL, cp._LAST = old_global, old_last


def cp_empty_dump_shape(P, tmp):
    cp = P.cp
    old_global, old_last = cp._GLOBAL, cp._LAST
    try:
        cp._GLOBAL = cp._LAST = None
        return (cp.dump_controller(), cp.controller_mark(),
                cp.controller_tail())
    finally:
        cp._GLOBAL, cp._LAST = old_global, old_last


# ---------------------------------------------------------------------------
# incidents, and the device ledger's sampling (tests/test_zdevice_smoke.py)
# ---------------------------------------------------------------------------


def incidents_triggers_fire_and_freeze(P, tmp):
    """Round escalation, a shed storm, a steady compile storm and a forced
    incident, each frozen once per cooldown, on a ticker clock."""
    P.tracing.set_clock(ticker(1_000_000))
    rec = P.inc.IncidentRecorder(round_limit=3, shed_storm=4,
                                 compile_storm=2, window_s=10.0,
                                 cooldown_s=1000.0)
    old = P.inc.install(rec)
    try:
        P.inc.poke(1, 0)
        P.inc.poke(1, 3)
        P.inc.poke(1, 5)          # same kind inside the cooldown: once
        P.inc.note_shed(4)
        P.inc.poke(2, 0)
        P.inc.note_compile(2)
        P.inc.poke(3, 0)
        P.fp.arm("incidents.force", "raise", count=1)
        P.inc.poke(4, 0)
        dump = P.inc.dump_incidents()
        tail = P.inc.incident_tail(8)
    finally:
        P.inc.install(old)
    # the counters and the other ledgers' tails sample live process state
    # (breakers, planes and ledgers other tests leave behind)
    snaps = [{k: v for k, v in s.items() if k == "trace_tail"
              or not (k == "counters" or k.endswith("_tail"))}
             for s in dump["incidents"]]
    assert [s["trigger"] for s in snaps] == [
        "round_escalation", "shed_storm", "compile_storm", "forced"]
    return snaps, dump["fired"], dump["thresholds"], tail


def deviceledger_compile_attribution_and_storm(P, tmp):
    dl = P.dl
    P.tracing.set_clock(ticker(1_000_000))
    led = dl.CompileLedger()
    old = dl.install(led)
    rec = P.inc.IncidentRecorder(compile_storm=2, window_s=10.0,
                                 cooldown_s=1000.0)
    old_rec = P.inc.install(rec)
    try:
        outer = dl.attr_begin("bench.cfg2")
        inner = dl.attr_begin("plane.flush", 7)
        dl.record_compile(0.05)
        dl.attr_end(inner)
        dl.record_compile(0.01)
        dl.attr_end(outer)
        fb = dl.attr_begin_fallback("mesh.step:fused")
        dl.record_compile(0.002)
        dl.attr_end(fb)
        dl.mark_steady()
        with dl.attr_context("plane.flush", 9):
            dl.record_compile(0.003)
            dl.record_compile(0.004)
        dl.record_compile(0.0, pcache_hit=True)
        P.inc.poke(1, 0)
        recs = led.records()
        out = (recs, dl.counters(), dl.ledger_tail(8), inner.ms, outer.ms,
               outer.n, dict(rec.fired))
    finally:
        dl.install(old)
        P.inc.install(old_rec)
    assert out[-1] == {"compile_storm": 1}
    return out


def deviceledger_residency_and_cost_surfaces(P, tmp):
    dl = P.dl
    tables = [SimpleNamespace(nbytes=4096, n_vals=128, devs=(0,)),
              SimpleNamespace(nbytes=1 << 20, n_vals=16384, devs=(0,)),
              SimpleNamespace(nbytes=1001, n_vals=0, n_dev=3)]
    shards = [SimpleNamespace(nbytes=999, m_shard=4096, devs=(0, 1, 2))]
    fams = dl.residency(tables=tables, shards=shards)
    fams.pop("staging")  # every live pool of the process: sampled below
    surf = dl.CostSurfaces()
    old = dl.install_surfaces(surf)
    try:
        for rows, ms in ((100, 1.0), (200, 1.5), (900, 4.0), (1000, 4.5)):
            dl.observe_flush("fused", "device", rows, 1, 0.0, 0.2, ms)
            dl.observe_flush("grouped", "host", rows, 1, 0.0, 0.0, 2 * ms)
        model = dl.cost_model()
        est = [model.estimate_dev_ms(f, r) for f in model.families()
               for r in (50, 256, 4096)]
        out = (fams, dl.headroom_rows(fams), surf.surfaces(),
               surf.counters(), model.families(), est,
               dl.rows_bucket(0), dl.rows_bucket(1000))
    finally:
        dl.install_surfaces(old)
    return out


def deviceledger_reconcile_is_exact(P, tmp):
    """The table caches' own resident bytes equal the per-device split,
    and every live staging pool is attributed to the host, to the byte."""
    tc = P.tc
    tc.reset_for_tests()
    pool = P.staging.StagingPool(slots=2)
    pool.get("x", (64, 8), "int32")
    with tc.LOCK:
        for i in range(3):
            tc.TABLES.put((b"k%d" % i, "dev"), SimpleNamespace(
                nbytes=100 + i, n_vals=128, devs=(0,)))
    try:
        rec = P.dl.reconcile()
        fams = P.dl.residency()
        assert rec["table_drift"] == 0 and rec["staging_drift"] == 0
        assert pool in P.staging.live_pools()
        return (rec["table_bytes_cache"], fams["valset_tables"],
                P.dl.headroom_rows(fams), pool.stats())
    finally:
        tc.reset_for_tests()


# ---------------------------------------------------------------------------
# bits, quantiles, staging, the table cache's snapshot
# ---------------------------------------------------------------------------


def bits_bit_array_ops(P, tmp):
    B = P.bits.BitArray
    a, b = B(70), B(70)
    for i in (0, 3, 64, 69):
        a.set_index(i, True)
    for i in (3, 5, 69):
        b.set_index(i, True)
    out = [a.or_(b).true_indices(), a.and_(b).true_indices(),
           a.sub(b).true_indices(), len(a.not_().true_indices()),
           a.get_index(64), a.set_index(70, True), a.copy() == a,
           B(0).is_empty(), repr(b)]
    random.seed(5)
    out.append(a.pick_random())
    return out


def quantiles_nearest_rank_and_wait_summary(P, tmp):
    xs = sorted([5.0, 1.0, 3.0, 9.0, 7.0, 2.0])
    return ([P.q.nearest_rank(xs, q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
            P.q.wait_summary_ms(xs), P.q.wait_summary_ms([]))


def staging_pool_rotation_and_stats(P, tmp):
    import numpy as np

    pool = P.staging.StagingPool(slots=2)
    a = pool.get("rows", (4, 3), np.int32)
    a[:] = 7
    b = pool.get("rows", (4, 3), np.int32)
    c = pool.get("rows", (4, 3), np.int32)        # a again, zeroed
    d = pool.get("rows", (4, 3), np.int32, zero=False)
    d_kept = int(d.sum())
    out = (c is a, int(c.sum()), d is b, d_kept, pool.hits, pool.misses,
           pool.nbytes(), pool.stats(), pool in P.staging.live_pools())
    pool.clear()
    return out + (pool.nbytes(),)


def table_cache_snapshot_values(P, tmp):
    tc = P.tc
    tc.reset_for_tests()
    try:
        with tc.LOCK:
            for i in range(3):
                tc.TABLES.put(("k%d" % i, "dev"), SimpleNamespace(
                    name=i, nbytes=10))
            tc.TABLES.get(("k0", "dev"))  # refresh: k0 is now newest
        snap = [v.name for v in tc.snapshot_values("tables")]
        again = [v.name for v in tc.snapshot_values("tables")]
        return (snap, again, tc.snapshot_values("shard_tables"),
                tc.resident_bytes())
    finally:
        tc.reset_for_tests()


def tenants_residency_and_cold_eviction(P, tmp):
    """The tenancy registry attributes the live table cache per chain at
    read time and evicts a tenant's cold tables, keeping its newest (the
    JAX package's tests/test_tenants.py, without the sharded cache). The
    port keys its tables by (content key, device)."""
    tc = P.tc
    key = (lambda k: (k, "cpu")) if P is PORT else (lambda k: k)
    tc.reset_for_tests()
    try:
        reg = P.tenants.TenantRegistry()
        with tc.LOCK:
            for i in range(3):  # insertion order == LRU coldness order
                tc.TABLES.put(key(b"epoch-%d" % i),
                              SimpleNamespace(nbytes=100))
                reg.note_table_owner(b"epoch-%d" % i, "chain-a")
            tc.TABLES.put(key(b"k-b"), SimpleNamespace(nbytes=2000))
            tc.TABLES.put(key(b"other"), SimpleNamespace(nbytes=4000))
        reg.note_table_owner(b"k-b", "chain-b")
        before = reg.residency_by_tenant()
        evicted = reg.evict_cold_tables("chain-a")
        kept = [key(b"epoch-%d" % i) in tc.TABLES for i in range(3)]
        return (before, evicted, kept, reg.residency_by_tenant(),
                reg.dump()["tenants"]["chain-a"]["cold_evictions"],
                tc.resident_bytes())
    finally:
        tc.reset_for_tests()


SCENARIOS = {fn.__name__: fn for fn in (
    tracing_disabled_is_noop, tracing_span_instant_flight_export,
    tracing_ring_buffer_bounds_and_drop_count,
    tracing_deterministic_mode_and_custom_clock, tracing_write_and_tail,
    tracing_profiler_bracket_noop_without_dir,
    tracing_plane_flush_lifecycle_spans,
    tracing_queued_ms_ignores_cross_clock_stamps,
    fp_unarmed_is_noop, fp_raise_action_and_counts, fp_delay_action,
    fp_flake_is_deterministic, fp_crash_handler_override,
    fp_simulated_crash_handler, fp_spec_parse_and_arm,
    fp_spec_rejects_garbage, fp_disarm_and_reset,
    fp_counters_surface_every_point, fp_fired_points_emit_trace_instants,
    fp_registry_swap_keeps_fire_hooks_intact,
    fp_plane_dispatch_failpoint_degrades_to_host,
    cp_attach_builds_only_sheddable_actuators,
    cp_consensus_lane_setters_rejected,
    cp_pressure_latch_tightens_then_relaxes_to_base,
    cp_relax_never_passes_base, cp_fill_pressure_triggers_before_shed_storm,
    cp_cooldown_gates_repeat_moves, cp_runaway_loop_clamps_at_bounds,
    cp_window_ceiling_capped_by_wait_slo,
    cp_decision_interval_gates_evaluation,
    cp_deck_grows_on_low_util_h2d_bound, cp_deck_shrinks_on_compile_storm,
    cp_decision_ring_bounded_and_dump_shape,
    cp_refused_apply_is_a_non_decision,
    cp_module_globals_and_dump_survive_clear, cp_empty_dump_shape,
    incidents_triggers_fire_and_freeze,
    deviceledger_compile_attribution_and_storm,
    deviceledger_residency_and_cost_surfaces,
    deviceledger_reconcile_is_exact,
    bits_bit_array_ops, quantiles_nearest_rank_and_wait_summary,
    staging_pool_rotation_and_stats, table_cache_snapshot_values,
    tenants_residency_and_cold_eviction)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_outputs_on_both_packages(name, tmp_path):
    fn = SCENARIOS[name]
    want = fn(JAX, tmp_path / "jax")
    _reset(JAX)
    got = fn(PORT, tmp_path / "port")
    assert got == want


# ---------------------------------------------------------------------------
# the port's own seams
# ---------------------------------------------------------------------------


def test_port_registries_are_separate_from_the_jax_package():
    PORT.fp.arm("t.only_port", "raise", count=1)
    JAX.fp.fail_point("t.only_port")  # the JAX registry never saw it
    with pytest.raises(PORT.fp.FailpointError):
        PORT.fp.fail_point("t.only_port")
    assert PORT.inc.recorder() is not JAX.inc.recorder()
    assert PORT.dl.ledger() is not JAX.dl.ledger()
    importlib.import_module("cometbft_tpu_torch.verifyplane.fused")
    assert "verifyplane.collect" in PORT.fp.registry().names()
    assert "verifyplane.collect" not in JAX.fp.registry().names()


def test_port_profiler_bracket_writes_a_chrome_trace(tmp_path):
    import json

    t = PORT.tracing
    t.enable(capacity=16)
    t.set_profile_dir(str(tmp_path))
    assert t.profiler_start() is True
    assert t.profiler_start() is False  # one capture at a time
    sum(range(1000))
    t.profiler_stop()
    t.profiler_stop()  # idempotent
    files = sorted(tmp_path.glob("plane-*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


def test_port_compile_ledger_records_kernel_builds(monkeypatch, tmp_path):
    """An nvcc build of the kernels is one compile of its wall seconds,
    attributed to the frame that needed the kernel, once the listener is
    armed; a build before arming is not recorded."""
    from cometbft_tpu_torch.ops import _build

    dl = PORT.dl
    led = dl.CompileLedger()
    old = dl.install(led)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_target",
                        lambda src, flags: tmp_path / f"{src}.so")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "_start", lambda *a: None)

    def finish(jobs):
        time.sleep(0.01)
        return "log"

    monkeypatch.setattr(_build, "_finish", finish)
    try:
        monkeypatch.setattr(dl, "_ARMED", False)
        _build.build_all()
        assert len(led) == 0 and not dl.listener_armed()
        assert dl.arm_compile_listener() is True
        assert _build.BUILD_LISTENERS.count(dl._on_build) == 1
        with dl.attr_context("plane.flush", 3) as fr:
            _build.build_all()
        (rec,) = led.records()
        assert rec["site"] == "plane.flush" and rec["flush_seq"] == 3
        assert rec["dur_ms"] >= 10.0
        assert fr.ms == pytest.approx(rec["dur_ms"], abs=1e-3)  # rounded
        assert dl.counters()["compiles"] == 1
    finally:
        dl.install(old)


def test_port_plane_threads_run_on_both_registries_at_once():
    """Two planes, one of each package, flush concurrently in one process
    without sharing a flush ledger, a breaker or a registry."""
    planes = [P.vp.VerifyPlane(window_ms=1.0, use_device=False)
              for P in (JAX, PORT)]
    results = [None, None]

    def run(k, P):
        p = planes[k]
        p.start()
        try:
            results[k] = p.submit_many(signed_rows(P, 3)).result(10.0)
        finally:
            p.stop()

    ts = [threading.Thread(target=run, args=(k, P))
          for k, P in enumerate((JAX, PORT))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert results[0] == results[1] == (True, True, True)
    assert planes[0].ledger is not planes[1].ledger
    assert [r["path"] for r in planes[1].ledger.records()] == ["host"]
