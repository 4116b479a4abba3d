"""The verify plane over a mesh, in process: the port's plane on 4 slots of
the CPU (CBT_TORCH_DEVICE_SLOTS=4, the kernels' plain versions) against the
JAX package's plane on 4 of the conftest's 8 forced CPU devices, with the
JAX side's two costly device programs stubbed as tests/_shardplane_prog.py
stubs them (the Pallas cached kernel by a precheck & ok fake, the XLA table
build by a shape-faithful fake). Both run tests/_shardplane_prog.py's
scenarios on a 300-validator set, whose 256-slot shards fill 2 of 4
members, and give the same report:

  * sharded flushes (`fused_sharded`, n_dev 2) with the oracle's verdicts,
    tallies and quorum bits, and a second wave that hits the step memo and
    the sharded table memo (no new build);
  * the flight deck: halves [[0, 1], [2, 3]], two flights airborne at once
    on disjoint halves (dev0 0 and 2, airborne_max 1) landing out of order;
  * a giant flush over half_mesh_rows that drains the deck first and takes
    the full mesh's clamp (0, 1);
  * a breaker trip mid-deck: both airborne flights fault at collect. The
    JAX plane answers from the host (`fused_host_fallback`); the port's
    futures fail with DeviceError on `device_fault` (ROADMAP C1), and both
    breakers count the same faults and trips;
  * the port's plan against the JAX plan byte for byte over a mesh and a
    half, and each slot's stamped rows against the one-device expansion.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.libs.staging import StagingPool as JPool
from cometbft_tpu.ops import ed25519_cached as jec
from cometbft_tpu.parallel import mesh as jpm
from cometbft_tpu.verifyplane import fused as jfz
from cometbft_tpu.verifyplane import plane as jvp
from cometbft_tpu_torch import device as pdevice
from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.libs import staging as pstaging
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import ed25519_stamp as es
from cometbft_tpu_torch.ops import table_cache as tc
from cometbft_tpu_torch.parallel import mesh as pm
from cometbft_tpu_torch.types import canonical as pcanon
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.verifyplane import fused as pfz
from cometbft_tpu_torch.verifyplane import plane as pvp

torch.set_num_threads(1)

NVALS = 300
EXPECT_NDEV = 2
E_N = 42                       # a deck wave's rows
BAD_SIG = b"\x5a" * 32 + b"\xff" * 32  # S >= L: precheck and ref reject
SUBMITTERS = list(range(0, NVALS, 7))


def _seed(i):
    return (4200 + i).to_bytes(4, "big") + b"\x77" * 28


PRIVS = [pkeys.PrivKey.generate(_seed(i)) for i in range(NVALS)]
PUBS = tuple(p.pub_key().data for p in PRIVS)
POWERS = tuple((i % 9 + 1) * 100 for i in range(NVALS))
_SIGS: dict = {}


def _sig(v, msg):
    key = (v, msg)
    s = _SIGS.get(key)
    if s is None:
        s = _SIGS[key] = PRIVS[v].sign(msg)
    return s


JAX = SimpleNamespace(name="jax", vp=jvp, fz=jfz, pm=jpm, keys=jkeys,
                      batch=jbatch)
PORT = SimpleNamespace(name="port", vp=pvp, fz=pfz, pm=pm, keys=pkeys,
                       batch=pbatch)


def _ids(m):
    if m is None:
        return None
    if isinstance(m, pm.Mesh):
        return m.indices
    return tuple(int(d.id) for d in m.devices.flat)


def fake_build_table(pub_bytes, powers=None):
    """The JAX table build's shape-faithful stand-in (tests/
    _shardplane_prog.py's): zero entries, the real ok bits, powers and raw
    keys."""
    import jax.numpy as jnp

    padded = jec.table_pad(len(pub_bytes))
    ok = np.zeros((padded,), np.bool_)
    ok[: len(pub_bytes)] = [len(p) == 32 for p in pub_bytes]
    return jec.ValsetTable(
        jnp.zeros((padded // 128 * jec.ENT_BLOCK, 128), jnp.int16),
        jnp.asarray(ok), jec._power_dev(powers, padded), padded,
        jec._pubs_host(pub_bytes, padded), jec._powers_host(powers, padded),
        jec._pub_raw(pub_bytes, padded))


@pytest.fixture
def planes(monkeypatch):
    """Both packages set up for sharded planes: the JAX side's CPU gate
    lifted and its two device programs stubbed, fresh step and shard
    memos on both sides, 4 slots of the CPU for the port."""
    from _kernel_stubs import fake_verify_tally_cached

    monkeypatch.setattr(jfz, "ALLOW_CPU_FUSED", True)
    monkeypatch.setattr(jec, "_BASE60_F32", np.zeros(
        (32 * 256, jec.ROWS_PER_ENT), np.float32))
    monkeypatch.setattr(jec, "_verify_tally_cached",
                        fake_verify_tally_cached)
    monkeypatch.setattr(jec, "build_table", fake_build_table)
    monkeypatch.setattr(jec, "_SHARD_CACHE", jec.tc.BoundedLRU("shard", 4))
    monkeypatch.setattr(jec, "_TABLE_CACHE", jec.tc.BoundedLRU("tables", 8))
    monkeypatch.setattr(jpm, "_STEP_CACHE", {})
    monkeypatch.setattr(pm, "_STEP_CACHE", {})
    monkeypatch.setenv(pm.SLOTS_ENV, "4")


def make_plane(P, **kw):
    kw.setdefault("mesh_devices", 4)
    kw.setdefault("mesh_min_rows", 1)
    kw.setdefault("breaker", P.batch.CircuitBreaker())
    if P is PORT:
        return pvp.VerifyPlane(device="cpu", **kw)
    return jvp.VerifyPlane(use_device=True, **kw)


def make_batch(P, groups, ext=True, submitters=SUBMITTERS):
    """(rows, vidx, group, power, expected verdicts) a submission: a vote
    (every 5th forged) and, with `ext`, an extension (every 11th forged:
    a valid vote with a forged extension must not count its power)."""
    subs = []
    for j, v in enumerate(submitters):
        pub = P.keys.PubKey(PUBS[v])
        m1, m2 = b"vote-%d" % v, b"ext-%d" % v
        s1 = BAD_SIG if j % 5 == 0 else _sig(v, m1)
        rows, vidx, exp = [(pub, m1, s1)], (v,), (j % 5 != 0,)
        if ext:
            s2 = BAD_SIG if j % 11 == 3 else _sig(v, m2)
            rows.append((pub, m2, s2))
            vidx, exp = (v, v), exp + (j % 11 != 3,)
        subs.append((rows, vidx, groups[v % 2], POWERS[v], exp))
    return subs


def expected(subs):
    verdicts = [e for *_, e in subs]
    tallies = [0, 0]
    for _rows, vidx, _g, pw, e in subs:
        if all(e):
            tallies[vidx[0] % 2] += pw
    return verdicts, tallies


def new_groups(P, thr):
    return [P.vp.QuorumGroup(thr[c], f"g{c}", valset_pubs=PUBS,
                             valset_powers=POWERS) for c in range(2)]


def submit(plane, subs):
    return [plane.submit_many(rows, power=pw, group=g, counted=True,
                              vidx=list(vidx))
            for rows, vidx, g, pw, _ in subs]


def result(fut, timeout=120.0):
    try:
        return tuple(fut.result(timeout))
    except pdevice.DeviceError:
        return "DeviceError"


def wait_until(cond, timeout=120.0, what="condition"):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def records(plane):
    return plane.dump_flushes()["flushes"]


# ---------------------------------------------------------------------------
# sharded flushes and the memos
# ---------------------------------------------------------------------------


def _sharded_run(P):
    """Wave 1: votes and extensions (two strides); wave 2: the votes
    again in fresh groups (one stride, every memo warm)."""
    subs0 = make_batch(P, [None, None])
    want, tallies = expected(subs0)
    thr = [tallies[0], tallies[1] + 1]  # one group clears, one misses
    mesh4 = P.fz.plane_mesh(4) if P is JAX else P.fz.plane_mesh(0, "cpu")
    m_eff, n_eff, m_s = P.fz.effective_mesh(mesh4, NVALS)
    plane = make_plane(P, window_ms=40.0, max_batch=4096)
    plane.start()
    try:
        out = []
        for wave in range(2):
            if wave:
                mesh0, tbl0 = P.pm.cache_stats(), _tstats(P)
            groups = new_groups(P, thr if not wave else [1, 10**9])
            subs = make_batch(P, groups, ext=not wave)
            with plane._cv:  # one flush a wave
                futs = submit(plane, subs)
            out.append(([result(f) for f in futs],
                        [g.tally for g in groups],
                        [g.quorum_reached for g in groups]))
        mesh1, tbl1 = P.pm.cache_stats(), _tstats(P)
    finally:
        plane.stop()
    recs = records(plane)
    summary = plane.dump_flushes()["summary"]
    stats = plane.stats()
    return dict(
        layout=(_ids(m_eff), n_eff, m_s),
        waves=out, want=(want, tallies, [True, False]),
        ledger=[(r["path"], r["n_dev"], r["dev0"], r["warm"], r["rows"])
                for r in recs],
        shard=summary["shard"]["flushes"],
        n_dev_max=summary["shard"]["n_dev_max"],
        tables=(summary["tables"]["cold"], summary["tables"]["warm"]),
        mesh_ndev=stats["mesh_ndev"], shard_flushes=stats["shard_flushes"],
        shard_rows=stats["shard_rows"],
        mesh_hits=mesh1["hits"] > mesh0["hits"],
        mesh_misses=mesh1["misses"] - mesh0["misses"],
        shard_hits=tbl1["shard_hits"] - tbl0["shard_hits"],
        shard_misses=tbl1["shard_misses"] - tbl0["shard_misses"])


def _tstats(P):
    return (jec.table_cache_stats() if P is JAX else tc.stats())


def test_sharded_flushes_equal_the_jax_plane(planes):
    tc.reset_for_tests()
    j, p = _sharded_run(JAX), _sharded_run(PORT)
    assert p == j
    want, tallies, quorum = p["want"]
    (v1, t1, q1), (v2, t2, q2) = p["waves"]
    assert v1 == want and t1 == tallies and q1 == quorum
    assert v2 == [w[:1] for w in want] and q2 == [True, False]
    assert p["layout"] == ((0, 1), EXPECT_NDEV, 256)
    n = len(want)
    assert p["ledger"] == [("fused_sharded", EXPECT_NDEV, 0, 0, 2 * n),
                           ("fused_sharded", EXPECT_NDEV, 0, 1, n)]
    assert (p["shard"], p["n_dev_max"], p["tables"]) == (2, 2, (1, 1))
    assert (p["mesh_ndev"], p["shard_flushes"], p["shard_rows"]) == \
        (4, 2, 3 * n)
    assert p["mesh_hits"] and p["mesh_misses"] == 0
    assert (p["shard_hits"], p["shard_misses"]) == (1, 0)


# ---------------------------------------------------------------------------
# the flight deck
# ---------------------------------------------------------------------------


class Gates:
    """Holds a package's dispatches and collects: each dispatched plan
    gets a release event its collect (and readiness probe) waits on, and
    `hold(plan)` may block a dispatch (tests/_shardplane_prog.py's
    gates)."""

    def __init__(self, P, monkeypatch):
        self.dispatched, self.release, self.entered = [], {}, {}
        self.fault_ids = set()
        self.hold = None
        fz = P.fz
        real_d, real_c, real_r = (fz.dispatch_fused, fz.collect_fused,
                                  fz.plan_ready)

        def dispatch(plan):
            real_d(plan)
            self.release[id(plan)] = threading.Event()
            self.entered[id(plan)] = threading.Event()
            self.dispatched.append(plan)
            if self.hold is not None:
                self.hold(plan)

        def collect(plan):
            ev = self.release.get(id(plan))
            if ev is not None:
                self.entered[id(plan)].set()
                assert ev.wait(120.0), "collect gate timed out"
            if id(plan) in self.fault_ids:
                raise RuntimeError("injected mid-deck device fault")
            return real_c(plan)

        def ready(plan):
            ev = self.release.get(id(plan))
            return ev.is_set() if ev is not None else real_r(plan)

        monkeypatch.setattr(fz, "dispatch_fused", dispatch)
        monkeypatch.setattr(fz, "collect_fused", collect)
        monkeypatch.setattr(fz, "plan_ready", ready)

    def let_go(self, plan):
        self.release[id(plan)].set()


def _waves(P, plane, groups, gates):
    """Two waves of E_N / 2 vote rows, one flush each: the first flush's
    dispatch is held until the second wave is queued."""
    subs = make_batch(P, groups, ext=False, submitters=SUBMITTERS[:E_N])
    first = threading.Event()
    gates.hold = lambda plan: (first.wait(60.0)
                               if len(gates.dispatched) == 1 else None)
    futs = submit(plane, subs[:E_N // 2])
    wait_until(lambda: len(gates.dispatched) == 1, what="flight 1")
    futs += submit(plane, subs[E_N // 2:])
    first.set()
    wait_until(lambda: len(gates.dispatched) == 2, what="flight 2")
    gates.hold = None
    return subs, futs


def _deck_run(P, monkeypatch):
    gates = Gates(P, monkeypatch)
    mesh4 = P.fz.plane_mesh(4) if P is JAX else P.fz.plane_mesh(0, "cpu")
    halves = P.fz.half_meshes(mesh4)
    subs0 = make_batch(P, [None, None], ext=False,
                       submitters=SUBMITTERS[:E_N])
    want, tallies = expected(subs0)
    thr = [tallies[0], tallies[1] + 1]
    plane = make_plane(P, window_ms=30_000.0, max_batch=E_N // 2,
                       pipeline_flights=2)
    plane.start()
    try:
        groups = new_groups(P, thr)
        subs, futs = _waves(P, plane, groups, gates)
        p1, p2 = gates.dispatched
        wait_until(lambda: plane.deck_airborne == 2, what="deck depth 2")
        halves_n = plane.stats()["halves"]
        # out of order: flight 2 lands while flight 1 is still airborne
        gates.let_go(p2)
        second = [result(f) for f in futs[E_N // 2:]]
        early = futs[0].done()
        gates.let_go(p1)
        first = [result(f) for f in futs[:E_N // 2]]
    finally:
        plane.stop()
    recs = sorted((r for r in records(plane)
                   if r["path"] == "fused_sharded"), key=lambda r: r["seq"])
    summary = plane.dump_flushes()["summary"]
    return dict(
        halves=[list(_ids(h)) for h in halves],
        half_layout=[P.fz.effective_mesh(h, NVALS)[1] for h in halves],
        flight_devs=[tuple(p1.devs), tuple(p2.devs)], halves_n=halves_n,
        verdicts=first + second, want=want,
        tallies=[g.tally for g in groups], want_tallies=tallies,
        quorum=[g.quorum_reached for g in groups],
        first_landed_early=early,
        ledger=[(r["airborne"], r["dev0"], r["n_dev"], r["overlapped"])
                for r in recs],
        landing=[r["seq"] for r in records(plane)],
        airborne_max=summary["deck"]["airborne_max"],
        deck_peak=plane.stats()["deck_peak"])


def test_deck_flies_disjoint_halves_and_lands_out_of_order(planes,
                                                          monkeypatch):
    j = _deck_run(JAX, monkeypatch)
    monkeypatch.undo()
    _redo(monkeypatch)
    p = _deck_run(PORT, monkeypatch)
    assert p == j
    assert p["halves"] == [[0, 1], [2, 3]]
    assert p["half_layout"] == [EXPECT_NDEV, EXPECT_NDEV]
    assert p["flight_devs"] == [(0, 1), (2, 3)] and p["halves_n"] == 2
    assert p["verdicts"] == [tuple(e) for e in p["want"]]
    assert p["tallies"] == p["want_tallies"]
    assert p["quorum"] == [True, False]
    assert not p["first_landed_early"]
    # flight 1 packed with none airborne, flight 2 beside it on the other
    # half; flight 2 landed first
    assert p["ledger"] == [(0, 0, 2, False), (1, 2, 2, True)]
    assert p["landing"][0] > p["landing"][1]
    assert p["airborne_max"] == 1 and p["deck_peak"] == 2


def _redo(monkeypatch):
    """The `planes` fixture's patches again, after a monkeypatch.undo()
    between the two packages' gated runs."""
    from _kernel_stubs import fake_verify_tally_cached

    monkeypatch.setattr(jfz, "ALLOW_CPU_FUSED", True)
    monkeypatch.setattr(jec, "_verify_tally_cached",
                        fake_verify_tally_cached)
    monkeypatch.setattr(jec, "build_table", fake_build_table)
    monkeypatch.setenv(pm.SLOTS_ENV, "4")


def _drain_run(P, monkeypatch):
    gates = Gates(P, monkeypatch)
    plane = make_plane(P, window_ms=30_000.0, max_batch=E_N // 2,
                       pipeline_flights=2, half_mesh_rows=E_N // 2)
    plane.start()
    try:
        groups = new_groups(P, [1, 1])
        subs = make_batch(P, groups, ext=False,
                          submitters=SUBMITTERS[:E_N // 2])
        futs = submit(plane, subs)
        wait_until(lambda: len(gates.dispatched) == 1, what="flight 1")
        pf1 = gates.dispatched[0]
        # one submission of 30 rows, over half_mesh_rows: the full mesh,
        # after the deck lands
        big = list(range(1, 61, 2))
        rows = [(P.keys.PubKey(PUBS[v]), b"big-%d" % v, _sig(v, b"big-%d"
                                                               % v))
                for v in big]
        fut_big = plane.submit_many(rows, group=P.vp.QuorumGroup(
            1, "big", valset_pubs=PUBS, valset_powers=POWERS),
            counted=False, vidx=big)
        wait_until(lambda: gates.entered[id(pf1)].is_set(),
                   what="the deck's drain before the full-mesh flush")
        undispatched = len(gates.dispatched) == 1
        gates.let_go(pf1)
        wait_until(lambda: len(gates.dispatched) == 2, what="big dispatch")
        pf2 = gates.dispatched[1]
        gates.let_go(pf2)
        big_v = result(fut_big)
        small = [result(f) for f in futs]
    finally:
        plane.stop()
    rec = [r for r in records(plane) if r["rows"] == len(big)]
    return dict(first=tuple(pf1.devs), big=tuple(pf2.devs),
                drain_first=pf2.drain_first, undispatched=undispatched,
                big_ok=big_v == (True,) * len(big),
                small=small == [e for *_, e in subs],
                rec=[(r["path"], r["airborne"], r["n_dev"]) for r in rec])


def test_giant_flush_drains_the_deck_then_takes_the_full_mesh(planes,
                                                             monkeypatch):
    j = _drain_run(JAX, monkeypatch)
    monkeypatch.undo()
    _redo(monkeypatch)
    p = _drain_run(PORT, monkeypatch)
    assert p == j
    assert p["first"] == (0, 1) and p["big"] == (0, 1)
    assert p["drain_first"] and p["undispatched"]
    assert p["big_ok"] and p["small"]
    assert p["rec"] == [("fused_sharded", 0, EXPECT_NDEV)]


def _trip_run(P, monkeypatch):
    gates = Gates(P, monkeypatch)
    brk = P.batch.CircuitBreaker(failure_threshold=1, cooldown=60.0)
    plane = make_plane(P, window_ms=30_000.0, max_batch=E_N // 2,
                       pipeline_flights=2, breaker=brk)
    plane.start()
    try:
        groups = new_groups(P, [1, 1])
        subs, futs = _waves(P, plane, groups, gates)
        wait_until(lambda: plane.deck_airborne == 2, what="deck depth 2")
        pg1, pg2 = gates.dispatched
        disjoint = set(pg1.devs).isdisjoint(pg2.devs)
        gates.fault_ids.update((id(pg1), id(pg2)))
        gates.let_go(pg1)
        gates.let_go(pg2)
        verdicts = [result(f) for f in futs]
    finally:
        plane.stop()
    recs = [r for r in records(plane) if r["rows"]]
    return dict(disjoint=disjoint, want=[e for *_, e in subs],
                verdicts=verdicts, state=brk.state,
                faults=brk._failures, trips=brk.trips,
                recs=[(r["path"], r["n_dev"], r["dev0"]) for r in recs],
                shard_flushes=plane.stats()["shard_flushes"])


def test_breaker_trip_mid_deck(planes, monkeypatch):
    j = _trip_run(JAX, monkeypatch)
    monkeypatch.undo()
    _redo(monkeypatch)
    p = _trip_run(PORT, monkeypatch)
    assert j["disjoint"] and p["disjoint"]
    # the breakers agree; the JAX plane answers from the host, the port's
    # fails the futures with DeviceError (ROADMAP C1)
    assert (p["state"], p["faults"], p["trips"]) == \
        (j["state"], j["faults"], j["trips"]) == ("open", 2, 1)
    assert j["verdicts"] == [tuple(e) for e in j["want"]]
    assert p["verdicts"] == ["DeviceError"] * E_N
    assert j["recs"] == [("fused_host_fallback", 1, 0)] * 2
    assert p["recs"] == [("device_fault", 1, 0)] * 2
    assert p["shard_flushes"] == j["shard_flushes"] == 0


# ---------------------------------------------------------------------------
# the plan over a mesh, and the per-slot stamping
# ---------------------------------------------------------------------------


CHAIN, HEIGHT = "shard-chain", 5150


def _stamped_subs(P_vote, P_canon, PubKey, BID, PSH, n=E_N, ext_at=None):
    """Precommits of SUBMITTERS[:n] with VoteSet's stamp metadata, one
    group; `ext_at` adds an extension row to that submission."""
    bid = BID(b"\x19" * 32, PSH(4, b"\x91" * 32))
    tpl = P_vote.sign_bytes_template(CHAIN, P_canon.PRECOMMIT_TYPE, HEIGHT,
                                     0, bid)
    subs = []
    for j, v in enumerate(SUBMITTERS[:n]):
        secs, nanos = 1_700_000_000 + 17 * j, (j * 131) % 10**9
        msg = tpl.patch_rows([secs], [nanos]).row(0)
        rows = [(PubKey(PUBS[v]), msg, _sig(v, msg))]
        stamp = [(tpl, secs, nanos)]
        vidx = [v]
        if j == ext_at:
            rows.append((PubKey(PUBS[v]), b"ext", _sig(v, b"ext")))
            stamp.append(None)
            vidx.append(v)
        subs.append(dict(rows=rows, power=POWERS[v], counted=True,
                         vidx=vidx, stamp=stamp))
    return subs


def _port_subs(**kw):
    return _stamped_subs(pvote, pcanon, pkeys.PubKey, BlockID,
                         PartSetHeader, **kw)


def _jax_subs(**kw):
    from cometbft_tpu.types import canonical as jcanon
    from cometbft_tpu.types import vote as jvote
    from cometbft_tpu.types.block_id import BlockID as JBID
    from cometbft_tpu.types.block_id import PartSetHeader as JPSH

    return _stamped_subs(jvote, jcanon, jkeys.PubKey, JBID, JPSH, **kw)


def _plan(vp, fz, subs, pool, **kw):
    g = vp.QuorumGroup(1, "g", valset_pubs=PUBS, valset_powers=POWERS)
    batch = [vp._Submission(s["rows"], g, s["power"], s["counted"],
                            s["vidx"], stamp=s["stamp"]) for s in subs]
    return fz.plan_fused(batch, pool=pool, **kw)


@pytest.mark.parametrize("branch", ["stamped", "host_extension"])
@pytest.mark.parametrize("offer", ["mesh", "half", "half_over_rows"])
def test_sharded_plan_stages_the_jax_bytes(branch, offer, monkeypatch):
    monkeypatch.setattr(jfz, "ALLOW_CPU_FUSED", True)
    monkeypatch.setenv(pm.SLOTS_ENV, "4")
    ext = 3 if branch == "host_extension" else None
    jm, pmm = jfz.plane_mesh(4), pfz.plane_mesh(0, "cpu")
    kw_j, kw_p = dict(mesh=jm), dict(mesh=pmm)
    if offer != "mesh":
        kw_j["half"] = jfz.half_meshes(jm)[1]
        kw_p["half"] = pfz.half_meshes(pmm)[1]
        if offer == "half_over_rows":
            kw_j["half_max_rows"] = kw_p["half_max_rows"] = 10
    jp = _plan(jvp, jfz, _jax_subs(ext_at=ext), JPool(slots=2), **kw_j)
    pp = _plan(pvp, pfz, _port_subs(ext_at=ext),
               pstaging.StagingPool(slots=2), device="cpu", **kw_p)
    assert pp.stamped == jp.stamped == (branch == "stamped")
    np.testing.assert_array_equal(pp.pos, jp.pos)
    np.testing.assert_array_equal(pp.thresh, jp.thresh)
    assert (pp.n_dev, tuple(pp.devs), pp.drain_first, pp.util) == (
        jp.n_dev, tuple(jp.devs), jp.drain_first, jp.util)
    assert pp.counted_pos == jp.counted_pos
    assert pfz.plan_h2d_bytes(pp) == jfz.plan_h2d_bytes(jp)
    if pp.stamped:
        for got, want in zip(pp.delta, jp.delta):
            assert got.tobytes() == want.tobytes()
    else:
        assert pp.rows.tobytes() == jp.rows.tobytes()
        b = pp.rows.shape[1] // pp.n_dev
        for d, part in enumerate(pp.slot_rows):
            np.testing.assert_array_equal(
                part[:ec.V_KROWS], pp.rows[:ec.V_KROWS, d * b:(d + 1) * b])
            assert not part[ec.V_KROWS:].any()
    want_devs = {"mesh": (0, 1), "half": (2, 3), "half_over_rows": (0, 1)}
    assert tuple(pp.devs) == want_devs[offer]
    assert pp.drain_first == (offer == "half_over_rows")


def test_slot_stamping_equals_the_one_device_expansion(monkeypatch):
    """Each slot stamps its own column slice against its own pub_raw
    shard; the gathered rows equal the one-device stamp of the whole
    delta (B == M: the layout shard_positions ships with one stride)."""
    monkeypatch.setenv(pm.SLOTS_ENV, "4")
    subs = _port_subs(n=E_N)
    mesh = pfz.effective_mesh(pfz.plane_mesh(0, "cpu"), NVALS)[0]
    plan = _plan(pvp, pfz, subs, pstaging.StagingPool(slots=2),
                 device="cpu", mesh=mesh)
    assert plan.stamped and plan.n_dev == 2 and plan.delta[0].shape[0] == 512
    ent = es.template_entry(plan.sites, device="cpu")
    pub_raw = torch.from_numpy(ec._pack_pub_arrays(PUBS, 512)[0])
    dsig, dts, dfl = (torch.from_numpy(a) for a in plan.delta)
    thr0 = torch.zeros((1, 6), dtype=torch.int32)
    one = es.stamp_rows(dsig, dts, dfl, ent, pub_raw, thr0, 1)
    shards = (pub_raw[:256], pub_raw[256:])
    got = pm.sharded_stamp_rows(mesh, ent.msg_max)(
        dsig, dts, dfl, ent.pre_mat, ent.pre_len, ent.suf_mat, ent.suf_len,
        ent.ts_tag, shards)
    assert torch.equal(got, one)
    assert got.any()


def test_stamped_flush_over_two_slots_equals_the_oracle(monkeypatch):
    """A device-stamped flush of 42 precommits planned over the mesh's
    clamp (2 slots of 256) and run by the plane's dispatch: each slot
    stamps, verifies and tallies on the plain kernels; the verdicts are
    the oracle's, the tally is the valid votes' power, and the stamped
    step equals the host-packed step on the same (stamped) rows."""
    monkeypatch.setenv(pm.SLOTS_ENV, "4")
    subs = _port_subs(n=E_N)
    bad = 5  # a flipped signature
    s0 = subs[bad]["rows"][0]
    subs[bad]["rows"] = [(s0[0], s0[1], s0[2][:9] + bytes([s0[2][9] ^ 1])
                          + s0[2][10:])]
    mesh = pfz.effective_mesh(pfz.plane_mesh(0, "cpu"), NVALS)[0]
    g = pvp.QuorumGroup(1, "g", valset_pubs=PUBS, valset_powers=POWERS)
    batch = [pvp._Submission(s["rows"], g, s["power"], s["counted"],
                             s["vidx"], stamp=s["stamp"]) for s in subs]
    plan = pfz.plan_fused(batch, pool=pstaging.StagingPool(slots=2),
                          device="cpu", mesh=mesh)
    assert plan.stamped and plan.n_dev == 2
    pfz.dispatch_fused(plan)
    verdicts, tallies = pfz.collect_fused(plan)
    from cometbft_tpu_torch.crypto import ed25519_ref as ed

    want = [ed.verify(p.data, m, s) for sub in subs for p, m, s in
            sub["rows"]]
    assert verdicts == want and want.count(False) == 1
    assert tallies[g] == sum(s["power"] for s, w in zip(subs, want) if w)
    # the same flush through the host-packed step, on the rows the slots
    # stamped: equal outputs
    table, warm = ec.sharded_table_for_pubs_info(PUBS, POWERS, mesh)
    assert warm
    ent = es.template_entry(plan.sites, device="cpu")
    rows = pm.sharded_stamp_rows(mesh, ent.msg_max)(
        *(torch.from_numpy(a) for a in plan.delta), ent.pre_mat,
        ent.pre_len, ent.suf_mat, ent.suf_len, ent.ts_tag, table.pub_raw)
    fused = pm.sharded_fused_verify(mesh, 1)(
        rows, table.tab, table.ok, table.power5, None, plan.thresh)
    for a, b in zip(fused, plan.pending):
        assert torch.equal(a, b)
