"""The port's next-epoch table warmer (cometbft_tpu_torch/verifyplane/
warmer.py) against the JAX package's.

Ten warmer-object scenarios of tests/test_warmer.py (:149, :170, :184,
:204, :222, :233, :263, :281, :431, :525) run on both warmers with the
same build_fn / use_device / failpoint / breaker settings; the port's
warmer also gets device="cpu" (its default, the card, raises here). The
counters (builds_ok, builds_failed, builds_skipped, builds_skipped_quota,
superseded, builds_incremental, warmed_hits) and each scenario's own
observations must be equal. Then the port's own seams: one real build of
an 8-validator table on the CPU (the plain table build), shared by the
module, whose first lookup is a warmed hit; the incremental warm of a
power change; a template prefetch; the device resolution; and mesh_fn
refused until the multi-device slice."""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.libs import failpoints as jfp
from cometbft_tpu.ops import ed25519_cached as jec
from cometbft_tpu.ops import table_cache as jtc
from cometbft_tpu.types import validator as jval
from cometbft_tpu.verifyplane import warmer as jwm
from cometbft_tpu_torch import device as pdevice
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.libs import failpoints as pfp
from cometbft_tpu_torch.ops import ed25519_cached as pec
from cometbft_tpu_torch.ops import table_cache as ptc
from cometbft_tpu_torch.types import canonical as pcanon
from cometbft_tpu_torch.types import validator as pval
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.verifyplane import warmer as pwm

torch.set_num_threads(1)

JAX = SimpleNamespace(
    name="jax", wm=jwm, tc=jtc, ec=jec, fp=jfp, keys=jkeys, val=jval,
    kw={}, key=lambda pubs, powers: jec._cache_key(pubs, powers),
    # the JAX warmer's mesh resolver, as its tests pass it (no mesh)
    mesh={"mesh_fn": lambda: None},
    lookup=lambda fn: (lambda p, pw: fn()))
PORT = SimpleNamespace(
    name="port", wm=pwm, tc=ptc, ec=pec, fp=pfp, keys=pkeys, val=pval,
    kw={"device": "cpu"},
    key=lambda pubs, powers: (pec._cache_key(pubs, powers), "cpu"),
    mesh={},
    lookup=lambda fn: (lambda p, pw, device=None: fn()))

COUNTERS = ("builds_ok", "builds_failed", "builds_skipped",
            "builds_skipped_quota", "superseded", "builds_incremental")


@pytest.fixture(autouse=True)
def _clean():
    for P in (JAX, PORT):
        P.fp.reset()
    yield
    for P in (JAX, PORT):
        P.fp.reset()
        P.wm.set_global_warmer(None)
        P.wm._LAST = None


class FakeBreaker:
    def __init__(self, state="closed"):
        self.state = state


class FakeTable:
    def __init__(self, nbytes=1000):
        self.nbytes = nbytes


def counters(P, w, hits0):
    out = {k: getattr(w, k) for k in COUNTERS}
    out["warmed_hits"] = P.tc.STATS["warmed_hits"] - hits0
    return out


def _warmed_key_attribution_bounded(P, monkeypatch):
    # test_warmer.py:149
    base = P.tc.STATS["warmed_hits"]
    P.tc.note_warmed(b"k1")
    first = P.tc.consume_warmed(b"k1")
    second = P.tc.consume_warmed(b"k1")
    for i in range(100):
        P.tc.note_warmed(b"flood-%d" % i)
    return {"first": first, "second": second,
            "hits": P.tc.STATS["warmed_hits"] - base,
            "bounded": len(P.tc._WARMED) <= P.tc._WARMED_MAX,
            "max": P.tc._WARMED_MAX}


def _builds_and_attributes(P, monkeypatch):
    # test_warmer.py:170
    built = []
    hits0 = P.tc.STATS["warmed_hits"]
    w = P.wm.TableWarmer(build_fn=lambda p, pw: built.append((p, pw)),
                         breaker=FakeBreaker(), **P.kw)
    w.start()
    try:
        w.request((b"a" * 32, b"b" * 32), (5, 7))
        idle = [w.wait_idle(5.0)]
        return {"idle": idle, "built": built, **counters(P, w, hits0)}
    finally:
        w.stop()


def _failpoint_degrades_to_cold_path(P, monkeypatch):
    # test_warmer.py:184
    built = []
    hits0 = P.tc.STATS["warmed_hits"]
    P.fp.registry().arm_from_spec("warmer.build=raise*1")
    w = P.wm.TableWarmer(build_fn=lambda p, pw: built.append(1),
                         breaker=FakeBreaker(), **P.kw)
    w.start()
    try:
        w.request((b"x",), (1,))
        idle = [w.wait_idle(5.0)]
        mid = (list(built), counters(P, w, hits0))
        w.request((b"y",), (1,))
        idle.append(w.wait_idle(5.0))
        return {"idle": idle, "mid": mid, "built": built,
                **counters(P, w, hits0)}
    finally:
        w.stop()


def _skips_when_breaker_open(P, monkeypatch):
    # test_warmer.py:204
    built = []
    hits0 = P.tc.STATS["warmed_hits"]
    brk = FakeBreaker("open")
    w = P.wm.TableWarmer(build_fn=lambda p, pw: built.append(1),
                         breaker=brk, **P.kw)
    w.start()
    try:
        w.request((b"x",), (1,))
        idle = [w.wait_idle(5.0)]
        mid = (list(built), counters(P, w, hits0))
        brk.state = "closed"
        w.request((b"x",), (1,))
        idle.append(w.wait_idle(5.0))
        return {"idle": idle, "mid": mid, "built": built,
                **counters(P, w, hits0)}
    finally:
        w.stop()


def _no_device_no_buildfn_skips(P, monkeypatch):
    # test_warmer.py:222 (use_device=False resolves no device on the port)
    hits0 = P.tc.STATS["warmed_hits"]
    w = P.wm.TableWarmer(breaker=FakeBreaker(), use_device=False)
    w.start()
    try:
        w.request((b"x",), (1,))
        idle = [w.wait_idle(5.0)]
        w.request_template(("site",))
        idle.append(w.wait_idle(5.0))
        return {"idle": idle, "tmpl_warms": w.tmpl_warms,
                **counters(P, w, hits0)}
    finally:
        w.stop()


def _latest_request_wins(P, monkeypatch):
    # test_warmer.py:233
    gate = threading.Event()
    built = []
    hits0 = P.tc.STATS["warmed_hits"]

    def slow_build(p, pw):
        built.append(p)
        gate.wait(5.0)

    w = P.wm.TableWarmer(build_fn=slow_build, breaker=FakeBreaker(),
                         **P.kw)
    w.start()
    try:
        w.request((b"e1",), None)
        for _ in range(500):
            if built:
                break
            time.sleep(0.01)
        first = list(built)
        w.request((b"e2",), None)
        w.request((b"e3",), None)  # supersedes e2 before it starts
        gate.set()
        idle = [w.wait_idle(5.0)]
        return {"first": first, "idle": idle, "built": built,
                **counters(P, w, hits0)}
    finally:
        w.stop()


def _stop_mid_warm_is_clean(P, monkeypatch):
    # test_warmer.py:263
    gate = threading.Event()
    hits0 = P.tc.STATS["warmed_hits"]
    w = P.wm.TableWarmer(build_fn=lambda p, pw: gate.wait(10.0),
                         breaker=FakeBreaker(), **P.kw)
    w.start()
    w.request((b"e1",), None)
    t0 = time.monotonic()
    w.stop()
    prompt = time.monotonic() - t0 < 5.0
    running = w.is_running()
    w.request((b"e2",), None)  # no-op on a stopped warmer
    stats = w.stats()
    gate.set()
    return {"prompt": prompt, "running": running,
            "accepting": stats["running"], **counters(P, w, hits0)}


def _notify_next_valset_plumbs_through_global(P, monkeypatch):
    # test_warmer.py:281
    privs = [P.keys.PrivKey.generate(bytes([40 + i]) * 32)
             for i in range(3)]
    vs = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10 + i)
                             for i, p in enumerate(privs)])
    P.wm.notify_next_valset(vs)  # no warmer: must not raise
    built = []
    hits0 = P.tc.STATS["warmed_hits"]
    w = P.wm.TableWarmer(build_fn=lambda p, pw: built.append((p, pw)),
                         breaker=FakeBreaker(), **P.kw)
    w.start()
    P.wm.set_global_warmer(w)
    try:
        got = P.wm.global_warmer() is w
        P.wm.notify_next_valset(vs)
        idle = [w.wait_idle(5.0)]
        return {"global": got, "idle": idle, "built": built,
                "want": (tuple(v.pub_key.data for v in vs.validators),
                         tuple(v.voting_power for v in vs.validators)),
                **counters(P, w, hits0)}
    finally:
        P.wm.clear_global_warmer(w)
        w.stop()
        assert P.wm.global_warmer() is None
        assert P.wm.last_warmer() is w


def _repeat_notify_does_not_self_consume(P, monkeypatch):
    # test_warmer.py:431
    pubs, powers = (b"repeat-epoch" * 2 + b"xxxxxxxx",), (3,)
    key = P.key(pubs, powers)
    calls = []
    monkeypatch.setattr(P.ec, "table_for_pubs_info", P.lookup(
        lambda: (calls.append(1) or (FakeTable(), False))))
    w = P.wm.TableWarmer(breaker=FakeBreaker(), use_device=True,
                         **P.mesh, **P.kw)
    w.start()
    hits0 = P.tc.STATS["warmed_hits"]
    try:
        w.request(pubs, powers)
        idle = [w.wait_idle(5.0)]
        first = (len(calls), key in P.tc._WARMED)
        with P.tc.LOCK:
            P.tc.TABLES.put(key, FakeTable())
        w.request(pubs, powers)
        idle.append(w.wait_idle(5.0))
        return {"idle": idle, "first": first, "calls": len(calls),
                "pending_mark": key in P.tc._WARMED,
                **counters(P, w, hits0)}
    finally:
        w.stop()
        with P.tc.LOCK:
            P.tc.TABLES.pop(key)
        P.tc._WARMED.pop(key, None)


def _does_not_claim_tables_built_cold(P, monkeypatch):
    # test_warmer.py:525
    sent = {"hit": True}
    monkeypatch.setattr(P.ec, "table_for_pubs_info", P.lookup(
        lambda: (object(), sent["hit"])))
    noted = []
    monkeypatch.setattr(P.ec, "note_warmed", noted.append)
    hits0 = P.tc.STATS["warmed_hits"]
    w = P.wm.TableWarmer(breaker=FakeBreaker(), use_device=True,
                         **P.mesh, **P.kw)
    w.start()
    try:
        w.request((b"cold-already-paid",), (1,))
        idle = [w.wait_idle(5.0)]
        after_hit = len(noted)
        sent["hit"] = False
        w.request((b"genuinely-warmed",), (1,))
        idle.append(w.wait_idle(5.0))
        return {"idle": idle, "after_hit": after_hit,
                "noted": [n == P.key((b"genuinely-warmed",), (1,))
                          for n in noted],
                **counters(P, w, hits0)}
    finally:
        w.stop()


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _warmed_key_attribution_bounded, _builds_and_attributes,
    _failpoint_degrades_to_cold_path, _skips_when_breaker_open,
    _no_device_no_buildfn_skips, _latest_request_wins,
    _stop_mid_warm_is_clean, _notify_next_valset_plumbs_through_global,
    _repeat_notify_does_not_self_consume,
    _does_not_claim_tables_built_cold)}

# what the JAX package's own tests assert of each scenario
EXPECT = {
    "warmed_key_attribution_bounded": dict(first=True, second=False,
                                           hits=1, bounded=True),
    "builds_and_attributes": dict(
        built=[((b"a" * 32, b"b" * 32), (5, 7))], builds_ok=1),
    "failpoint_degrades_to_cold_path": dict(built=[1], builds_ok=1,
                                            builds_failed=1),
    "skips_when_breaker_open": dict(built=[1], builds_ok=1,
                                    builds_skipped=1),
    "no_device_no_buildfn_skips": dict(builds_skipped=2, tmpl_warms=0),
    "latest_request_wins": dict(built=[(b"e1",), (b"e3",)],
                                superseded=1),
    "stop_mid_warm_is_clean": dict(prompt=True, running=False),
    "notify_next_valset_plumbs_through_global": dict(global_=True),
    "repeat_notify_does_not_self_consume": dict(
        first=(1, True), calls=1, pending_mark=True, warmed_hits=0),
    "does_not_claim_tables_built_cold": dict(after_hit=0, noted=[True]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_warmer_scenario_matches_the_jax_warmer(name, monkeypatch):
    got = {P.name: SCENARIOS[name](P, monkeypatch) for P in (JAX, PORT)}
    assert got["port"] == got["jax"]
    for k, v in EXPECT[name].items():
        if k == "global_":
            assert got["jax"]["global"] is True
            assert got["jax"]["built"] == [got["jax"]["want"]]
            continue
        assert got["jax"][k] == v, (k, got["jax"][k])
    assert all(got["jax"].get("idle", [True]))


def test_mesh_fn_is_refused_until_the_multi_device_slice():
    with pytest.raises(TypeError, match="mesh_fn"):
        pwm.TableWarmer(mesh_fn=lambda: None, device="cpu")
    w = pwm.TableWarmer(build_fn=lambda p, pw: None, device="cpu")
    assert w.device == torch.device("cpu")


def test_a_warmer_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pdevice.DeviceError):
        pwm.TableWarmer()
    assert pwm.TableWarmer(use_device=False).device is None
    assert pwm.TableWarmer(device="cpu").device == torch.device("cpu")


# --------------------------------------------------------------------------
# one real build on the CPU (the plain table build), shared by the module
# --------------------------------------------------------------------------

N_REAL = 8


def _real_valset():
    rng = np.random.default_rng(1515)
    privs = [pkeys.PrivKey.generate(rng.bytes(32)) for _ in range(N_REAL)]
    powers = [int(p) for p in rng.integers(1, 1000, N_REAL)]
    return pval.ValidatorSet([pval.Validator(p.pub_key(), w)
                              for p, w in zip(privs, powers)])


@pytest.fixture(scope="module")
def real_warm():
    """An epoch e+1 valset warmed for real on the CPU, then its first
    lookup (a post-rotation flush's). The caches start empty."""
    ptc.reset_for_tests()
    vs = _real_valset()
    pubs = tuple(v.pub_key.data for v in vs.validators)
    powers = tuple(v.voting_power for v in vs.validators)
    w = pwm.TableWarmer(breaker=FakeBreaker(), device="cpu")
    w.start()
    try:
        pwm.set_global_warmer(w)
        pwm.notify_next_valset(vs)
        assert w.wait_idle(300.0)
        stats0 = dict(ptc.STATS)
        key = (pec._cache_key(pubs, powers), "cpu")
        marked = key in ptc._WARMED
        table, warm = pec.table_for_pubs_info(pubs, powers, device="cpu")
        stats1 = dict(ptc.STATS)
        yield SimpleNamespace(w=w, vs=vs, pubs=pubs, powers=powers,
                              stats0=stats0, stats1=stats1, key=key,
                              marked=marked, table=table, warm=warm)
    finally:
        pwm.clear_global_warmer(w)
        w.stop()


def test_a_real_warm_makes_the_first_lookup_a_warmed_hit(real_warm):
    r = real_warm
    assert r.w.stats()["builds_ok"] == 1
    assert r.w.stats()["builds_incremental"] == 0
    assert r.w.last_build_ms > 0
    assert r.marked  # marked because the warmer built it
    assert r.warm  # the post-rotation lookup is a straight hit
    assert r.stats1["warmed_hits"] - r.stats0["warmed_hits"] == 1
    assert r.stats1["misses"] == r.stats0["misses"]
    assert r.table.n_vals == pec.table_pad(N_REAL)
    assert r.table.device == torch.device("cpu")
    assert r.key not in ptc._WARMED  # consumed once


def test_a_power_change_warms_incrementally(real_warm):
    """Epoch e+2 changes one validator's power: the warm patches the
    cached table (update_table) instead of a full build, and is counted
    so; its first lookup is a warmed hit too."""
    r = real_warm
    powers = list(r.powers)
    powers[3] += 17
    powers = tuple(powers)
    ok0 = r.w.builds_ok
    r.w.request(r.pubs, powers)
    assert r.w.wait_idle(300.0)
    assert r.w.builds_ok == ok0 + 1
    assert r.w.builds_incremental == 1
    hits0 = ptc.STATS["warmed_hits"]
    table, warm = pec.table_for_pubs_info(r.pubs, powers, device="cpu")
    assert warm and ptc.STATS["warmed_hits"] == hits0 + 1
    assert int(table.powers_host[3]) == powers[3]
    # a repeat notify of a cached valset is a peek: no build, no mark
    r.w.request(r.pubs, powers)
    assert r.w.wait_idle(300.0)
    assert r.w.builds_ok == ok0 + 2
    assert (pec._cache_key(r.pubs, powers), "cpu") not in ptc._WARMED


def test_a_template_prefetch_builds_once_on_the_warmer_device(real_warm):
    r = real_warm
    bid = BlockID(b"\x31" * 32, PartSetHeader(1, b"\x32" * 32))
    tmpl = pvote.sign_bytes_template("warm-chain", pcanon.PRECOMMIT_TYPE,
                                     9, 0, bid)
    sites = (tmpl.stamp_site(),)
    n0 = r.w.tmpl_warms
    r.w.request_template(sites)
    assert r.w.wait_idle(60.0)
    r.w.request_template(sites)  # cached: no second build, no mark
    assert r.w.wait_idle(60.0)
    assert r.w.tmpl_warms == n0 + 1
    key = ("template", tuple(s.key for s in sites), "cpu")
    assert key in ptc._WARMED
