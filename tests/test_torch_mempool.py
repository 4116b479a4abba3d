"""The port's mempool (cometbft_tpu_torch/mempool/) against the JAX
package's.

tests/test_mempool_concurrent.py's eight scenarios run as functions of a
package namespace: the five that need no plane on both packages, the three
that route signed txs through a verify plane's BULK lane on a JAX host
plane, a port host plane (use_device=False) and a port device="cpu" plane
(the grouped path on the plain ed25519 kernel). Each scenario asserts the
JAX test's invariants on every side, and its deterministic outcome (the
codes of every tx, the pool's contents) must be equal across sides. Then
the port's seam for the last face of ROADMAP C1: a device plane's flush
that faults is answered by verify_batch_direct on that plane's device, a
plane that cannot take the row the same way, a DeviceError leaves check_tx
with the tx out of the dedup cache, and with no plane a signed tx goes to
the card (DeviceError here) while an unsigned one still reaches the app.
"""
import threading
from types import SimpleNamespace

import pytest
import torch

from cometbft_tpu import verifyplane as jvp
from cometbft_tpu.abci import kvstore as jkv
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.libs import failpoints as jfp
from cometbft_tpu.mempool import admission as jadm
from cometbft_tpu.mempool import mempool as jmp
from cometbft_tpu.mempool import sigtx as jsigtx
from cometbft_tpu_torch import verifyplane as pvp
from cometbft_tpu_torch.abci import kvstore as pkv
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.device import DeviceError
from cometbft_tpu_torch.libs import failpoints as pfp
from cometbft_tpu_torch.mempool import admission as padm
from cometbft_tpu_torch.mempool import mempool as pmp
from cometbft_tpu_torch.mempool import sigtx as psigtx

torch.set_num_threads(1)

JAX = SimpleNamespace(name="jax", abci=jabci, kv=jkv, keys=jkeys,
                      sigtx=jsigtx, adm=jadm, mp=jmp, vp=jvp, fp=jfp)
PORT = SimpleNamespace(name="port", abci=pabci, kv=pkv, keys=pkeys,
                       sigtx=psigtx, adm=padm, mp=pmp, vp=pvp, fp=pfp)
PACKAGES = {"jax": JAX, "port": PORT}
# (package, plane kwargs): the JAX host plane, the port's host plane and
# its device plane on the CPU (a breaker of its own, so no fault of a
# scenario reaches the process-wide device breaker)
PLANE_SIDES = {"jax": (JAX, {"use_device": False}),
               "port_host": (PORT, {"use_device": False}),
               "port_device": (PORT, {"device": "cpu"})}

N_THREADS = 8
# signed-tx scenarios: txs a thread (the JAX test's 25 would cost ~13
# flushes of the plain kernel, ~2.4 s each on one core, on the device side)
ORACLE_TXS = 8


def _plane(P, **kw):
    if "device" in kw:
        kw = dict(kw, breaker=pbatch.CircuitBreaker(name="test-mempool"))
    return P.vp.VerifyPlane(**kw)


class mounted_plane:
    """A started plane of package P mounted as the global plane."""

    def __init__(self, P, **kw):
        self.P, self.kw = P, kw

    def __enter__(self):
        self.plane = _plane(self.P, **self.kw)
        self.plane.start()
        self.P.vp.set_global_plane(self.plane)
        return self.plane

    def __exit__(self, *exc):
        self.P.vp.set_global_plane(None)
        self.plane.stop()


def _hammer(fn, n_threads=N_THREADS):
    """Run fn(thread_index) on n_threads, re-raising any failure."""
    errs = []

    def run(k):
        try:
            fn(k)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(k,))
          for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs[:3]


# -- the five scenarios with no plane ---------------------------------------


def duplicate_tx_admitted_once(P):
    mp = P.mp.Mempool(P.kv.KVStoreApplication(), max_txs=64,
                      verify_sigs=False)
    codes, lock = [], threading.Lock()

    def submit(_k):
        for _ in range(50):
            resp = mp.check_tx(b"dup-tx=1")
            with lock:
                codes.append(resp.code)

    _hammer(submit)
    assert codes.count(P.abci.CODE_TYPE_OK) == 1
    assert mp.size() == 1 and mp.gas_entries() == 1
    return {"codes": sorted(codes), "pool": mp.reap()}


def full_pool_drop_and_uncache(P):
    cap = 16
    mp = P.mp.Mempool(P.kv.KVStoreApplication(), max_txs=cap,
                      verify_sigs=False)
    results, lock = {}, threading.Lock()

    def submit(k):
        for i in range(cap):
            tx = b"tx-%d-%d=v" % (k, i)
            resp = mp.check_tx(tx)
            with lock:
                results[tx] = resp

    _hammer(submit)
    oks = [tx for tx, r in results.items() if r.code == P.abci.CODE_TYPE_OK]
    fulls = [tx for tx, r in results.items()
             if r.code != P.abci.CODE_TYPE_OK]
    assert len(oks) == cap
    assert fulls and all("full" in results[tx].log for tx in fulls)
    assert mp.size() == cap and mp.gas_entries() == cap
    mp.update(1, oks)
    assert mp.size() == 0 and mp.gas_entries() == 0
    assert mp.check_tx(fulls[0]).code == P.abci.CODE_TYPE_OK
    assert mp.size() == 1 and mp.gas_entries() == 1
    return {"n_ok": len(oks), "n_full": len(fulls),
            "full_logs": sorted({results[tx].log for tx in fulls})}


def checktx_races_update_no_gas_leak(P):
    mp = P.mp.Mempool(P.kv.KVStoreApplication(), max_txs=128,
                      verify_sigs=False)
    stop = threading.Event()

    def committer():
        h = 0
        while not stop.is_set():
            h += 1
            mp.update(h, mp.reap(max_txs=16))

    ct = threading.Thread(target=committer)
    ct.start()
    try:
        _hammer(lambda k: [mp.check_tx(b"race-%d-%d=v" % (k, i))
                           for i in range(200)])
    finally:
        stop.set()
        ct.join()
    mp.update(9999, mp.reap(max_txs=-1))
    assert mp.size() == 0 and mp.gas_entries() == 0
    return {"size": mp.size(), "gas": mp.gas_entries()}


def admission_inflight_bound_under_hammer(P):
    seen_max, lock = [0], threading.Lock()

    class SlowApp(P.kv.KVStoreApplication):
        def __init__(self, adm):
            super().__init__()
            self._adm = adm

        def check_tx(self, req):
            with lock:
                seen_max[0] = max(seen_max[0], self._adm.inflight)
            return super().check_tx(req)

    adm = P.adm.AdmissionController(max_inflight=4, retry_after_ms=123.0)
    mp = P.mp.Mempool(SlowApp(adm), max_txs=4096, verify_sigs=False,
                      admission=adm)
    adm._fill_fn = mp.fill_fraction
    responses = []

    def submit(k):
        mine = [mp.check_tx(b"adm-%d-%d=v" % (k, i)) for i in range(100)]
        with lock:
            responses.extend(mine)

    _hammer(submit)
    assert seen_max[0] <= 4
    rejected = [r for r in responses
                if r.code == P.abci.CODE_TYPE_OVERLOADED]
    for r in rejected:
        assert "retry_after_ms=123.0" in r.log, r
    st = adm.stats()
    assert st["inflight"] == 0
    assert st["counts"]["admitted"] == len(responses) - len(rejected)
    assert mp.size() == len(responses) - len(rejected)
    assert {r.code for r in responses} <= {0, P.abci.CODE_TYPE_OVERLOADED}
    return {"limits": {k: st[k] for k in ("max_inflight",
                                          "breaker_inflight",
                                          "high_watermark",
                                          "low_watermark")}}


def update_recheck_drops_invalidated_txs(P):
    class FlagApp(P.kv.KVStoreApplication):
        def __init__(self):
            super().__init__()
            self.reject = set()

        def check_tx(self, req):
            if req.tx in self.reject:
                return P.abci.ResponseCheckTx(code=9, log="stale")
            return super().check_tx(req)

    out = {}
    for flag in (True, False):
        app = FlagApp()
        mp = P.mp.Mempool(app, max_txs=64, verify_sigs=False, recheck=flag)
        txs = [b"rc-%d=v" % i for i in range(8)]
        for tx in txs:
            assert mp.check_tx(tx).code == P.abci.CODE_TYPE_OK
        app.reject = set(txs[3::2])
        mp.update(1, txs[:2])
        survivors = mp.reap()
        if flag:
            assert set(survivors) == set(txs[2:]) - app.reject
            app.reject = set()
            assert mp.check_tx(txs[3]).code == P.abci.CODE_TYPE_OK
        else:
            assert set(survivors) == set(txs[2:])
        assert mp.gas_entries() == mp.size()
        out[flag] = {"survivors": survivors, "pool": mp.reap()}
    return out


@pytest.mark.parametrize("scenario", [
    duplicate_tx_admitted_once, full_pool_drop_and_uncache,
    checktx_races_update_no_gas_leak, admission_inflight_bound_under_hammer,
    update_recheck_drops_invalidated_txs], ids=lambda f: f.__name__)
def test_mempool_scenario_matches_the_jax_mempool(scenario):
    out = {name: scenario(P) for name, P in PACKAGES.items()}
    assert out["port"] == out["jax"]


# -- the three scenarios through a plane's BULK lane ------------------------


def oracle_txs(P):
    """Per thread: valid envelopes, corrupted signatures, short frames
    and unsigned txs, with the code each must get."""
    privs = [P.keys.PrivKey.generate(bytes([40 + k]) * 32)
             for k in range(N_THREADS)]
    expected, per_thread = {}, []
    for k in range(N_THREADS):
        txs = []
        for i in range(ORACLE_TXS):
            payload = b"oracle-%d-%d=v" % (k, i)
            kind = i % 4
            if kind == 0:
                tx, code = P.sigtx.wrap(privs[k], payload), 0
            elif kind == 1:
                bad = bytearray(P.sigtx.wrap(privs[k], payload))
                bad[len(P.sigtx.MAGIC) + P.sigtx.PUB_LEN] ^= 0xFF
                tx, code = bytes(bad), P.abci.CODE_TYPE_BAD_SIGNATURE
            elif kind == 2:
                tx, code = P.sigtx.MAGIC + payload, \
                    P.abci.CODE_TYPE_BAD_SIGNATURE
            else:
                tx, code = payload, 0
            txs.append(tx)
            expected[tx] = code
        per_thread.append(txs)
    return expected, per_thread


def plane_routed_verify_matches_host_oracle(P, plane_kw):
    expected, per_thread = oracle_txs(P)
    got, lock = {}, threading.Lock()
    # a long BULK window lets the eight blocked threads share a flush
    with mounted_plane(P, window_ms=0.5, bulk_window_ms=50.0,
                       **plane_kw) as plane:
        mp = P.mp.Mempool(P.kv.KVStoreApplication(), max_txs=4096,
                          verify_sigs=True)

        def submit(k):
            for tx in per_thread[k]:
                resp = mp.check_tx(tx)
                with lock:
                    got[tx] = (resp.code, resp.log)

        _hammer(submit)
        lane_rows = plane.stats()["lane_rows"]
    assert {tx: c for tx, (c, _) in got.items()} == expected
    n_ok = sum(1 for c in expected.values() if c == 0)
    n_signed = sum(1 for tx in expected
                   if tx.startswith(P.sigtx.MAGIC)
                   and len(tx) >= P.sigtx.HEADER_LEN)
    assert mp.size() == n_ok and mp.gas_entries() == n_ok
    assert lane_rows["bulk"] == n_signed
    return {"got": got, "pool": sorted(mp.reap()), "bulk_rows": n_signed}


def bulk_shed_surfaces_as_overloaded_code(P, plane_kw):
    # the JAX test's 20 txs a thread and 500 ms deadline would keep ~20
    # one-row flushes of the plain kernel queueing behind each other on
    # the device side; a 200 ms deadline (still past the 60 ms window)
    # sheds the rows that wait behind a flush in flight
    with mounted_plane(P, window_ms=60.0, bulk_window_ms=60.0,
                       bulk_max_queue=1, bulk_deadline_ms=200.0,
                       **plane_kw) as plane:
        mp = P.mp.Mempool(P.kv.KVStoreApplication(), max_txs=4096,
                          verify_sigs=True)
        priv = P.keys.PrivKey.generate(b"\x51" * 32)
        txs = [P.sigtx.wrap(priv, b"shed-%d-%d=v" % (k, i))
               for k in range(N_THREADS) for i in range(10)]
        responses, lock = {}, threading.Lock()

        def submit(k):
            for tx in txs[k::N_THREADS]:
                resp = mp.check_tx(tx)
                with lock:
                    responses[tx] = resp

        _hammer(submit)
        shed = [r for r in responses.values()
                if r.code == P.abci.CODE_TYPE_OVERLOADED]
        ok = [r for r in responses.values() if r.code == 0]
        assert len(shed) + len(ok) == len(txs)
        assert shed and ok
        for r in shed:
            assert "retry_after_ms=" in r.log and r.retry_after_ms > 0, r
        stats = plane.stats()
        assert stats["sheds"]["bulk"] >= len(shed)
        assert stats["sheds"]["consensus"] == 0
        shed_tx = next(tx for tx, r in responses.items()
                       if r.code == P.abci.CODE_TYPE_OVERLOADED)
        retry = mp.check_tx(shed_tx)
        assert retry.code == 0, retry
    assert mp.size() == len(ok) + 1
    return {"codes": sorted({r.code for r in responses.values()}),
            "hints": sorted({r.retry_after_ms for r in shed}),
            "retry": retry.code}


def deadline_shed_surfaces_as_overloaded_code(P, plane_kw):
    with mounted_plane(P, window_ms=0.5, bulk_window_ms=150.0,
                       bulk_max_queue=100_000, bulk_deadline_ms=5.0,
                       **plane_kw) as plane:
        mp = P.mp.Mempool(P.kv.KVStoreApplication(), max_txs=4096,
                          verify_sigs=True)
        priv = P.keys.PrivKey.generate(b"\x52" * 32)
        responses, lock = [], threading.Lock()

        def submit(k):
            mine = [mp.check_tx(P.sigtx.wrap(priv, b"dl-%d-%d=v" % (k, i)))
                    for i in range(6)]
            with lock:
                responses.extend(mine)

        _hammer(submit)
        codes = {r.code for r in responses}
        assert codes <= {0, P.abci.CODE_TYPE_OVERLOADED}, codes
        shed = [r for r in responses
                if r.code == P.abci.CODE_TYPE_OVERLOADED]
        assert shed
        for r in shed:
            assert "retry_after_ms=" in r.log, r
        assert plane.stats()["sheds"]["bulk"] >= len(shed)
    return {"hints": sorted({r.retry_after_ms for r in shed}),
            "logs": sorted({r.log for r in shed})}


@pytest.mark.parametrize("side", list(PLANE_SIDES))
@pytest.mark.parametrize("scenario", [
    plane_routed_verify_matches_host_oracle,
    bulk_shed_surfaces_as_overloaded_code,
    deadline_shed_surfaces_as_overloaded_code], ids=lambda f: f.__name__)
def test_bulk_lane_scenario_matches_the_jax_mempool(scenario, side):
    """The scenario on `side`'s plane gives the JAX host plane's outcome."""
    P, kw = PLANE_SIDES[side]
    got = scenario(P, kw)
    if side != "jax":
        assert got == scenario(JAX, {"use_device": False})


# -- ROADMAP C1: the mempool's seam ------------------------------------------


@pytest.fixture
def spy_direct(monkeypatch):
    """verify_batch_direct calls as (rows, device)."""
    seen = []
    real = pbatch.verify_batch_direct

    def spy(pubs, msgs, sigs, device=None, **kw):
        seen.append((len(pubs), None if device is None else str(device)))
        return real(pubs, msgs, sigs, device=device, **kw)

    monkeypatch.setattr(pbatch, "verify_batch_direct", spy)
    return seen


@pytest.fixture
def own_breaker(monkeypatch):
    """A fresh process-wide device breaker, so the card's absence here
    (a DeviceError recorded as a fault) trips nothing other tests use."""
    brk = pbatch.CircuitBreaker(name="test-mempool-global")
    monkeypatch.setattr(pbatch, "_DEVICE_BREAKER", brk)
    return brk


def _signed(P, tag, payload=b"c1=v"):
    return P.sigtx.wrap(P.keys.PrivKey.generate(bytes([tag]) * 32), payload)


def test_a_flush_fault_on_a_device_plane_is_answered_on_its_device(
        spy_direct, own_breaker):
    """verifyplane.dispatch raises once: the JAX host plane answers the
    flush from the host; the port's device plane fails it with
    DeviceError, and the mempool verifies the row with
    verify_batch_direct on the plane's device. The codes are equal."""
    out = {}
    for name, (P, kw) in (("jax", PLANE_SIDES["jax"]),
                          ("port", PLANE_SIDES["port_device"])):
        good, bad = _signed(P, 0x61), bytearray(_signed(P, 0x62, b"x=1"))
        bad[len(P.sigtx.MAGIC) + P.sigtx.PUB_LEN] ^= 0x01
        codes = []
        with mounted_plane(P, window_ms=0.5, **kw) as plane:
            mp = P.mp.Mempool(P.kv.KVStoreApplication(), verify_sigs=True)
            for tx in (good, bytes(bad)):
                P.fp.arm("verifyplane.dispatch", "raise", count=1)
                try:
                    codes.append(mp.check_tx(tx).code)
                finally:
                    P.fp.reset()
            recs = plane.ledger.records()
        out[name] = (codes, mp.reap())
        if name == "port":
            assert [r["path"] for r in recs[-2:]] == ["device_fault"] * 2
            assert plane.rows_verified == 0
    assert out["port"] == out["jax"]
    assert out["port"][0] == [0, pabci.CODE_TYPE_BAD_SIGNATURE]
    assert spy_direct == [(1, "cpu"), (1, "cpu")]
    assert own_breaker.faults == 0


def test_a_device_plane_that_cannot_take_the_row_keeps_it_on_its_device(
        spy_direct, own_breaker):
    """A plane that stops under the submission (PlaneStopped) answers on
    its device for a device plane, on the host for a host plane."""
    for kw, want in (({"device": "cpu"}, [(1, "cpu")]),
                     ({"use_device": False}, [])):
        spy_direct.clear()
        with mounted_plane(PORT, window_ms=0.5, **kw) as plane:
            def refuse(*a, **k):
                raise pvp.PlaneStopped("verify plane stopped")

            plane.submit_many = refuse
            mp = pmp.Mempool(pkv.KVStoreApplication(), verify_sigs=True)
            assert mp.check_tx(_signed(PORT, 0x63)).code == 0
        assert spy_direct == want


def test_a_device_error_leaves_check_tx_and_the_tx_leaves_the_cache(
        own_breaker, monkeypatch):
    """The flush faults and so does the device pass after it: the
    DeviceError reaches the caller, the tx is not left in the dedup
    cache, admission is released, and once the device answers again the
    same tx is checked (not "tx already in cache")."""
    tx = _signed(PORT, 0x64)
    adm = padm.AdmissionController(max_inflight=2)
    real, dead = pbatch.verify_batch_direct, [True]

    def direct(*a, **k):
        if dead[0]:
            raise DeviceError("the device is gone")
        return real(*a, **k)

    monkeypatch.setattr(pbatch, "verify_batch_direct", direct)
    with mounted_plane(PORT, window_ms=0.5, device="cpu"):
        mp = pmp.Mempool(pkv.KVStoreApplication(), verify_sigs=True,
                         admission=adm)
        pfp.arm("verifyplane.dispatch", "raise", count=1)
        try:
            with pytest.raises(DeviceError):
                mp.check_tx(tx)
        finally:
            pfp.reset()
        assert tx not in mp._cache and mp.size() == 0
        assert adm.inflight == 0
        dead[0] = False
        assert mp.check_tx(tx).code == 0
    assert mp.reap() == [tx]


def test_with_no_plane_a_signed_tx_goes_to_the_card(own_breaker):
    """No plane: the JAX mempool verifies on the host; the port's on the
    card, which raises DeviceError without one (the tx leaves the cache).
    An unsigned tx needs no verification and still reaches the app."""
    assert pvp.global_plane() is None
    mp = pmp.Mempool(pkv.KVStoreApplication(), verify_sigs=True)
    tx = _signed(PORT, 0x65)
    if torch.cuda.is_available():
        assert mp.check_tx(tx).code == 0
        return
    with pytest.raises(DeviceError):
        mp.check_tx(tx)
    assert tx not in mp._cache
    assert mp.check_tx(b"plain=1").code == 0
    assert mp.reap() == [b"plain=1"]
    jm = jmp.Mempool(jkv.KVStoreApplication(), verify_sigs=True)
    assert jm.check_tx(_signed(JAX, 0x65)).code == 0
