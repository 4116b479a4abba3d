"""The port's verify plane (cometbft_tpu_torch/verifyplane) against the JAX
package's, on one seeded precommit stream of a 24-validator set:

  (a) plan differential: the JAX `plan_fused` (its CPU gate lifted with
      monkeypatch; no JAX kernel runs) and the port's stage byte-identical
      `dsig`/`dts`/`dflags` (device-stamped branch) or `rows` (host-packed
      branch, by the stamping toggle or by an extension row), with equal
      positions, thresholds, groups and counted columns;
  (b) plane differential: the stream through the JAX plane (its host path
      on the CPU), the port's plane with use_device=False (the same host
      path) and with device="cpu" (the fused path, plan -> dispatch ->
      collect on the kernels' plain versions): equal verdicts, group
      tallies and quorum bits, the ledger paths the JAX plane's;
  (c) a faulting flush: an injected kernel that raises. The JAX plane
      answers with host verdicts on the grouped path; the port's device
      plane fails the flush's futures with DeviceError on its
      `device_fault` path (ROADMAP C1, the deliberate divergence: a device
      plane never verifies on the host). The two breakers count the same
      faults and trips;

and six of the JAX package's plane scenarios (tests/test_verify_plane.py:
an open breaker, backpressure, stop's drain and leftovers, the group
tally, a BULK shed) on both planes with equal outcomes, the open breaker
with C1's divergence; plus the port's own seams: the in-flight fault (the
`verifyplane.collect` failpoint) and the dispatch failpoint failing a
device flush with DeviceError, stop's drain on the device, the mesh
knobs and seams (no mesh without device slots; tests/test_torch_mesh.py
and tests/test_torch_shardplane.py drive the meshes), the plane's device
resolution, and crypto.batch's routing through a running plane.
The CUDA side (event readiness, an in-flight fault on the card) is in
tests/test_torch_cuda.py (-k plane)."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import vote as jvote
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.verifyplane import fused as jfz
from cometbft_tpu.verifyplane import plane as jvp
from cometbft_tpu_torch import device as pdevice
from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.libs import failpoints as pfp
from cometbft_tpu_torch.libs import staging as pstaging
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.types import canonical as pcanon
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.verifyplane import fused as pfz
from cometbft_tpu_torch.verifyplane import plane as pvp

torch.set_num_threads(1)

CHAIN = "plane-diff"
HEIGHT = 77
N_VALS = 24
TAMPERED = 5          # its signature has a flipped bit
NOT_COUNTED = 7       # submitted with counted=False
EXTENDED = 3          # the extension stream: vote + extension rows

JAX = SimpleNamespace(vp=jvp, fz=jfz, keys=jkeys, canon=jcanon,
                      vote=jvote, BlockID=JBlockID, PSH=JPSH,
                      batch=jbatch)
PORT = SimpleNamespace(vp=pvp, fz=pfz, keys=pkeys, canon=pcanon,
                       vote=pvote, BlockID=BlockID, PSH=PartSetHeader,
                       batch=pbatch)


def _fixture():
    rng = np.random.default_rng(1414)
    privs = [jkeys.PrivKey.generate(rng.bytes(32)) for _ in range(N_VALS)]
    # validators 0-17 precommit block A with most of the power (A reaches
    # quorum without the tampered and the uncounted vote), 18-21 block B,
    # 22-23 nil
    powers = tuple(int(p) for p in np.concatenate([
        rng.integers(500, 1000, 18), rng.integers(1, 100, N_VALS - 18)]))
    bids = [(rng.bytes(32), rng.bytes(32)) for _ in range(2)]
    target = [0] * 18 + [1] * 4 + [None] * 2
    secs = [1_700_000_000 + int(s) for s in rng.integers(0, 2**20, N_VALS)]
    nanos = [int(n) for n in rng.integers(0, 10**9, N_VALS)]
    secs[0], nanos[0] = 0, 0          # both timestamp fields skipped
    secs[1], nanos[1] = -2**33, 127   # a 10-byte negative varint
    return SimpleNamespace(privs=privs, powers=powers, bids=bids,
                           target=target, secs=secs, nanos=nanos)


FIX = _fixture()


def stream(P, extension: bool = False):
    """(submissions as submit_many kwargs, {group name: group}) of the
    fixture's precommits in package P's types: one counted submission a
    validator, grouped per block as VoteSet groups them, with the device
    stamp metadata VoteSet attaches. `extension` adds validator EXTENDED's
    extension row (stamp None, so its flush packs on the host)."""
    pubs = tuple(p.pub_key().data for p in FIX.privs)
    total = sum(FIX.powers)
    tpls, groups = {}, {}
    for key in (0, 1, None):
        bid = None if key is None else P.BlockID(
            FIX.bids[key][0], P.PSH(1, FIX.bids[key][1]))
        tpls[key] = P.vote.sign_bytes_template(
            CHAIN, P.canon.PRECOMMIT_TYPE, HEIGHT, 0, bid)
        name = f"h{HEIGHT}/{'nil' if key is None else key}"
        groups[key] = P.vp.QuorumGroup(total * 2 // 3 + 1, name,
                                       valset_pubs=pubs,
                                       valset_powers=FIX.powers)
    subs = []
    for v, priv in enumerate(FIX.privs):
        key = FIX.target[v]
        msg = tpls[key].patch_rows([FIX.secs[v]], [FIX.nanos[v]]).row(0)
        sig = priv.sign(msg)
        if v == TAMPERED:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        pub = P.keys.PubKey(pubs[v])
        rows = [(pub, msg, sig)]
        vidx = [v]
        stamp = [(tpls[key], FIX.secs[v], FIX.nanos[v])]
        if extension and v == EXTENDED:
            ext = b"extension-%d" % v
            rows.append((pub, ext, priv.sign(ext)))
            vidx.append(v)
            stamp.append(None)
        subs.append(dict(rows=rows, power=FIX.powers[v], group=groups[key],
                         counted=v != NOT_COUNTED, vidx=vidx, stamp=stamp))
    return subs, {g.name: g for g in groups.values()}


def oracle(subs):
    return [tuple(ed.verify(p.data, m, s) for p, m, s in sub["rows"])
            for sub in subs]


def want_tallies(subs, verdicts):
    out = {}
    for sub, v in zip(subs, verdicts):
        name = sub["group"].name
        out.setdefault(name, 0)
        if sub["counted"] and all(v):
            out[name] += sub["power"]
    return out


# ---------------------------------------------------------------------------
# (a) the plan differential
# ---------------------------------------------------------------------------


def _plan(P, subs, pool, **kw):
    batch = [P.vp._Submission(s["rows"], s["group"], s["power"],
                              s["counted"], s["vidx"], stamp=s["stamp"])
             for s in subs]
    return P.fz.plan_fused(batch, pool=pool, **kw)


@pytest.mark.parametrize("branch", ["device", "host_toggle",
                                    "host_extension"])
def test_plan_fused_stages_the_jax_bytes(branch, monkeypatch):
    monkeypatch.setattr(jfz, "ALLOW_CPU_FUSED", True)
    stamping = branch != "host_toggle"
    monkeypatch.setattr(jfz, "DEVICE_STAMP", stamping)
    monkeypatch.setattr(pfz, "DEVICE_STAMP", stamping)
    extension = branch == "host_extension"
    jsubs, _ = stream(JAX, extension)
    psubs, _ = stream(PORT, extension)
    from cometbft_tpu.libs.staging import StagingPool as JPool

    jp = _plan(JAX, jsubs, JPool(slots=2))
    pp = _plan(PORT, psubs, pstaging.StagingPool(slots=2), device="cpu")
    assert jp is not None and pp is not None
    assert pp.stamped == jp.stamped == (branch == "device")
    np.testing.assert_array_equal(pp.pos, jp.pos)
    np.testing.assert_array_equal(pp.thresh, jp.thresh)
    assert pp.n_commits == jp.n_commits == 3
    assert pp.sub_gid == jp.sub_gid
    assert pp.counted_pos == jp.counted_pos
    assert [g.name for g in pp.groups] == [g.name for g in jp.groups]
    assert (pp.delta_bytes, pp.util, pp.n_dev) == (
        jp.delta_bytes, jp.util, jp.n_dev)
    assert pfz.plan_h2d_bytes(pp) == jfz.plan_h2d_bytes(jp)
    if pp.stamped:
        for got, want in zip(pp.delta, jp.delta):
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes()
        assert [s.key for s in pp.sites] == [s.key for s in jp.sites]
        assert pp.rows is None and jp.rows is None
    else:
        assert pp.rows.dtype == jp.rows.dtype
        assert pp.rows.tobytes() == jp.rows.tobytes()
        if extension:  # the extension row takes a second stride
            assert pp.rows.shape[1] == 2 * ec.table_pad(N_VALS)


def test_plan_fused_refuses_what_the_jax_plan_refuses(monkeypatch):
    """Ineligible flushes (no valset backing, a wrong key claim, a power
    that disagrees with the table) stage nothing on either side."""
    monkeypatch.setattr(jfz, "ALLOW_CPU_FUSED", True)
    for mutate in ("no_vidx", "wrong_slot", "power"):
        out = []
        for P in (JAX, PORT):
            subs, _ = stream(P)
            s = subs[2]
            if mutate == "no_vidx":
                s["vidx"] = None
            elif mutate == "wrong_slot":
                s["vidx"] = [4]
            else:
                s["power"] += 1
            kw = {"device": "cpu"} if P is PORT else {}
            out.append(_plan(P, subs, None, **kw))
        assert out == [None, None], mutate


def test_slot_specs_and_layout_replicas_match_the_jax_package():
    for B in (128, 16384):
        assert pfz.delta_slot_specs(B) == jfz.delta_slot_specs(B)
        for c in (1, 3, 5000):
            assert pfz.legacy_slot_specs(B, c) == jfz.legacy_slot_specs(B, c)
            assert pfz.specs_bytes(pfz.legacy_slot_specs(B, c)) == \
                jfz.specs_bytes(jfz.legacy_slot_specs(B, c))
    assert pfz._V_THRESH_REPLICA == ec.V_THRESH
    assert pfz._TALLY_LIMBS_REPLICA == ek.TALLY_LIMBS
    assert pfz.MAX_FUSED_ROWS == jfz.MAX_FUSED_ROWS


def test_no_mesh_until_the_multi_device_slice(monkeypatch):
    """The port's plan has the JAX package's mesh seams (plane_mesh,
    half_meshes, effective_mesh, shard_positions) and plan_fused's mesh,
    half and half_max_rows arguments; without device slots
    (CBT_TORCH_DEVICE_SLOTS unset) a CPU device resolves no mesh and the
    plan stays on one device, its stride the padded table size."""
    import inspect

    from cometbft_tpu_torch.parallel import mesh as pm

    monkeypatch.delenv(pm.SLOTS_ENV, raising=False)
    for name in ("plane_mesh", "half_meshes", "effective_mesh",
                 "shard_positions"):
        assert hasattr(jfz, name) and hasattr(pfz, name), name
    jargs = inspect.signature(jfz.plan_fused).parameters
    pargs = inspect.signature(pfz.plan_fused).parameters
    for name in ("mesh", "half", "half_max_rows"):
        assert pargs[name].default == jargs[name].default, name
    for n in (1, 24, 10_000):
        assert pfz.effective_mesh(None, n) == jfz.effective_mesh(None, n)
    assert pfz.plane_mesh(0, "cpu") is None
    assert pfz.half_meshes(None) == jfz.half_meshes(None) == []
    subs, _ = stream(PORT)
    plan = _plan(PORT, subs, None, device="cpu")
    assert plan.n_dev == 1 and plan.devs is None and plan.mesh is None
    assert not plan.drain_first
    assert plan.delta[0].shape[0] == ec.table_pad(N_VALS)


# ---------------------------------------------------------------------------
# (b) the plane differential
# ---------------------------------------------------------------------------


def _drive(plane, waves):
    """Submit each wave while holding the plane's condition (so the wave is
    one flush), wait for its verdicts, then the next wave. Returns the
    verdicts in submission order."""
    out = []
    plane.start()
    try:
        for subs in waves:
            with plane._cv:
                futs = [plane.submit_many(**s) for s in subs]
            out += [_result(f) for f in futs]
    finally:
        plane.stop()
    return out


def _result(fut):
    """A future's verdicts, or "DeviceError" when its flush faulted on
    the device."""
    try:
        return fut.result(120.0)
    except pdevice.DeviceError:
        return "DeviceError"


def _waves(P):
    """Wave 1: the plain precommit stream; wave 2: the same votes again,
    with validator EXTENDED's extension row, in fresh groups."""
    w1, g1 = stream(P)
    w2, g2 = stream(P, extension=True)
    return [w1, w2], [g1, g2]


def _outcome(plane, waves, groups):
    verdicts = _drive(plane, waves)
    return dict(
        verdicts=verdicts,
        tallies=[{n: g.tally for n, g in gs.items()} for gs in groups],
        quorum=[{n: g.quorum_reached for n, g in gs.items()}
                for gs in groups],
        paths=[r["path"] for r in plane.ledger.records()],
        stamps=[r["stamp"] for r in plane.ledger.records()],
        warm=[r["warm"] for r in plane.ledger.records()])


@pytest.fixture(scope="module")
def jax_outcome():
    waves, groups = _waves(JAX)
    plane = jvp.VerifyPlane(window_ms=1.0, max_batch=4096,
                            breaker=jbatch.CircuitBreaker())
    assert not plane.stats()["use_device"]  # the CPU host path
    return _outcome(plane, waves, groups), waves


def test_host_plane_equals_the_jax_plane(jax_outcome):
    want, jwaves = jax_outcome
    waves, groups = _waves(PORT)
    got = _outcome(pvp.VerifyPlane(window_ms=1.0, max_batch=4096,
                                   use_device=False,
                                   breaker=pbatch.CircuitBreaker()),
                   waves, groups)
    assert got == want
    assert want["paths"] == ["host", "host"]
    flat = [s for w in jwaves for s in w]
    assert want["verdicts"] == oracle(flat)
    assert want["tallies"] == [want_tallies(w, oracle(w)) for w in jwaves]
    thr = sum(FIX.powers) * 2 // 3 + 1
    assert want["quorum"] == [{n: t >= thr for n, t in ts.items()}
                              for ts in want["tallies"]]
    assert want["quorum"][0] == {f"h{HEIGHT}/0": True,
                                 f"h{HEIGHT}/1": False,
                                 f"h{HEIGHT}/nil": False}


@pytest.mark.parametrize("flights", [1, 2])
def test_fused_plane_on_the_plain_kernels_equals_the_jax_plane(
        jax_outcome, flights):
    want, _ = jax_outcome
    waves, groups = _waves(PORT)
    brk = pbatch.CircuitBreaker()
    plane = pvp.VerifyPlane(window_ms=1.0, max_batch=4096, device="cpu",
                            breaker=brk, pipeline_flights=flights)
    got = _outcome(plane, waves, groups)
    for k in ("verdicts", "tallies", "quorum"):
        assert got[k] == want[k], k
    assert got["paths"] == ["fused", "fused"]
    # wave 1 ships deltas; wave 2's extension row has no template
    assert got["stamps"] == ["device", "host"]
    assert got["warm"][1] == 1
    assert brk.faults == 0 and brk.state == "closed"
    led = plane.dump_flushes()["summary"]
    assert led["device"]["fused_flushes"] == 2
    assert led["stamp"]["delta_bytes"] == pfz.specs_bytes(
        pfz.delta_slot_specs(ec.table_pad(N_VALS)))


# ---------------------------------------------------------------------------
# (c) a faulting flush: the grouped path (ROADMAP C1)
# ---------------------------------------------------------------------------


class CountingJaxBreaker(jbatch.CircuitBreaker):
    """The JAX breaker keeps no total of faults; count them here."""

    def __init__(self):
        super().__init__()
        self.faults = 0

    def record_failure(self):
        self.faults += 1
        super().record_failure()


def _raising(*args, **kw):
    raise RuntimeError("injected device fault")


def test_a_faulting_flush_gives_the_jax_verdicts_and_breaker_counts():
    """Three ungrouped flushes through an injected ed25519 kernel that
    raises: the first two fault (the second trips the breaker), the third
    finds the breaker open. The JAX plane answers with the oracle's
    verdicts on the grouped path; the port's device plane fails every
    flush's futures with DeviceError on the device_fault path (C1's
    divergence). Their breakers agree."""
    out = []
    for P, brk, kw in ((JAX, CountingJaxBreaker(), {}),
                       (PORT, pbatch.CircuitBreaker(), {"device": "cpu"})):
        subs, _ = stream(P)
        flat = [dict(rows=s["rows"]) for s in subs]
        plane = P.vp.VerifyPlane(window_ms=1.0, max_batch=4096,
                                 kernels={"ed25519": _raising},
                                 breaker=brk, **kw)
        verdicts = _drive(plane, [flat[:8], flat[8:16], flat[16:]])
        out.append(dict(verdicts=verdicts,
                        paths=[r["path"] for r in plane.ledger.records()],
                        faults=brk.faults, trips=brk.trips,
                        state=brk.state))
    jax, port = out
    assert jax["verdicts"] == oracle(stream(PORT)[0])
    assert jax["paths"] == ["grouped"] * 3
    assert port["verdicts"] == ["DeviceError"] * N_VALS
    assert port["paths"] == ["device_fault"] * 3
    assert (jax["faults"], jax["trips"], jax["state"]) == (
        port["faults"], port["trips"], port["state"]) == (2, 1, "open")


def test_a_grouped_flush_that_succeeds_records_success():
    calls = []

    def kernel(pubs, msgs, sigs, device=None):
        calls.append((len(pubs), device))
        return np.asarray([ed.verify(p, m, s)
                           for p, m, s in zip(pubs, msgs, sigs)])

    brk = pbatch.CircuitBreaker()
    subs, _ = stream(PORT)
    plane = pvp.VerifyPlane(window_ms=1.0, kernels={"ed25519": kernel},
                            breaker=brk, device="cpu")
    got = _drive(plane, [[dict(rows=s["rows"]) for s in subs]])
    assert got == oracle(subs)
    assert calls == [(N_VALS, torch.device("cpu"))]
    assert brk.faults == 0


# ---------------------------------------------------------------------------
# the port's own seams
# ---------------------------------------------------------------------------


def test_an_in_flight_fault_lands_on_the_fused_host_fallback():
    """The fused flush dispatches, then its fetch faults (the
    `verifyplane.collect` failpoint, as a CUDA error surfaces at the
    copy): where the JAX plane falls back to the host, the port's fails
    the flush's futures with DeviceError, tallies nothing and counts one
    fault; the next flush is fused with the oracle's verdicts."""
    subs, groups = stream(PORT)
    again, groups2 = stream(PORT)
    brk = pbatch.CircuitBreaker()
    plane = pvp.VerifyPlane(window_ms=1.0, max_batch=4096, device="cpu",
                            breaker=brk)
    pfp.arm("verifyplane.collect", "raise", count=1)
    try:
        got = _drive(plane, [subs, again])
    finally:
        pfp.reset()
    recs = plane.ledger.records()
    assert [r["path"] for r in recs] == ["device_fault", "fused"]
    assert got[:N_VALS] == ["DeviceError"] * N_VALS
    assert got[N_VALS:] == oracle(again)
    assert {n: g.tally for n, g in groups.items()} == {
        n: 0 for n in groups}
    assert {n: g.tally for n, g in groups2.items()} == \
        want_tallies(again, got[N_VALS:])
    assert brk.faults == 1 and brk.state == "closed"
    summary = plane.dump_flushes()["summary"]
    assert (summary["device_faults"], summary["host_fallback"]) == (1, 0)


def test_a_dispatch_failpoint_fails_a_device_flush():
    """The `verifyplane.dispatch` failpoint degrades a host plane's
    flush to the inline host path (tests/test_torch_libs.py); on a device
    plane it fails the flush's futures with DeviceError, off the
    breaker."""
    subs, groups = stream(PORT)
    brk = pbatch.CircuitBreaker()
    plane = pvp.VerifyPlane(window_ms=1.0, max_batch=4096, device="cpu",
                            breaker=brk)
    pfp.arm("verifyplane.dispatch", "raise", count=1)
    try:
        got = _drive(plane, [subs])
    finally:
        pfp.reset()
    assert got == ["DeviceError"] * N_VALS
    assert [r["path"] for r in plane.ledger.records()] == ["device_fault"]
    assert {g.tally for g in groups.values()} == {0}
    assert brk.faults == 0


@pytest.mark.parametrize("kernel", ["verifies", "raises"])
def test_stop_drains_a_device_plane_on_the_device(kernel):
    """Leftovers of a device plane whose dispatcher never ran are
    verified by stop() on the device (the grouped pass), not on the host;
    a fault there fails them with DeviceError."""
    calls = []

    def verify(pubs, msgs, sigs, device=None):
        calls.append((len(pubs), device))
        if kernel == "raises":
            raise RuntimeError("injected device fault")
        return np.asarray([ed.verify(p, m, s)
                           for p, m, s in zip(pubs, msgs, sigs)])

    subs, _ = stream(PORT)
    brk = pbatch.CircuitBreaker()
    plane = pvp.VerifyPlane(window_ms=1.0, device="cpu", breaker=brk,
                            kernels={"ed25519": verify})
    plane._running = True  # a running plane whose dispatcher never existed
    futs = [plane.submit_many(rows=s["rows"]) for s in subs]
    plane.stop()
    got = [_result(f) for f in futs]
    assert calls == [(N_VALS, torch.device("cpu"))]
    path, = [r["path"] for r in plane.ledger.records()]
    if kernel == "verifies":
        assert (got, path, brk.faults) == (oracle(subs), "stop_drain", 0)
    else:
        assert (got, path, brk.faults) == (
            ["DeviceError"] * N_VALS, "device_fault", 1)


def test_a_device_fault_reaches_crypto_batch_callers_as_device_error():
    """A default verify_batch call routed through a running device plane
    whose flush faults raises DeviceError, as verify_batch_direct does: it
    is not a PlaneError, so the call does not go direct behind the
    fault."""
    subs, _ = stream(PORT)
    pubs, msgs, sigs = zip(*[r for s in subs for r in s["rows"]])
    plane = pvp.VerifyPlane(window_ms=1.0, device="cpu",
                            breaker=pbatch.CircuitBreaker(),
                            kernels={"ed25519": _raising})
    plane.start()
    pvp.set_global_plane(plane)
    try:
        with pytest.raises(pdevice.DeviceError) as e:
            pbatch.verify_batch(pubs, msgs, sigs)
    finally:
        pvp.set_global_plane(None)
        plane.stop()
    assert not isinstance(e.value, pvp.PlaneError)
    assert isinstance(e.value.__cause__, RuntimeError)


def test_a_plane_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pdevice.DeviceError):
        pvp.VerifyPlane()
    with pytest.raises(pdevice.DeviceError):
        pvp.VerifyPlane(kernels={"ed25519": _raising})
    assert pvp.VerifyPlane(use_device=False).device is None
    assert pvp.VerifyPlane(device="cpu").device == torch.device("cpu")


def test_plan_readiness_and_device_time_on_the_cpu():
    subs, _ = stream(PORT)
    plan = _plan(PORT, subs, None, device="cpu")
    assert plan.device == torch.device("cpu")
    assert pfz.plan_ready(plan)          # nothing dispatched yet
    pfz.dispatch_fused(plan)
    assert plan.event is None and pfz.plan_ready(plan)
    assert pfz.plan_device_ms(plan) is None
    verdicts, tallies = pfz.collect_fused(plan)
    assert verdicts == [v for t in oracle(subs) for v in t]
    assert {g.name: t for g, t in tallies.items()} == \
        want_tallies(subs, oracle(subs))


def test_a_mesh_configured_plane_stays_on_one_device(monkeypatch):
    """The JAX plane's mesh knobs with its defaults; without device slots
    a plane asked for every slot (mesh_devices=0) resolves no mesh and
    flushes on its one device, and its stats carry the JAX plane's keys."""
    import inspect

    from cometbft_tpu_torch.parallel import mesh as pm

    monkeypatch.delenv(pm.SLOTS_ENV, raising=False)
    jargs = inspect.signature(jvp.VerifyPlane).parameters
    pargs = inspect.signature(pvp.VerifyPlane).parameters
    for knob in ("mesh_devices", "mesh_min_rows", "half_mesh_rows"):
        assert pargs[knob].default == jargs[knob].default, knob
    subs, _ = stream(PORT)
    plane = pvp.VerifyPlane(window_ms=1.0, max_batch=4096, device="cpu",
                            breaker=pbatch.CircuitBreaker(),
                            mesh_devices=0, mesh_min_rows=1,
                            pipeline_flights=2)
    _drive(plane, [subs])
    rec, = plane.ledger.records()
    assert (rec["path"], rec["n_dev"], rec["dev0"]) == ("fused", 1, 0)
    st = plane.stats()
    assert (st["mesh_ndev"], st["shard_flushes"], st["halves"]) == (0, 0, 0)
    jst = jvp.VerifyPlane(window_ms=1.0).stats()
    assert set(st) == set(jst)


def test_crypto_batch_routes_through_a_running_plane():
    subs, _ = stream(PORT)
    rows = [r for s in subs for r in s["rows"]]
    pubs, msgs, sigs = zip(*rows)
    plane = pvp.VerifyPlane(window_ms=1.0, use_device=False)
    plane.start()
    pvp.set_global_plane(plane)
    try:
        got = pbatch.verify_batch(pubs, msgs, sigs)
        assert plane.rows_verified == len(rows)
        assert pvp.plane_batch_fn()(pubs, msgs, sigs).tolist() == \
            got.tolist()
    finally:
        pvp.set_global_plane(None)
        plane.stop()
    assert got.tolist() == [v for t in oracle(subs) for v in t]
    # pinned calls go direct, and a stopped plane is not routed to
    assert pvp.global_plane() is None
    assert pbatch.verify_batch(pubs, msgs, sigs,
                               device="cpu").tolist() == got.tolist()
    assert isinstance(pbatch.staging_pool(), pstaging.StagingPool)


# ---------------------------------------------------------------------------
# the JAX package's plane scenarios (tests/test_verify_plane.py), both planes
# ---------------------------------------------------------------------------


def _rows(P, n=12, seed=40):
    """n signed rows of package P, every 4th signature corrupted."""
    privs = [jkeys.PrivKey.generate(bytes([seed + i]) * 32)
             for i in range(n)]
    msgs = [b"plane-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    for i in range(0, n, 4):
        sigs[i] = b"\x5a" * 64
    pubs = [P.keys.PubKey(p.pub_key().data) for p in privs]
    return pubs, msgs, sigs


def _fp(P):
    return pfp if P is PORT else __import__(
        "cometbft_tpu.libs.failpoints", fromlist=["x"])


def _host_plane(P, **kw):
    if P is PORT:
        kw.setdefault("use_device", False)
    return P.vp.VerifyPlane(breaker=P.batch.CircuitBreaker(), **kw)


def scenario_breaker_open_falls_back_to_host(P):
    calls = []

    def kernel(pubs, msgs, sigs, **kw):
        calls.append(len(pubs))
        raise RuntimeError("device fault")

    brk = P.batch.CircuitBreaker(failure_threshold=1, cooldown=30.0)
    kw = {"device": "cpu"} if P is PORT else {}
    p = P.vp.VerifyPlane(window_ms=5.0, kernels={"ed25519": kernel},
                         breaker=brk, **kw)
    p.start()
    try:
        pubs, msgs, sigs = _rows(P, 8)
        first = _wait_or_fault(p, pubs, msgs, sigs)
        state = brk.state
        second = _wait_or_fault(p, pubs, msgs, sigs)
    finally:
        p.stop()
    return first, second, state, calls, p.stats()["breaker_state"]


def _wait_or_fault(p, pubs, msgs, sigs):
    try:
        return p.submit_and_wait(pubs, msgs, sigs).tolist()
    except pdevice.DeviceError:
        return "DeviceError"


def _c1(outcome):
    """ROADMAP C1, the one deliberate divergence: where the JAX plane
    answers an open breaker's flush with host verdicts, the port's device
    plane fails it with DeviceError; the breaker and the kernel calls stay
    the JAX plane's."""
    first, second, *rest = outcome
    assert first == second == [i % 4 != 0 for i in range(8)]
    return ("DeviceError", "DeviceError", *rest)


def scenario_queue_overflow_backpressure(P):
    fp = _fp(P)
    p = _host_plane(P, window_ms=1.0, max_batch=1000, max_queue=8)
    p.start()
    try:
        pubs, msgs, sigs = _rows(P, 10)
        fp.arm("verifyplane.dispatch", "delay", arg=1.0, count=1)
        first = p.submit(pubs[9], msgs[9], sigs[9])
        time.sleep(0.2)  # the dispatcher sleeps in the failpoint
        futs = [p.submit(pubs[i], msgs[i], sigs[i], block=False)
                for i in range(8)]
        with pytest.raises(P.vp.PlaneQueueFull):
            p.submit(pubs[8], msgs[8], sigs[8], block=False)
        blocked = p.submit(pubs[8], msgs[8], sigs[8], block=True)
        return ([f.result(10.0) for f in futs], blocked.result(10.0),
                first.result(10.0))
    finally:
        p.stop()
        fp.reset()


def scenario_stop_drains_pending_futures(P):
    p = _host_plane(P, window_ms=10_000.0)
    p.start()
    pubs, msgs, sigs = _rows(P, 2)
    fut = p.submit(pubs[1], msgs[1], sigs[1])
    p.stop()
    with pytest.raises(P.vp.PlaneError):
        p.submit(pubs[0], msgs[0], sigs[0])
    return fut.result(1.0), [r["path"] for r in p.ledger.records()]


def scenario_stop_leftovers_resolve_with_host_verdicts(P):
    p = _host_plane(P, window_ms=1.0)
    p._running = True  # a running plane whose dispatcher never existed
    pubs, msgs, sigs = _rows(P, 6)
    g = P.vp.QuorumGroup(threshold=15)
    futs = [p.submit(pubs[i], msgs[i], sigs[i], power=10, group=g,
                     counted=True) for i in range(6)]
    pending = [f.done() for f in futs]
    p.stop()
    return (pending, [f.result(5.0) for f in futs], g.tally,
            g.quorum_reached, [r["path"] for r in p.ledger.records()])


def scenario_quorum_group_tally_and_retract(P):
    p = _host_plane(P, window_ms=5.0)
    p.start()
    try:
        pubs, msgs, sigs = _rows(P, 8)
        g = P.vp.QuorumGroup(threshold=41)
        futs = [p.submit(pubs[i], msgs[i], sigs[i], power=10, group=g,
                         counted=True) for i in range(8)]
        got = [f.result(10.0) for f in futs]
    finally:
        p.stop()
    r = P.vp.QuorumGroup(threshold=21)
    seen = []
    for op, w in (("add", 10), ("add", 10), ("add", 10), ("retract", 10),
                  ("add", 10)):
        getattr(r, op)(w)
        seen.append((r.tally, r.quorum_reached))
    return got, g.tally, g.quorum_reached, seen


def scenario_bulk_lane_sheds_with_a_retry_hint(P):
    """A full BULK lane answers a non-blocking submission with an explicit
    PlaneOverloaded (never CONSENSUS), with the lane's retry hint."""
    fp = _fp(P)
    p = _host_plane(P, window_ms=1.0, bulk_max_queue=2,
                    bulk_deadline_ms=2000.0)
    p.start()
    try:
        pubs, msgs, sigs = _rows(P, 6)
        fp.arm("verifyplane.dispatch", "delay", arg=1.0, count=1)
        first = p.submit(pubs[5], msgs[5], sigs[5])
        time.sleep(0.2)  # the dispatcher sleeps in the failpoint
        futs = [p.submit(pubs[i], msgs[i], sigs[i], block=False,
                         lane=P.vp.LANE_BULK) for i in range(2)]
        with pytest.raises(P.vp.PlaneOverloaded) as e:
            p.submit(pubs[2], msgs[2], sigs[2], block=False,
                     lane=P.vp.LANE_BULK)
        out = ([f.result(10.0) for f in futs], first.result(10.0),
               e.value.retry_after_ms)
    finally:
        p.stop()
        fp.reset()
    return out, dict(p.sheds), p.stats()["lane_rows"]


PLANE_SCENARIOS = {fn.__name__[len("scenario_"):]: fn for fn in (
    scenario_breaker_open_falls_back_to_host,
    scenario_queue_overflow_backpressure,
    scenario_stop_drains_pending_futures,
    scenario_stop_leftovers_resolve_with_host_verdicts,
    scenario_quorum_group_tally_and_retract,
    scenario_bulk_lane_sheds_with_a_retry_hint)}


DIVERGES = {"breaker_open_falls_back_to_host": _c1}


@pytest.mark.parametrize("name", sorted(PLANE_SCENARIOS))
def test_plane_scenario_matches_the_jax_plane(name):
    fn = PLANE_SCENARIOS[name]
    assert fn(PORT) == DIVERGES.get(name, lambda o: o)(fn(JAX))
