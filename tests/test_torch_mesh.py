"""The port's slot meshes (cometbft_tpu_torch/parallel/mesh.py) against the
JAX package's device meshes (cometbft_tpu/parallel/mesh.py), on the CPU:

  (a) the layout: shard_stride, shard_positions, effective_mesh and
      half_meshes equal the JAX functions' over a grid of validator counts
      and 1-8 slots (JAX on the conftest's 8 forced CPU devices, the port
      on slots of the CPU);
  (b) the sharded tally: JAX `_sharded_tally_step` on 8 devices and the
      port's on 8 CPU slots give equal limbs and quorum bits on inputs
      whose limbs all carry, and the reduce's plain version and its host
      build (csrc/tally_core.cuh `carry_quorum_commit`) equal the JAX
      psum + `_carry_tally` + `quorum_core`;
  (c) the non-slow scenarios of tests/test_mesh.py on both packages: the
      step memo's identity and counters (also under two threads), the
      rows split with a stub verify kernel, the padded tally, the sharded
      fused layout with a stub cached kernel, the clamp of empty shards
      and the short threshold slice;
  (d) every builder on 2-4 CPU slots with the kernels' plain versions,
      against the port's one-device path and the ed25519_ref oracle;
  (e) the sharded table cache's memo counts, and convert
      .sharded_table_from_jax over a JAX ShardedValsetTable.

The slot variable CBT_TORCH_DEVICE_SLOTS is set with monkeypatch where a
test resolves slots through `local_devices`."""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from cometbft_tpu.ops import ed25519_cached as jec
from cometbft_tpu.ops import ed25519_kernel as jek
from cometbft_tpu.ops import ed25519_pallas as jkp
from cometbft_tpu.parallel import mesh as jpm
from cometbft_tpu.verifyplane import fused as jfz
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import table_cache as tc
from cometbft_tpu_torch.parallel import mesh as pm
from cometbft_tpu_torch.verifyplane import fused as pfz

torch.set_num_threads(1)

NVALS_GRID = [1, 128, 300, 1000, 5000, 10_000, 16_384]


def jmesh(n: int = 8):
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jpm.make_mesh(jax.devices()[:n])


def pmesh(n: int = 8):
    return pm.make_mesh(["cpu"] * n)


def _ids(m):
    """A mesh's members as ints: JAX device ids, the port's slot indices
    (None for no mesh)."""
    if m is None:
        return None
    if isinstance(m, pm.Mesh):
        return m.indices
    return tuple(int(d.id) for d in m.devices.flat)


# ---------------------------------------------------------------------------
# (a) the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nvals", NVALS_GRID)
def test_layout_equals_the_jax_layout(nvals):
    rng = np.random.default_rng(nvals)
    for n in range(1, 9):
        assert ec.shard_stride(nvals, n) == jec.shard_stride(nvals, n)
        jm, pmm = jmesh(n), pmesh(n)
        je, pe = jfz.effective_mesh(jm, nvals), pfz.effective_mesh(pmm, nvals)
        assert (_ids(pe[0]), pe[1], pe[2]) == (_ids(je[0]), je[1], je[2])
        jh, ph = jfz.half_meshes(jm), pfz.half_meshes(pmm)
        assert [_ids(h) for h in ph] == [_ids(h) for h in jh]
        for a, b in zip(jh, ph):
            ja, pa = jfz.effective_mesh(a, nvals), pfz.effective_mesh(
                b, nvals)
            assert (_ids(pa[0]), pa[1], pa[2]) == (_ids(ja[0]), ja[1], ja[2])
        m_s, n_strides = pe[2], 3
        v = rng.integers(0, nvals, 64)
        s = rng.integers(0, n_strides, 64)
        np.testing.assert_array_equal(
            pfz.shard_positions(v, s, m_s, n_strides),
            jfz.shard_positions(v, s, m_s, n_strides))
    assert pfz.effective_mesh(None, nvals) == jfz.effective_mesh(None, nvals)


def test_plane_mesh_resolves_slots_only_when_the_variable_is_set(
        monkeypatch):
    monkeypatch.delenv(pm.SLOTS_ENV, raising=False)
    assert pm.local_devices("cpu") == (pm.Slot(0, torch.device("cpu")),)
    assert pfz.plane_mesh(0, "cpu") is None
    monkeypatch.setenv(pm.SLOTS_ENV, "8")
    m = pfz.plane_mesh(0, "cpu")
    assert _ids(m) == _ids(jfz.plane_mesh(0)) == tuple(range(8))
    assert pfz.plane_mesh(0, "cpu") is m  # memoized: identity feeds memos
    assert _ids(pfz.plane_mesh(3, "cpu")) == _ids(jfz.plane_mesh(3))
    assert pfz.plane_mesh(1, "cpu") is None and jfz.plane_mesh(1) is None
    # two slots of one device are two members, keyed by index
    assert pm._mesh_key(m)[:2] == ((0, "cpu"), (1, "cpu"))
    monkeypatch.setenv(pm.SLOTS_ENV, "0")
    with pytest.raises(ValueError):
        pm.local_devices("cpu")


# ---------------------------------------------------------------------------
# (b) the sharded tally and the reduce
# ---------------------------------------------------------------------------


def _carry_inputs(n_dev, C=5, seed=0):
    """Columns whose power limbs are all 2^13 - 1 (every slot's sum and the
    cross-slot sum carry), random validity, counted bits and commits, and
    thresholds at tally, tally - 1 and below."""
    rng = np.random.default_rng(seed)
    B = n_dev * 128
    valid = rng.random(B) < 0.8
    power5 = np.full((B, ek.POWER_LIMBS), ek.POWER_MASK, np.int32)
    power5[::7] = ek.power_limbs(rng.integers(0, 2**62, B))[::7]
    counted = rng.random(B) < 0.9
    cids = rng.integers(0, C, B).astype(np.int32)
    tally = ek.tally_core(torch.from_numpy(valid), torch.from_numpy(power5),
                          torch.from_numpy(counted), torch.from_numpy(cids),
                          C)
    ints = ek.tally_to_int(tally.numpy())
    thresh = np.concatenate([ek.threshold_limbs(
        max(int(t) - (k % 3), 0)) for k, t in enumerate(ints)])
    return valid, power5, counted, cids, thresh, tally


def test_sharded_tally_equals_jax_on_eight_devices():
    valid, power5, counted, cids, thresh, want = _carry_inputs(8)
    jm = jmesh()
    ax = jm.axis_names[0]
    put = lambda a, spec: jax.device_put(a, NamedSharding(jm, spec))  # noqa
    jt, jq = jpm._sharded_tally_step(jm, 5)(
        put(valid, JP(ax)), put(power5, JP(ax, None)), put(counted, JP(ax)),
        put(cids, JP(ax)), thresh)
    pt, pq = pm._sharded_tally_step(pmesh(), 5)(valid, power5, counted,
                                                cids, thresh)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(pt.numpy(), want.numpy())
    assert pq.tolist() == [k % 3 != 0 for k in range(5)]


@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_carry_quorum_equals_the_jax_psum_carry_and_quorum(n_dev):
    rng = np.random.default_rng(100 + n_dev)
    C = 9
    parts = rng.integers(0, 1 << 13, (n_dev, C, ek.TALLY_LIMBS)).astype(
        np.int32)
    parts[:, 0] = (1 << 13) - 1  # a commit whose every limb carries
    total = np.asarray(jpm._carry_tally(jnp.asarray(parts.sum(0))))
    thresh = total.copy()
    thresh[1::2, 0] -= 1  # odd commits clear their threshold by one
    jq = np.asarray(jek.quorum_core(jnp.asarray(total), jnp.asarray(thresh)))
    t, q = ek.carry_quorum(torch.from_numpy(parts), torch.from_numpy(thresh))
    np.testing.assert_array_equal(t.numpy(), total)
    np.testing.assert_array_equal(q.numpy(), jq)
    assert q.tolist() == [k % 2 == 1 for k in range(C)]
    assert ek.carry_quorum.launches == 0  # CPU tensors: the plain version


@pytest.mark.skipif(not (__import__("shutil").which("c++")
                         or __import__("shutil").which("g++")),
                    reason="no C++ compiler for the host build")
@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_carry_quorum_host_build_equals_plain(n_dev):
    rng = np.random.default_rng(7 * n_dev)
    C = 300  # above one block of the kernel's 128 threads
    parts = rng.integers(0, 1 << 13, (n_dev, C, ek.TALLY_LIMBS)).astype(
        np.int32)
    thresh = rng.integers(0, 1 << 13, (C, ek.TALLY_LIMBS)).astype(np.int32)
    thresh[: C // 2] = ek.carry_quorum_plain(
        torch.from_numpy(parts), torch.from_numpy(thresh))[0][: C // 2]
    tally = np.zeros((C, ek.TALLY_LIMBS), np.int32)
    quorum = np.zeros(C, np.uint8)
    _build.host_lib().cbt_host_carry_quorum(
        parts.ctypes.data, n_dev, C, thresh.ctypes.data, tally.ctypes.data,
        quorum.ctypes.data)
    t, q = ek.carry_quorum_plain(torch.from_numpy(parts),
                                 torch.from_numpy(thresh))
    np.testing.assert_array_equal(tally, t.numpy())
    np.testing.assert_array_equal(quorum.astype(bool), q.numpy())
    assert not q[: C // 2].any()  # equal to its threshold: no quorum


def test_carry_quorum_refuses_bad_operands():
    parts = torch.zeros((2, 3, 6), dtype=torch.int32)
    with pytest.raises(ValueError):
        ek.carry_quorum(parts.to(torch.int64), torch.zeros((3, 6),
                                                           dtype=torch.int32))
    with pytest.raises(ValueError):
        ek.carry_quorum(parts, torch.zeros((2, 6), dtype=torch.int32))
    with pytest.raises(ValueError):
        ek.carry_quorum(parts[:0], torch.zeros((3, 6), dtype=torch.int32))


# ---------------------------------------------------------------------------
# (c) tests/test_mesh.py's scenarios on both packages
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_memos(monkeypatch):
    """Both packages' step memos emptied for the test (steps built with
    stub kernels must not leak)."""
    monkeypatch.setattr(jpm, "_STEP_CACHE", {})
    monkeypatch.setattr(pm, "_STEP_CACHE", {})


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rows_builders_memoized_and_share_verify_program(pkg, fresh_memos):
    P, mk = (jpm, jmesh) if pkg == "jax" else (pm, pmesh)
    mesh = mk()
    assert P.sharded_verify_tally_rows(mesh, 1) is \
        P.sharded_verify_tally_rows(mesh, 1)
    assert P.sharded_verify_tally(mesh, 2) is P.sharded_verify_tally(mesh, 2)
    assert P.sharded_stream_verify(mesh, 4) is \
        P.sharded_stream_verify(mesh, 4)
    # an equivalent mesh (same members) hits the same entries
    assert P.sharded_verify_tally_rows(mk(), 1) is \
        P.sharded_verify_tally_rows(mesh, 1)
    P.sharded_verify_tally_rows(mesh, 16)
    assert P._STEP_CACHE[("rows", P._mesh_key(mesh), 1)] is not \
        P._STEP_CACHE[("rows", P._mesh_key(mesh), 16)]
    assert P._sharded_verify_rows_step(mesh) is \
        P._sharded_verify_rows_step(mesh)
    assert sum(1 for key in P._STEP_CACHE
               if key[0] == "pallas-verify") == 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_step_cache_hit_counters(pkg, fresh_memos):
    P, mk = (jpm, jmesh) if pkg == "jax" else (pm, pmesh)
    mesh = mk()
    P.sharded_verify_tally(mesh, 3)
    before = P.cache_stats()
    for _ in range(4):
        P.sharded_verify_tally(mesh, 3)
    after = P.cache_stats()
    assert after["hits"] >= before["hits"] + 4
    assert after["misses"] == before["misses"]
    P.sharded_verify_tally(mesh, 5)
    mid = P.cache_stats()
    assert mid["misses"] == after["misses"] + 1
    P.sharded_verify_tally(mesh, 5)
    assert P.cache_stats()["hits"] == mid["hits"] + 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_cache_stats_exact_under_two_threads(pkg, fresh_memos):
    P, mk = (jpm, jmesh) if pkg == "jax" else (pm, pmesh)
    mesh = mk()
    P.sharded_verify_tally(mesh, 7)
    before = P.cache_stats()
    n_iter = 2000
    old_si = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(n_iter):
                P.sharded_verify_tally(mesh, 7)

        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old_si)
    after = P.cache_stats()
    assert after["hits"] - before["hits"] == 2 * n_iter
    assert after["misses"] == before["misses"]


def test_step_first_call_is_attributed_to_the_builder(fresh_memos):
    from cometbft_tpu_torch.libs import deviceledger

    seen = []

    def probe(rows, base, threshold):
        stack = getattr(deviceledger._TLS, "stack", None)
        seen.append(stack[-1].site if stack else None)
        return rows

    step = pm._cache_put(("probe", (), 1), probe)
    step(0, 0, 0)
    step(0, 0, 0)
    assert seen == ["mesh.step:probe", None]
    # a richer frame already active keeps the credit
    step2 = pm._cache_put(("probe2", (), 1), probe)
    with deviceledger.attr_context("plane.flush", 7):
        step2(0, 0, 0)
    assert seen[-1] == "plane.flush"
    assert not getattr(deviceledger._TLS, "stack", [])


def _rows_fixture(n_dev):
    n_commits = 4
    n = n_dev * kf.B_TILE
    pubs = [bytes([1 + i % 8]) * 32 for i in range(n)]
    msgs = [b"stub-%d" % i for i in range(n)]
    sigs = [b"\x00" * 64] * n
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=n, native=False)
    power5 = ek.power_limbs(np.full((n,), 7, np.int64))
    counted = np.ones((n,), np.bool_)
    cids = np.arange(n, dtype=np.int32) % n_commits
    thresh = ek.threshold_limbs(1, n_commits)
    rows = kf.pack_rows(pb, power5, counted, cids, thresh)
    rows[kf.C_THRESH:] = 0
    return rows, thresh, n, n_commits


def test_rows_split_plumbing_with_stub_kernel(monkeypatch, fresh_memos):
    """The split verify -> tally over 8 members with a stub verify (even
    commits "verify"): per-member column extraction, the sum, the limb
    carry and the quorum tally exactly, on both packages."""
    rows, thresh, n, C = _rows_fixture(8)

    def jfake(r, base):
        return (r[jkp.C_CID] & 1) == 0

    jfake.__wrapped__ = jfake
    monkeypatch.setattr(jkp, "_verify_rows", jfake)
    monkeypatch.setattr(kf, "ed25519_verify", lambda r: (
        (r[kf.C_CID] & 1) == 0).to(torch.int32))
    jm = jmesh()
    rows_d = jax.device_put(rows, NamedSharding(jm, JP(None,
                                                       jm.axis_names[0])))
    jout = jax.block_until_ready(jpm.sharded_verify_tally_rows(jm, C)(
        rows_d, jkp.base_f32(), thresh))
    pout = pm.sharded_verify_tally_rows(pmesh(), C)(rows, None, thresh)
    cids = rows[kf.C_CID]
    for got, want in zip(pout, jout):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n])
    np.testing.assert_array_equal(pout[0].numpy(), cids % 2 == 0)
    per_commit = n // C * 7
    assert [int(x) for x in ek.tally_to_int(pout[1].numpy())] == [
        per_commit if c % 2 == 0 else 0 for c in range(C)]
    assert pout[2].tolist() == [c % 2 == 0 for c in range(C)]


def test_padded_sharded_tally_matches_unpadded():
    n, pad = 24, 60  # 60 % 8 members != 0: forces the padding path
    pubs = [b"\x01" * 32] * n
    pb = ek.pack_batch(pubs, [b"pad-%d" % i for i in range(n)],
                       [b"\x00" * 64] * n, pad_to=pad, native=False)
    powers = np.arange(1, n + 1, dtype=np.int64) * 111
    power5 = np.zeros((pad, ek.POWER_LIMBS), np.int32)
    power5[:n] = ek.power_limbs(powers)
    counted = np.zeros((pad,), np.int64)  # a hostile dtype: must be cast
    counted[:n] = 1
    cids = np.zeros((pad,), np.int32)
    cids[n // 2:n] = 1
    thresh = ek.threshold_limbs(1, 2)
    out = {}
    for pkg, P, mesh in (("jax", jpm, jmesh()), ("port", pm, pmesh())):
        pb2, args = P.shard_batch_arrays(mesh, pb, power5, counted, cids)
        host = [a.numpy() if isinstance(a, pm.Sharded) else np.asarray(a)
                for a in args]
        assert pb2.padded == 64
        assert host[8].dtype == np.bool_
        assert not host[8][pad:].any()
        assert not host[6][pad:].any()  # precheck pads False
        valid = np.ones((pb2.padded,), np.bool_)
        if pkg == "jax":
            valid = jax.device_put(valid, NamedSharding(
                mesh, JP(mesh.axis_names[0])))
        tally, _ = P._sharded_tally_step(mesh, 2)(valid, args[7], args[8],
                                                  args[9], thresh)
        out[pkg] = np.asarray(tally)
    np.testing.assert_array_equal(out["port"], out["jax"])
    t = ek.tally_to_int(out["port"])
    assert int(t[0]) == int(powers[: n // 2].sum())
    assert int(t[1]) == int(powers[n // 2:].sum())


def test_sharded_fused_layout_with_stub_kernel(monkeypatch, fresh_memos):
    """The plane's sharded fused step over 8 members with a stub cached
    kernel (validity = precheck & ok[column mod M_s]) on both packages:
    shard_positions against the kernels' local map, the per-shard ok and
    power wiring, global commit ids through the reduce, replicated
    thresholds."""
    from _kernel_stubs import fake_verify_tally_cached

    monkeypatch.setattr(jec, "_verify_tally_cached",
                        fake_verify_tally_cached)

    def pfake(rows, tab, ok):
        b = torch.arange(rows.shape[1]) % ok.shape[0]
        return ((((rows[ec.V_FLAGS] >> 1) & 1) != 0) & ok[b]).to(torch.int32)

    monkeypatch.setattr(ec, "ed25519_verify_cached", pfake)
    n_dev, m_s, n_strides, C = 8, 128, 2, 2
    nvals = n_dev * m_s
    b_loc = n_strides * m_s
    B = n_dev * b_loc
    v_of = np.empty(B, np.int64)
    s_of = np.empty(B, np.int64)
    for p in range(B):
        d, q = divmod(p, b_loc)
        s_of[p], v_of[p] = divmod(q, m_s)
        v_of[p] += d * m_s
    np.testing.assert_array_equal(
        pfz.shard_positions(v_of, s_of, m_s, n_strides), np.arange(B))
    precheck_ok = (v_of * 7 + s_of) % 5 != 0
    ok_host = np.asarray([v % 3 != 0 for v in range(nvals)])
    powers = np.arange(1, nvals + 1, dtype=np.int64)
    counted = s_of == 0
    cids = (v_of % C).astype(np.int32)
    pb = ek.pack_batch([b"\x02" * 32] * B, [b"fx-%d" % p for p in range(B)],
                       [b"\x00" * 64] * B, pad_to=B, native=False)
    pb = pb._replace(precheck=np.asarray(precheck_ok, np.bool_))
    rows = ec.pack_rows_cached(pb, counted, cids)
    exp_tally = [int(powers[[v for v in range(nvals) if v % C == c
                             and ok_host[v] and (v * 7) % 5 != 0]].sum())
                 for c in range(C)]
    thresh = np.zeros((C, ek.TALLY_LIMBS), np.int32)
    thresh[0] = ek.threshold_limbs(exp_tally[0] - 1)[0]
    thresh[1] = ek.threshold_limbs(exp_tally[1])[0]
    p5 = ek.power_limbs(powers)

    jm = jmesh()
    ax = jm.axis_names[0]
    jout = jax.block_until_ready(jpm.sharded_fused_verify(jm, C)(
        jax.device_put(rows, NamedSharding(jm, JP(None, ax))),
        jax.device_put(np.zeros((nvals // 128 * jec.ENT_BLOCK, 128),
                                np.int16), NamedSharding(jm, JP(ax, None))),
        jax.device_put(ok_host, NamedSharding(jm, JP(ax))),
        jax.device_put(p5, NamedSharding(jm, JP(ax, None))),
        jec.base60_f32(), thresh))
    pmm = pmesh()
    tabs = tuple(torch.zeros((m_s * ec.ENT_PER_VAL, 3, 10),
                             dtype=torch.int32) for _ in range(n_dev))
    oks = tuple(torch.from_numpy(ok_host[d * m_s:(d + 1) * m_s].copy())
                for d in range(n_dev))
    p5s = tuple(torch.from_numpy(p5[d * m_s:(d + 1) * m_s].copy())
                for d in range(n_dev))
    step = pm.sharded_fused_verify(pmm, C)
    pout = step(rows, tabs, oks, p5s, None, thresh)
    for got, want in zip(pout, jout):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pout[0].numpy(), precheck_ok
                                  & ok_host[v_of])
    assert [int(x) for x in ek.tally_to_int(pout[1].numpy())] == exp_tally
    assert pout[2].tolist() == [True, False]
    before = pm.cache_stats()
    assert pm.sharded_fused_verify(pmm, C) is step
    assert pm.cache_stats()["hits"] == before["hits"] + 1


def test_effective_mesh_clamps_empty_shards():
    for mk, fz in ((jmesh, jfz), (pmesh, pfz)):
        mesh = mk()
        m_eff, n_dev, m_s = fz.effective_mesh(mesh, 10_000)
        assert (n_dev, m_s) == (3, 4096)
        assert _ids(m_eff) == _ids(mesh)[:3]
        assert fz.effective_mesh(mesh, 10_000)[0] is m_eff  # memoized
        full = fz.effective_mesh(mesh, 2048)
        assert full[0] is mesh and full[1] == 8 and full[2] == 256
        assert fz.effective_mesh(mesh, 100) == (None, 1, 256)
        assert fz.effective_mesh(None, 100) == (None, 1, 256)
        # a half of slots of one device: the seam effective_mesh clamps
        h0, h1 = fz.half_meshes(mesh)
        assert _ids(fz.effective_mesh(h1, 10_000)[0]) == (4, 5, 6)


def test_thresh_from_rows_pads_short_sharded_slice():
    # 40 commits * 6 limbs = 240 > the 128 words one zero row holds
    for t in (jec._thresh_from_rows(
            jnp.zeros((jec.V_THRESH + 1, 128), jnp.int32), 40),
              ec._thresh_from_rows(
            torch.zeros((ec.V_THRESH + 1, 128), dtype=torch.int32), 40)):
        assert tuple(t.shape) == (40, ek.TALLY_LIMBS)
        assert not np.asarray(t).any()
    thresh = np.arange(3 * ek.TALLY_LIMBS, dtype=np.int32).reshape(3, -1)
    pb = ek.pack_batch([b"\x01" * 32] * 8, [b"m"] * 8, [b"\x00" * 64] * 8,
                       pad_to=128, native=False)
    rows = ec.pack_rows_cached(pb, thresh=thresh)
    np.testing.assert_array_equal(
        np.asarray(jec._thresh_from_rows(jnp.asarray(rows), 3)), thresh)
    np.testing.assert_array_equal(
        ec._thresh_from_rows(torch.from_numpy(rows), 3).numpy(), thresh)


# ---------------------------------------------------------------------------
# (d) the builders on CPU slots, plain kernels
# ---------------------------------------------------------------------------


def _signed(n, live, seed, tamper=()):
    """n validators' keys, the first `live` signing a message each (the
    rest send zero signatures), tampered indices flipped."""
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n)]
    pubs = [ed.pubkey_from_seed(s) for s in seeds]
    msgs = [b"mesh-%d-%d" % (seed, i) for i in range(n)]
    sigs = [ed.sign(s, m) if i < live else b"\x00" * 64
            for i, (s, m) in enumerate(zip(seeds, msgs))]
    for i in tamper:
        sigs[i] = sigs[i][:9] + bytes([sigs[i][9] ^ 4]) + sigs[i][10:]
    oracle = np.asarray([ed.verify(p, m, s) for p, m, s in
                         zip(pubs, msgs, sigs)])
    return seeds, pubs, msgs, sigs, oracle


def test_general_builders_equal_one_device_and_the_oracle():
    n, live, C = 256, 30, 3
    _, pubs, msgs, sigs, oracle = _signed(n, live, 1, tamper=(4, 17))
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=n)
    rng = np.random.default_rng(5)
    power5 = ek.power_limbs(rng.integers(1, 2**50, n))
    counted = np.arange(n) < live
    cids = (np.arange(n) % C).astype(np.int32)
    tally_ints = [sum(int(ek.tally_to_int(power5[i][None])[0])
                      for i in range(n) if oracle[i] and counted[i]
                      and cids[i] == c) for c in range(C)]
    thresh = np.concatenate([ek.threshold_limbs(t - (c == 1))
                             for c, t in enumerate(tally_ints)])
    one = kf.verify_tally_rows(kf.pack_rows(pb, power5, counted, cids,
                                            thresh), C, device="cpu")
    rows = kf.pack_rows(pb, power5, counted, cids)
    two = pm.sharded_verify_tally_rows(pmesh(2), C)(rows, None, thresh)
    _, args = pm.shard_batch_arrays(pmesh(2), pb, power5, counted, cids)
    xla = pm.sharded_verify_tally(pmesh(2), C)(*args, thresh)
    for out in (two, xla):
        for got, want in zip(out, one):
            assert torch.equal(got, want)
    np.testing.assert_array_equal(one[0].numpy(), oracle)
    assert [int(x) for x in ek.tally_to_int(one[1].numpy())] == tally_ints
    assert one[2].tolist() == [False, True, False]


def test_sharded_operands_stay_where_they_lie():
    """A Sharded operand reaches each slot as its own part (cast only
    where the dtype differs), and a step that would need it as a whole
    array raises instead of copying it back to the host."""
    mesh = pmesh(4)
    sh = pm.shard(mesh, np.arange(32, dtype=np.int32).reshape(8, 4))
    parts = pm._lanes(mesh, sh, dtype=torch.int32)
    assert all(a is b for a, b in zip(parts, sh.parts))
    cast = pm._lanes(mesh, sh, dtype=torch.uint8)
    assert [p.dtype for p in cast] == [torch.uint8] * 4
    np.testing.assert_array_equal(torch.cat(cast).numpy(),
                                  sh.numpy().astype(np.uint8))
    with pytest.raises(TypeError):
        pm._tensor(sh)


@pytest.mark.parametrize("with_pb,n_commits", [(True, 1), (True, 12),
                                                (False, 3)])
def test_pack_rows_torch_equals_pack_rows(with_pb, n_commits):
    """The sharded steps' device packer against the host packer, byte for
    byte: the curve rows and flags from the PackedBatch arrays (or zero
    without them), the power limbs, counted bits and commit ids, and
    zero threshold rows for n_commits of them."""
    n = 64
    _, pubs, msgs, sigs, _ = _signed(n, 20, 6, tamper=(3,))
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=n, native=False)
    rng = np.random.default_rng(8)
    power5 = ek.power_limbs(rng.integers(1, 2**60, n))
    counted = rng.integers(0, 2, n).astype(np.bool_)
    cids = rng.integers(0, n_commits, n).astype(np.int32)
    want = kf.pack_rows(pb, power5, counted, cids,
                        np.zeros((n_commits, ek.TALLY_LIMBS), np.int32))
    arrays = None
    if with_pb:
        arrays = tuple(torch.from_numpy(np.asarray(a)) for a in (
            pb.ay, pb.asign, pb.ry, pb.rsign, pb.sdig, pb.hdig,
            pb.precheck))
    got = kf.pack_rows_torch(
        n, torch.device("cpu"), arrays, torch.from_numpy(power5),
        torch.from_numpy(counted), torch.from_numpy(cids),
        want.shape[0] - kf.C_THRESH).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if not with_pb:
        # no curve rows: only the counted bit of the flags
        assert not got[:kf.C_FLAGS].any()
        np.testing.assert_array_equal(got[kf.C_FLAGS],
                                      counted.astype(np.int32) << 3)
        got, want = got[kf.C_POW:], want[kf.C_POW:]
    assert got.tobytes() == want.tobytes()


def _stream_fixture(m_live=40):
    """One 64-validator set (its table pads to M = 128) and a 2-commit
    chunk in the stream's layout (commit c at columns [c*M, (c+1)*M));
    validator 9 of commit 1 tampered; the table built on the CPU."""
    seeds, pubs, _, _, _ = _signed(64, 0, 3)
    table = ec.build_table(pubs, [10] * 64, device="cpu")
    M = table.n_vals
    assert M == 128
    seeds += [None] * (M - 64)
    pubs += [b""] * (M - 64)
    spubs, smsgs, ssigs = [], [], []
    for c in range(2):
        for i in range(M):
            m = b"stream-%d-%d" % (c, i)
            spubs.append(pubs[i])
            smsgs.append(m)
            ssigs.append(ed.sign(seeds[i], m) if i < m_live
                         else b"\x00" * 64)
    bad = M + 9
    ssigs[bad] = b"\x01" * 64
    pb = ek.pack_batch(spubs, smsgs, ssigs, pad_to=2 * M)
    counted = np.ones(2 * M, np.bool_)
    cids = np.repeat(np.arange(2, dtype=np.int32), M)
    oracle = np.asarray([i % M < m_live and i != bad for i in range(2 * M)])
    return pb, counted, cids, table, oracle


def test_stream_builder_equals_one_device_and_the_oracle():
    pb, counted, cids, table, oracle = _stream_fixture()
    thresh = ek.threshold_limbs(40 * 10 - 10, 2)  # commit 1 misses it
    one = ec.verify_tally_rows_cached(
        ec.pack_rows_cached(pb, counted, cids, thresh), table, 2)
    rows = ec.pack_rows_cached(pb, counted, cids)
    two = pm.sharded_stream_verify(pmesh(2), 2)(
        rows, table.tab, table.ok, table.power5, None, thresh)
    for got, want in zip(two, one):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(two[0].numpy(), oracle)
    assert [int(x) for x in ek.tally_to_int(two[1].numpy())] == [400, 390]
    assert two[2].tolist() == [True, False]


# ---------------------------------------------------------------------------
# (e) the sharded table cache and convert.sharded_table_from_jax
# ---------------------------------------------------------------------------


def _jax_layout(table):
    """The port's ValsetTable in the JAX package's layout: its niels
    entries as 13-bit (y - x, y + x, 2dt) limbs, blocked by the JAX
    package's own `_blocked_i16`."""
    t13 = ec.limbs25_to_13(table.tab)  # (M*128, 3, 20): y+x, y-x, 2dxy
    raw = torch.stack([t13[:, 1], t13[:, 0], t13[:, 2]], 1).reshape(
        t13.shape[0], 60).numpy()
    raw = np.pad(raw, ((0, 0), (0, 4))).astype(np.int32)
    return np.asarray(jec._blocked_i16(jnp.asarray(raw)))


def test_sharded_table_cache_and_convert_from_jax(monkeypatch):
    """300 validators over 2 slots: stride 256, each shard built on its
    slot; the second lookup is a hit (no build), the JAX package's sharded
    table over 2 devices (its per-shard build answered with the port's
    tables in the JAX layout) converts back to the port's shards."""
    tc.reset_for_tests()
    _, pubs, _, _, _ = _signed(300, 0, 11)
    pubs = tuple(pubs[:299]) + (b"\x05" * 31,)  # a malformed last key
    powers = tuple(range(1, 301))
    mesh = pmesh(2)
    b0 = ec.valset_table_build.launches
    t, warm = ec.sharded_table_for_pubs_info(pubs, powers, mesh)
    assert not warm and (t.m_shard, t.n_dev, t.devs) == (256, 2, (0, 1))
    assert tc.stats()["shard_misses"] == 1
    t2, warm2 = ec.sharded_table_for_pubs_info(pubs, powers, mesh)
    assert warm2 and t2 is t and tc.stats()["shard_hits"] == 1
    assert ec.valset_table_build.launches == b0  # plain builds: no launch
    assert tc.resident_bytes() == t.nbytes
    assert tc.snapshot_values("shard_tables") == [t]
    # a shard equals the one-device table of its chunk
    ref = ec.build_table(list(pubs[256:]) + [b""] * 212,
                         list(powers[256:]) + [0] * 212, device="cpu")
    assert torch.equal(t.tab[1], ref.tab) and torch.equal(t.ok[1], ref.ok)
    assert torch.equal(t.power5[1], ref.power5)
    assert torch.equal(t.pub_raw[1], ref.pub_raw)
    assert not t.ok[1][43:].any() and t.ok[1][:43].all()
    # another mesh of the same slots' device is another key
    _, warm3 = ec.sharded_table_for_pubs_info(pubs, powers,
                                              pm.make_mesh([
                                                  pm.Slot(2, torch.device(
                                                      "cpu")),
                                                  pm.Slot(3, torch.device(
                                                      "cpu"))]))
    assert not warm3 and tc.stats()["shard_misses"] == 2

    shards = {}
    for d in range(2):
        chunk = list(pubs[d * 256:(d + 1) * 256])
        shards[tuple(chunk + [b""] * (256 - len(chunk)))] = (
            t.tab[d], t.ok[d], t.power5[d], t.pub_raw[d])

    def fake_build(pub_bytes, powers=None):
        tab, ok, p5, pr = shards[tuple(pub_bytes)]
        st = ec.ValsetTable(tab, ok, p5, 256)
        return jec.ValsetTable(
            jnp.asarray(_jax_layout(st)), jnp.asarray(ok.numpy()),
            jnp.asarray(p5.numpy()), 256, jec._pubs_host(pub_bytes, 256),
            jec._powers_host(powers, 256), jnp.asarray(pr.numpy()))

    monkeypatch.setattr(jec, "build_table", fake_build)
    monkeypatch.setattr(jec, "_SHARD_CACHE", jec.tc.BoundedLRU("shard", 4))
    jt, jwarm = jec.sharded_table_for_pubs_info(pubs, powers, jmesh(2))
    assert not jwarm and (jt.m_shard, jt.n_dev) == (256, 2)
    back = convert.sharded_table_from_jax(
        np.asarray(jt.tab), np.asarray(jt.ok), np.asarray(jt.power5),
        jt.m_shard, jt.n_dev, mesh, np.asarray(jt.pub_raw))
    for f in ("tab", "ok", "power5", "pub_raw"):
        for got, want in zip(getattr(back, f), getattr(t, f)):
            assert torch.equal(got, want), f
    assert back.devs == (0, 1) and back.nbytes == t.nbytes
    tc.reset_for_tests()
