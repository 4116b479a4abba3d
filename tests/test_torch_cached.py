"""The port's cached-valset path against the JAX package on the same seeded
inputs: packed rows and stamped rows are byte-identical, and the plain
PyTorch versions of the cached verify, tally and stamp kernels give exactly
the JAX verdicts, tallies and rows (and the oracle's verdicts). The kernels'
own arithmetic (csrc/*.cuh) is also built for the host and held against the
plain versions. The table build against the JAX build is in
tests/test_torch_cached_table.py; the CUDA kernels themselves run in
tests/test_torch_cuda.py."""
import ctypes
import random
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519_cached as jec
from cometbft_tpu.ops import ed25519_kernel as jek
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import vote as jvote
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu_torch import edge_cases
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.edge_cases import ed25519_zip215_cases
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_stamp as es
from cometbft_tpu_torch.ops import table_cache as tc
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.vote import sign_bytes_template

CPU = torch.device("cpu")

# The plain versions run many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the host.
torch.set_num_threads(1)

# timestamps that cross every varint width boundary, the zero-skipping
# cases and the 10-byte two's-complement negatives (the JAX package's
# tests/test_sign_template.py FUZZ_SECS / FUZZ_NANOS)
FUZZ_SECS = [0, 1, 127, 128, 16383, 16384, 1_700_000_000, 2**31 - 1,
             2**31, 2**40, 2**62, -1, -2**33]
FUZZ_NANOS = [0, 1, 127, 128, 999_999_999, 5, 42, -7]

needs_cxx = pytest.mark.skipif(
    shutil.which("c++") is None and shutil.which("g++") is None,
    reason="no C++ compiler for the host build of the kernel arithmetic")


def mixed_batch(seed=0, n_valid=30):
    """Valid, flipped-bit, tampered-message, S >= L, garbage, undecodable
    and short keys, and ZIP-215 rows (<= 64, one JAX bucket)."""
    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = [], [], []
    for _ in range(n_valid):
        m = rng.bytes(int(rng.integers(0, 80)))
        pub, (sig,) = ed.sign_many(rng.bytes(32), [m])
        pubs.append(pub)
        msgs.append(m)
        sigs.append(sig)
    for i in range(0, n_valid, 5):
        sigs[i] = sigs[i][:9] + bytes([sigs[i][9] ^ 4]) + sigs[i][10:]
    for i in range(1, n_valid, 7):
        msgs[i] = msgs[i] + b"?"
    s = int.from_bytes(sigs[3][32:], "little") + ed.L
    sigs[3] = sigs[3][:32] + int.to_bytes(s, 32, "little")
    pubs[4] = b"\x02" + bytes(31)  # y = 2 is not on the curve
    pubs[6] = pubs[6][:31]
    for _ in range(6):
        pubs.append(rng.bytes(32))
        msgs.append(rng.bytes(3))
        sigs.append(rng.bytes(64))
    for p, m, s in ed25519_zip215_cases():
        pubs.append(p)
        msgs.append(m)
        sigs.append(s)
    return pubs, msgs, sigs


def oracle(pubs, msgs, sigs):
    return np.array([ed.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)])


@pytest.fixture(scope="module")
def batch():
    """A mixed batch, its 128-slot table (plain build) and packed rows."""
    pubs, msgs, sigs = mixed_batch(11)
    table = ec.build_table(pubs, [7] * len(pubs), device="cpu")
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=ec.pad_rows(len(pubs)))
    return pubs, msgs, sigs, table, ec.pack_rows_cached(pb)


# --------------------------------------------------------------------------
# packing and layout
# --------------------------------------------------------------------------


def test_layout_constants_match_the_jax_package():
    for name in ("NJ", "NW", "NENT", "V_RY", "V_S8", "V_H4", "V_FLAGS",
                 "V_KROWS", "V_THRESH", "UPDATE_PAD", "MAX_INCREMENTAL"):
        assert getattr(ec, name) == getattr(jec, name), name
    assert es.MAX_TEMPLATE_SITES == jec.MAX_TEMPLATE_SITES
    for n in (1, 127, 128, 129, 1000, 1024, 10_000, 16_384, 65_536):
        assert ec.table_pad(n) == jec.table_pad(n)
        assert ec.pad_rows(n) == jec.pad_rows(n)
    for B, c in ((128, 1), (128, 30), (65_536, 64), (10_240, 1),
                 (256, 200)):
        assert ec.packed_rows_shape(B, c) == jec.packed_rows_shape(B, c)
    with pytest.raises(ValueError):
        ec.pad_rows(70_000)


@pytest.mark.parametrize("seed", [1, 2])
def test_pack_rows_cached_is_byte_identical(seed):
    pubs, msgs, sigs = mixed_batch(seed)
    rng = np.random.default_rng(seed)
    B = 128
    a = ek.pack_batch(pubs, msgs, sigs, pad_to=B)
    b = jek.pack_batch(pubs, msgs, sigs, pad_to=B)
    counted = rng.integers(0, 2, B).astype(bool)
    cids = rng.integers(0, 40, B).astype(np.int32)
    thresh = np.stack([ek.threshold_limbs(int(t))[0]
                       for t in rng.integers(0, 2**62, 40)])
    ra = ec.pack_rows_cached(a, counted, cids, thresh)
    rb = jec.pack_rows_cached(b, counted, cids, thresh)
    assert ra.dtype == rb.dtype == np.int32
    assert ra.tobytes() == rb.tobytes()
    assert ec.pack_rows_cached(a).tobytes() == jec.pack_rows_cached(
        b).tobytes()
    out = np.zeros(ec.packed_rows_shape(B, 40), np.int32)
    assert ec.pack_rows_cached(a, counted, cids, thresh, out=out) is out


# --------------------------------------------------------------------------
# verify: plain version vs oracle vs JAX XLA kernel vs the host build
# --------------------------------------------------------------------------


def test_plain_cached_verify_matches_oracle_and_jax(batch):
    pubs, msgs, sigs, table, rows = batch
    n = len(pubs)
    got = ec.verify_rows_cached(rows, table).numpy()
    exp = oracle(pubs, msgs, sigs) & np.array([len(p) == 32 for p in pubs])
    jpb = jek.pack_batch(pubs, msgs, sigs, pad_to=64)
    want = np.asarray(jek.verify_kernel(
        jpb.ay, jpb.asign, jpb.ry, jpb.rsign, jpb.sdig, jpb.hdig,
        jpb.precheck))
    assert np.array_equal(got[:n], exp)
    assert np.array_equal(got[:n], want[:n])
    assert not got[n:].any()
    assert exp.sum() >= 20 and not exp.all()
    # an undecodable key and a short key leave ok False
    assert not table.ok[4] and not table.ok[6] and table.ok[0]


def test_verify_batch_cached_on_the_host_matches_the_oracle(batch):
    pubs, msgs, sigs, table, _ = batch
    got = ec.verify_batch_cached(pubs, msgs, sigs, table=table)
    exp = oracle(pubs, msgs, sigs) & np.array([len(p) == 32 for p in pubs])
    assert got.shape == (len(pubs),) and np.array_equal(got, exp)


def test_plain_cached_tally_matches_jax_exactly():
    rng = np.random.default_rng(3)
    M, C = 128, 5
    B = M * 4
    power5 = ek.power_limbs(rng.integers(0, 2**55, M))
    valid = (rng.random(B) < 0.8).astype(np.int32)
    flags = ((rng.random(B) < 0.9).astype(np.int32) << 2) | (
        rng.integers(0, C, B).astype(np.int32) << 3) | (
        rng.integers(0, 4, B).astype(np.int32))
    rows = np.zeros(ec.packed_rows_shape(B, C), np.int32)
    rows[ec.V_FLAGS] = flags
    sums = np.zeros(C, object)
    for b in range(B):
        if valid[b] and (flags[b] >> 2) & 1:
            sums[flags[b] >> 3] += int(ek.tally_to_int(power5[b % M]))
    thr = [int(s) - 1 for s in sums]
    thr[2] = int(sums[2])  # misses quorum by exactly 1
    thresh = np.stack([ek.threshold_limbs(t)[0] for t in thr])
    rows[ec.V_THRESH:].reshape(-1)[:C * 6] = thresh.reshape(-1)
    tally, quorum = ec.tally_quorum_cached(
        torch.from_numpy(valid), torch.from_numpy(rows),
        torch.from_numpy(power5), C)
    pw = np.tile(power5, (B // M, 1))
    jt = np.asarray(jek.tally_core(valid != 0, pw, ((flags >> 2) & 1) != 0,
                                   flags >> 3, C))
    jq = np.asarray(jek.quorum_core(jt, thresh))
    assert np.array_equal(tally.numpy(), jt)
    assert np.array_equal(quorum.numpy(), jq)
    assert list(ek.tally_to_int(tally.numpy())) == list(sums)
    assert quorum.numpy().tolist() == [True, True, False, True, True]


def test_verify_tally_rows_cached_runs_both_kernels(batch):
    pubs, msgs, sigs, table, _ = batch
    n = len(pubs)
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=128)
    counted = np.zeros(128, bool)
    counted[:n] = True
    rows = ec.pack_rows_cached(pb, counted, np.zeros(128, np.int32),
                               ek.threshold_limbs(7 * 5))
    valid, tally, quorum = ec.verify_tally_rows_cached(rows, table, 1)
    exp = oracle(pubs, msgs, sigs) & np.array([len(p) == 32 for p in pubs])
    assert np.array_equal(valid.numpy()[:n], exp)
    assert ek.tally_to_int(tally.numpy())[0] == 7 * int(exp.sum())
    assert bool(quorum[0]) == (7 * int(exp.sum()) > 35)


# --------------------------------------------------------------------------
# table updates and the cache stack
# --------------------------------------------------------------------------


def _keys(n, tag):
    return [ed.pubkey_from_seed(bytes([tag, i % 251]) + b"\x13" * 30)
            for i in range(n)]


def _same_table(a, b):
    assert torch.equal(a.tab, b.tab)
    assert torch.equal(a.ok, b.ok)
    assert torch.equal(a.power5, b.power5)
    assert torch.equal(a.pub_raw, b.pub_raw)
    assert a.pubs_host == b.pubs_host
    assert np.array_equal(a.powers_host, b.powers_host)


def test_update_table_equals_a_cold_build(batch):
    pubs, _, _, base, _ = batch
    n = len(pubs)
    fresh = _keys(3, 40)
    changes = [(2, fresh[0]), (30, fresh[1]), (n + 1, fresh[2]),
               (9, b"\x01" * 31)]
    target = list(pubs) + [b"", b""]
    powers = [7] * n + [0, 0]
    for i, p in changes:
        target[i] = p
    powers[5], powers[2] = 99, 1234
    patched = ec.update_table(base, changes, {5: 99, 2: 1234})
    cold = ec.build_table(target, powers, device="cpu")
    _same_table(patched, cold)
    assert not patched.ok[9] and patched.ok[2]
    # the base table was copied, never written
    assert base.pubs_host[2] == pubs[2]


def test_update_table_budget_errors():
    """Deltas beyond UPDATE_PAD raise ValueError (table_for_pubs turns that
    into a full rebuild) and out-of-range indices are rejected."""
    t = ec.ValsetTable(None, None, None, 256, ec._pubs_host([], 256),
                       np.zeros(256, np.int64), device="cpu")
    with pytest.raises(ValueError):
        ec.update_table(t, [(300, b"\x00" * 32)])
    with pytest.raises(ValueError):
        ec.update_table(t, [], {256: 1})
    too_many = [(i, b"\x00" * 32) for i in range(ec.UPDATE_PAD + 1)]
    with pytest.raises(ValueError):
        ec.update_table(t, too_many)
    changes = [(i, b"\x00" * 32) for i in range(ec.UPDATE_PAD)]
    with pytest.raises(ValueError):
        ec.update_table(t, changes, {ec.UPDATE_PAD + 1: 5})
    assert ec.update_table(t, [], None) is t


def test_cache_key_and_pubs_host_match_the_jax_package():
    pubs = _keys(130, 1)
    assert ec._cache_key(pubs, [5] * 130) == jec._cache_key(pubs, [5] * 130)
    assert ec._cache_key([b"", b"\x00" * 32], None) != ec._cache_key(
        [b"\x00" * 32, b""], None)
    assert ec._pubs_host(pubs, 256) == jec._pubs_host(pubs, 256)


def _fake_table(pubs, padded=128):
    return ec.ValsetTable(None, None, None, padded,
                          ec._pubs_host(pubs, padded),
                          np.zeros(padded, np.int64), device="cpu")


@pytest.fixture
def private_cache(monkeypatch):
    """A private table cache, so the process-wide one can neither donate
    nor receive a near-miss base."""
    cache = tc.BoundedLRU("tables", 8, size_fn=tc.default_size)
    monkeypatch.setattr(ec, "_TABLE_CACHE", cache)
    return cache


def test_warm_incremental_no_base_returns_false(monkeypatch, private_cache):
    calls = []
    monkeypatch.setattr(ec, "update_table", lambda *a, **k: calls.append(a))
    assert ec.warm_incremental(tuple(_keys(4, 101)), device="cpu") is False
    assert calls == [] and len(private_cache) == 0
    with ec._TABLE_LOCK:
        private_cache.put(b"base256", _fake_table(_keys(200, 102), 256))
    assert ec.warm_incremental(tuple(_keys(4, 101)), device="cpu") is False
    assert calls == []


def test_warm_incremental_patches_eligible_base(monkeypatch, private_cache):
    target_pubs = tuple(_keys(4, 104))
    with ec._TABLE_LOCK:
        private_cache.put(b"base", _fake_table(_keys(4, 103)))
        h0 = dict(ec._TABLE_STATS)
    marker = _fake_table(target_pubs)
    seen = []

    def fake_update(cand, changes, pw_map=None):
        seen.append((len(changes), dict(pw_map or {})))
        return marker

    monkeypatch.setattr(ec, "update_table", fake_update)
    assert ec.warm_incremental(target_pubs, device="cpu") is True
    assert seen == [(4, {})]
    key = (ec._memo_cache_key(target_pubs, None), "cpu")
    with ec._TABLE_LOCK:
        assert private_cache.peek(key) is marker
        h1 = dict(ec._TABLE_STATS)
    assert h1["hits"] == h0["hits"] and h1["misses"] == h0["misses"]
    assert h1["incremental_patches"] == h0["incremental_patches"] + 1
    assert ec.warm_incremental(target_pubs, device="cpu") is True
    assert len(seen) == 1


def test_warm_incremental_budget_overflow_returns_false(monkeypatch,
                                                        private_cache):
    with ec._TABLE_LOCK:
        private_cache.put(b"base", _fake_table(_keys(4, 105)))

    def refuse(*a, **k):
        raise ValueError("delta over budget")

    monkeypatch.setattr(ec, "update_table", refuse)
    with ec._TABLE_LOCK:
        h0 = dict(ec._TABLE_STATS)
    assert ec.warm_incremental(tuple(_keys(4, 106)), device="cpu") is False
    with ec._TABLE_LOCK:
        assert ec._TABLE_STATS["incremental_patches"] == \
            h0["incremental_patches"]


def test_table_for_pubs_near_miss_patches_and_counts(monkeypatch,
                                                     private_cache):
    """A miss whose valset differs from a cached one in a few slots is
    patched from it (byte-identical to a cold build); a repeat lookup
    hits; a table on another device is never a base."""
    pubs = tuple(_keys(6, 107))
    t0, warm = ec.table_for_pubs_info(pubs, (3,) * 6, device="cpu")
    assert warm is False
    t1, warm = ec.table_for_pubs_info(pubs, (3,) * 6, device="cpu")
    assert warm is True and t1 is t0
    churned = list(pubs)
    churned[1] = _keys(1, 108)[0]
    p0 = ec._TABLE_STATS["incremental_patches"]
    t2 = ec.table_for_pubs(tuple(churned), (3,) * 6, device="cpu")
    assert ec._TABLE_STATS["incremental_patches"] == p0 + 1
    _same_table(t2, ec.build_table(churned, [3] * 6, device="cpu"))
    assert tc.default_size(t2) == (
        sum(x.nbytes for x in (t2.tab, t2.ok, t2.power5, t2.pub_raw))
        + 32 * 6 + t2.powers_host.nbytes)
    meta = ec._find_incremental_base(ec._pubs_host(churned, 128), 128,
                                     torch.device("meta"))
    assert meta is None


# --------------------------------------------------------------------------
# device stamping: plain version vs the JAX XLA prologue vs a host pack
# --------------------------------------------------------------------------


def _stamp_case(n=40, seed=9):
    """n signed precommits over two templates (both BlockID forms), every
    FUZZ timestamp, plus the staged deltas and the host-packed rows."""
    rng = random.Random(seed)
    seeds = [bytes([200, i]) * 16 for i in range(n)]
    pubs = [ed.pubkey_from_seed(s) for s in seeds]
    chain, r = "stamp-chain", 1
    bids = [None, (b"\x23" * 32, 5, b"\x34" * 32)]
    tbids = [None, BlockID(bids[1][0], PartSetHeader(bids[1][1],
                                                     bids[1][2]))]
    jbids = [None, JBlockID(bids[1][0], JPSH(bids[1][1], bids[1][2]))]
    combos = [(s, nn) for s in FUZZ_SECS for nn in FUZZ_NANOS]
    rng.shuffle(combos)
    secs = [c[0] for c in combos[:n]]
    nanos = [c[1] for c in combos[:n]]
    tids = [i % 2 for i in range(n)]
    msgs = [canonical.canonical_vote_bytes(
        chain, canonical.PRECOMMIT_TYPE, 77 + t, r, tbids[t],
        Timestamp(s, nn)) for s, nn, t in zip(secs, nanos, tids)]
    sigs = [ed.sign(s, m) for s, m in zip(seeds, msgs)]
    if n > 5:  # S >= L fails the precheck
        sigs[5] = sigs[5][:32] + int.to_bytes(
            int.from_bytes(sigs[5][32:], "little") + ed.L, 32, "little")
    B, C = 128, 3
    thresh = np.stack([ek.threshold_limbs(v)[0] for v in (5, 1000, 2**40)])
    counted = np.zeros(B, bool)
    counted[:n] = [i % 3 != 1 for i in range(n)]
    cids = np.zeros(B, np.int32)
    cids[:n] = [i % C for i in range(n)]
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=B)
    ref = ec.pack_rows_cached(pb, counted, cids, thresh)
    dsig = np.zeros((B, 64), np.uint8)
    dsig[:n] = np.frombuffer(b"".join(sigs), np.uint8).reshape(-1, 64)
    dts = np.zeros((B, 3), np.int32)
    dts[:n] = canonical.split_ts_words(secs, nanos)
    dfl = np.zeros(B, np.int32)
    dfl[:n] = (1 | (counted[:n].astype(np.int32) << 1)
               | (np.asarray(tids, np.int32) << 2) | (cids[:n] << 10))
    ttm = [sign_bytes_template(chain, canonical.PRECOMMIT_TYPE, 77 + t, r,
                               tbids[t]) for t in range(2)]
    jtm = [jvote.sign_bytes_template(chain, jcanon.PRECOMMIT_TYPE, 77 + t,
                                     r, jbids[t]) for t in range(2)]
    return SimpleNamespace(pubs=pubs, msgs=msgs, B=B, C=C, thresh=thresh,
                           ref=ref,
                           dsig=dsig, dts=dts, dfl=dfl, ttm=ttm, jtm=jtm)


def test_split_ts_words_and_stamp_site_match_the_jax_package():
    secs = FUZZ_SECS * 2
    nanos = (FUZZ_NANOS * 4)[:len(secs)]
    assert np.array_equal(canonical.split_ts_words(secs, nanos),
                          jcanon.split_ts_words(secs, nanos))
    case = _stamp_case(4)
    for t, j in zip(case.ttm, case.jtm):
        a, b = t.stamp_site(), j.stamp_site()
        assert a.key == b.key
        assert (a.ol_max, a.max_len) == (b.ol_max, b.max_len)


def test_plain_stamp_matches_jax_and_the_host_pack():
    case = _stamp_case()
    table = SimpleNamespace(pub_raw=torch.from_numpy(
        ec._pack_pub_arrays(case.pubs, case.B)[0]), device=CPU)
    ent = es.template_entry([t.stamp_site() for t in case.ttm], "cpu")
    got = es.stamp_rows_cached(case.dsig, case.dts, case.dfl, ent, table,
                               case.C, case.thresh).numpy()
    assert np.array_equal(got, case.ref)
    jent = jec.template_entry([t.stamp_site() for t in case.jtm])
    jtable = SimpleNamespace(pub_raw=jec._pub_raw(case.pubs, case.B))
    want = np.asarray(jec.stamp_rows_cached(
        case.dsig, case.dts, case.dfl, jent, jtable, case.C, case.thresh))
    assert got.tobytes() == want.tobytes()
    assert ent.msg_max == jent.msg_max and ent.n_sites == jent.n_sites


def test_template_entry_is_cached_and_refuses_oversized_lists():
    case = _stamp_case(2)
    sites = [t.stamp_site() for t in case.ttm]
    a = es.template_entry(sites, "cpu")
    h0 = tc.stats()["template_hits"]
    assert es.template_entry(sites, "cpu") is a
    assert tc.stats()["template_hits"] == h0 + 1
    assert es.warm_template(sites, "cpu") is False
    with pytest.raises(ValueError):
        es.template_entry([], "cpu")
    with pytest.raises(ValueError):
        es.template_entry(sites * 129, "cpu")


def test_delta_verify_equals_the_host_packed_verify():
    case = _stamp_case(24)
    table = ec.build_table(case.pubs, [1] * 24, device="cpu")
    ent = es.template_entry([t.stamp_site() for t in case.ttm], "cpu")
    v_d, t_d, q_d = es.verify_tally_delta_cached(
        case.dsig, case.dts, case.dfl, ent, table, case.C, case.thresh)
    v_r, t_r, q_r = ec.verify_tally_rows_cached(case.ref, table, case.C)
    assert torch.equal(v_d, v_r) and torch.equal(t_d, t_r)
    assert torch.equal(q_d, q_r)
    valid = v_d.numpy()
    assert valid[:24].sum() == 23 and not valid[5] and not valid[24:].any()


# --------------------------------------------------------------------------
# the kernels' arithmetic, built for the host
# --------------------------------------------------------------------------


@needs_cxx
def test_host_build_of_sc_reduce_matches_python():
    lib = _build.host_lib()
    rng = np.random.default_rng(12)
    ins = [bytes(64), b"\xff" * 64] + [rng.bytes(64) for _ in range(500)]
    ins += [int.to_bytes(ed.L * k % 2**512, 64, "little")
            for k in (1, 2, 2**200 + 5)]
    for x in ins:
        a = np.frombuffer(x, np.uint8).copy()
        out = np.zeros(32, np.uint8)
        lib.cbt_host_sc_reduce(a.ctypes.data, out.ctypes.data)
        assert int.from_bytes(out.tobytes(), "little") == \
            int.from_bytes(x, "little") % ed.L


@needs_cxx
def test_host_build_of_the_table_and_cached_verify_match_plain(batch):
    pubs, msgs, sigs, table, rows = batch
    lib = _build.host_lib()
    pr = table.pub_raw.numpy()
    M = pr.shape[0]
    tab = np.zeros((M * ec.ENT_PER_VAL, 3, 10), np.int32)
    dec = np.zeros(M, np.uint8)
    lib.cbt_host_table_build(pr.ctypes.data, M, tab.ctypes.data,
                             dec.ctypes.data)
    assert np.array_equal(tab, table.tab.numpy())
    lenok = np.array([len(p) == 32 for p in table.pubs_host])
    assert np.array_equal(dec.astype(bool) & lenok, table.ok.numpy())
    out = np.zeros(rows.shape[1], np.int32)
    ok = table.ok.numpy().astype(np.uint8)
    lib.cbt_host_verify_cached(rows.ctypes.data, rows.shape[1],
                               tab.ctypes.data, M, ok.ctypes.data,
                               kf.niels_table_np().ctypes.data,
                               out.ctypes.data)
    assert np.array_equal(out, ec.verify_rows_cached(rows, table).numpy())


@pytest.mark.parametrize("sms", [132, 114])
def test_wrapper_launches_the_quad_up_to_the_crossover(sms):
    """The quad entry runs up to QUAD_MAX_COLS_PER_SM columns an SM and the
    one-thread entry above, on the card's SM count: on an H100 SXM (132
    SMs) the light call's 8,192 and the cached commit's 10,240 columns run
    the quad, the stream chunk's 65,536 the one-thread kernel."""
    cap = ec.QUAD_MAX_COLS_PER_SM * sms
    assert ec.verify_cached_entry(1, sms) == "quad"
    assert ec.verify_cached_entry(cap, sms) == "quad"
    assert ec.verify_cached_entry(cap + 1, sms) == "thread"
    assert set(ec.VERIFY_CACHED_ENTRIES) == {"quad", "thread"}
    if sms == 132:
        assert [ec.verify_cached_entry(B, sms) for B in (
            8192, 10_240, 16_384, 65_536)] == ["quad", "quad", "thread",
                                               "thread"]


@pytest.fixture(scope="module")
def batch_expected(batch):
    """The batch's verdicts by column: the oracle's (False for a short
    key) and the JAX package's XLA verify kernel's, padding False."""
    pubs, msgs, sigs, _, rows = batch
    n, B = len(pubs), rows.shape[1]
    exp = np.zeros(B, bool)
    exp[:n] = oracle(pubs, msgs, sigs) & np.array([len(p) == 32
                                                   for p in pubs])
    jpb = jek.pack_batch(pubs, msgs, sigs, pad_to=64)
    want = np.zeros(B, bool)
    want[:n] = np.asarray(jek.verify_kernel(
        jpb.ay, jpb.asign, jpb.ry, jpb.rsign, jpb.sdig, jpb.hdig,
        jpb.precheck))[:n].astype(bool)
    return exp, want


def _quad_lane_case(name, rows):
    """(rows, source column of each column, or None for padding only)."""
    B0 = rows.shape[1]
    if name == "batch":
        return rows, np.arange(B0)
    if name == "wrapped":  # four copies: B = 512 > M, so col mod M wraps
        return np.ascontiguousarray(np.tile(rows, (1, 4))), \
            np.arange(4 * B0) % B0
    if name in ("b17", "b1"):
        B = 17 if name == "b17" else 1
        return np.ascontiguousarray(rows[:, :B]), np.arange(B)
    return np.zeros((rows.shape[0], 64), np.int32), None


@needs_cxx
@pytest.mark.parametrize("name", ["batch", "wrapped", "b17", "b1",
                                  "all_padding"])
def test_cached_quad_lane_program_matches_host_plain_jax_and_oracle(
        name, batch, batch_expected):
    """cbt_host_verify_cached_quad runs the cached quad kernel's lane
    program (csrc/ed25519_cached_quad.cuh) with its four lanes on one
    thread; it must give the one-thread host build's, the plain version's,
    the JAX package's and the oracle's verdict on every column: tampered
    signatures, S >= L, an undecodable and a short key (ok False), the
    ZIP-215 edge cases, the table's columns wrapped four times, a ragged
    B, B = 1 and padding only."""
    _, _, _, table, rows0 = batch
    rows, src = _quad_lane_case(name, rows0)
    B = rows.shape[1]
    lib, base = _build.host_lib(), kf.niels_table_np()
    tab = table.tab.numpy()
    M = table.ok.shape[0]
    ok = table.ok.numpy().astype(np.uint8)
    assert M == 128 and (name != "wrapped" or B == 512)
    quad = np.zeros(B, np.int32)
    lib.cbt_host_verify_cached_quad(rows.ctypes.data, B, tab.ctypes.data, M,
                                    ok.ctypes.data, base.ctypes.data,
                                    quad.ctypes.data)
    one = np.zeros(B, np.int32)
    lib.cbt_host_verify_cached(rows.ctypes.data, B, tab.ctypes.data, M,
                               ok.ctypes.data, base.ctypes.data,
                               one.ctypes.data)
    plain = ec.ed25519_verify_cached_plain(
        torch.from_numpy(rows), table.tab, table.ok, kf.base_points(CPU))
    assert np.array_equal(quad, one)
    assert np.array_equal(quad, plain.numpy())
    exp, want = batch_expected
    if src is None:
        assert not quad.any()
        return
    assert np.array_equal(quad.astype(bool), exp[src])
    assert np.array_equal(quad.astype(bool), want[src])
    if name in ("batch", "wrapped"):
        assert quad.sum() >= 20 and not quad.all()


def _host_stamp(lib, case, sites=None, pub_raw=None) -> np.ndarray:
    """The host build of stamp_core.cuh over a case's deltas (a
    _stamp_case's own templates and keys unless given)."""
    ent = es.template_entry(
        sites or [t.stamp_site() for t in case.ttm], "cpu")
    pr = np.ascontiguousarray(
        pub_raw if pub_raw is not None
        else ec._pack_pub_arrays(case.pubs, case.B)[0])
    thr = np.ascontiguousarray(case.thresh, np.int32)
    out = np.zeros_like(case.ref)
    lib.cbt_host_stamp(
        case.dsig.ctypes.data, case.dts.ctypes.data, case.dfl.ctypes.data,
        case.B, ent.pre_mat.numpy().ctypes.data,
        ent.pre_len.numpy().ctypes.data, ent.pre_mat.shape[1],
        ent.suf_mat.numpy().ctypes.data, ent.suf_len.numpy().ctypes.data,
        ent.suf_mat.shape[1], ent.ts_tag.numpy().ctypes.data,
        ent.pre_mat.shape[0], pr.ctypes.data, pr.shape[0], thr.ctypes.data,
        thr.size, case.ref.shape[0] - ec.V_THRESH, out.ctypes.data)
    return out


@needs_cxx
def test_host_build_of_the_stamp_matches_the_host_pack():
    case = _stamp_case()
    assert np.array_equal(_host_stamp(_build.host_lib(), case), case.ref)


@needs_cxx
@pytest.mark.parametrize("name", edge_cases.STAMP_CASES)
def test_host_stamp_program_matches_plain_jax_and_host_pack(name):
    """The kernel's per-thread program, built for the host, equals the
    plain version, the JAX _stamp_rows_core and the host pack byte for
    byte on each stamp case: chain ids of 0-80 bytes under both block-id
    forms at every fuzzed timestamp (rows of 1, 2 and 3 SHA-512 blocks,
    on both sides of each edge), keys that wrap (M < B), dead lanes,
    thresholds over two rows and clamped template indices."""
    import jax.numpy as jnp

    case = edge_cases.stamp_case(name)
    blocks = {es.sha512_blocks(n) for n in case.msg_lens}
    if name == "clamp":
        assert blocks == {1, 2} and {47, 48} <= set(case.msg_lens)
    else:
        assert blocks == {1, 2, 3}
        assert {47, 48, 175, 176} <= set(case.msg_lens)
    host = _host_stamp(_build.host_lib(), case, case.sites, case.pub_raw)
    assert np.array_equal(host, case.ref)
    ent = es.template_entry(case.sites, "cpu")
    t_rows = case.ref.shape[0] - ec.V_THRESH
    plain = es.stamp_rows(
        *(torch.from_numpy(a) for a in (case.dsig, case.dts, case.dfl)),
        ent, torch.from_numpy(case.pub_raw),
        torch.from_numpy(case.thresh.astype(np.int32)), t_rows).numpy()
    assert np.array_equal(plain, case.ref)
    jtm = [jvote.sign_bytes_template(
        c, jcanon.PRECOMMIT_TYPE, h, r, None if b is None else JBlockID(
            b.hash, JPSH(b.part_set_header.total, b.part_set_header.hash)))
        for c, h, r, b in case.site_params]
    jent = jec.template_entry([t.stamp_site() for t in jtm])
    want = np.asarray(jec.stamp_rows_cached(
        case.dsig, case.dts, case.dfl, jent,
        SimpleNamespace(pub_raw=jnp.asarray(case.pub_raw)), case.C,
        case.thresh))
    assert host.tobytes() == want.tobytes()


@needs_cxx
def test_sha512_blocks_behind_the_stamp_bound():
    """The stamp bound's block count (es.sha512_blocks of each live row's
    sign-bytes) is the number of compressions the kernel's code runs, and
    SHA512_OPS_PER_BLOCK is the counted instruction sum."""
    case = _stamp_case(12)
    lib = _build.host_lib(count_ops=True)
    b0 = lib.cbt_host_sha_blocks()
    assert np.array_equal(_host_stamp(lib, case), case.ref)
    assert lib.cbt_host_sha_blocks() - b0 == sum(
        es.sha512_blocks(len(m)) for m in case.msgs)
    assert es.SHA512_OPS_PER_BLOCK == 3536


@needs_cxx
def test_field_op_counts_behind_the_cached_bounds():
    """The per-signature and per-validator multiplication counts the
    bounds use are the counts the kernels' code performs (one extra
    multiplication per decompression that takes the sqrt(-1) branch)."""
    lib = _build.host_lib(count_ops=True)
    m0, s0 = ctypes.c_longlong(), ctypes.c_longlong()
    m1, s1 = ctypes.c_longlong(), ctypes.c_longlong()
    pubs = _keys(1, 109)
    raw = ec._pack_pub_arrays(pubs, 1)[0]
    tab = np.zeros((ec.ENT_PER_VAL, 3, 10), np.int32)
    ok = np.zeros(1, np.uint8)
    lib.cbt_host_op_counts(ctypes.byref(m0), ctypes.byref(s0))
    lib.cbt_host_table_build(raw.ctypes.data, 1, tab.ctypes.data,
                             ok.ctypes.data)
    lib.cbt_host_op_counts(ctypes.byref(m1), ctypes.byref(s1))
    assert s1.value - s0.value == ec.BUILD_FE_SQUARES
    assert 0 <= m1.value - m0.value - ec.BUILD_FE_MULS <= 8
    # the part costs that reproduce the kernel's count give the count the
    # table needs: one decompression, 224 doublings, one inversion
    assert (ec.BUILD_FE_MULS, ec.BUILD_FE_SQUARES) == (4711, 7656)
    assert (ec.BUILD_NEEDED_FE_MULS, ec.BUILD_NEEDED_FE_SQUARES) == (2450,
                                                                    1405)
    assert ec.build_products_per_validator() == 2450 * 100 + 1405 * 55
    seed = bytes([109, 0]) + b"\x13" * 30
    sig = ed.sign(seed, b"count")
    pb = ek.pack_batch(pubs, [b"count"], [sig], pad_to=1)
    rows = ec.pack_rows_cached(pb)
    out = np.zeros(1, np.int32)
    lib.cbt_host_op_counts(ctypes.byref(m0), ctypes.byref(s0))
    lib.cbt_host_verify_cached(rows.ctypes.data, 1, tab.ctypes.data, 1,
                               ok.ctypes.data,
                               kf.niels_table_np().ctypes.data,
                               out.ctypes.data)
    lib.cbt_host_op_counts(ctypes.byref(m1), ctypes.byref(s1))
    assert out[0] == 1
    assert s1.value - s0.value == ec.VERIFY_CACHED_FE_SQUARES
    assert 0 <= m1.value - m0.value - ec.VERIFY_CACHED_FE_MULS <= 1
    assert ec.verify_cached_products_per_signature() == 800 * 100 + 379 * 55


@needs_cxx
@pytest.mark.parametrize("program", ["quad", "warp"])
def test_field_op_counts_of_the_table_lane_programs(program):
    """The table kernel's lane programs (csrc/valset_table_quad.cuh, run by
    the host with a quad's four lanes on one thread) perform, for one
    validator, the field products ec.BUILD_QUAD_FE_* / BUILD_WARP_FE_*
    count over the four lanes (one more multiplication where the
    decompression takes the sqrt(-1) branch), and give the one-thread
    build's table. The quad program squares exactly as often as the table
    needs; the one-thread and the needed counts stay as pinned above."""
    lib = _build.host_lib(count_ops=True)
    m0, s0 = ctypes.c_longlong(), ctypes.c_longlong()
    m1, s1 = ctypes.c_longlong(), ctypes.c_longlong()
    raw = ec._pack_pub_arrays(_keys(1, 109), 1)[0]
    ref = np.zeros((ec.ENT_PER_VAL, 3, 10), np.int32)
    lib.cbt_host_table_build(raw.ctypes.data, 1, ref.ctypes.data,
                             np.zeros(1, np.uint8).ctypes.data)
    tab, ok = np.zeros_like(ref), np.zeros(1, np.uint8)
    lib.cbt_host_op_counts(ctypes.byref(m0), ctypes.byref(s0))
    getattr(lib, f"cbt_host_table_build_{program}")(
        raw.ctypes.data, 1, tab.ctypes.data, ok.ctypes.data)
    lib.cbt_host_op_counts(ctypes.byref(m1), ctypes.byref(s1))
    assert ok[0] == 1 and np.array_equal(tab, ref)
    muls, squares = {"quad": (ec.BUILD_QUAD_FE_MULS, ec.BUILD_QUAD_FE_SQUARES),
                     "warp": (ec.BUILD_WARP_FE_MULS,
                              ec.BUILD_WARP_FE_SQUARES)}[program]
    assert s1.value - s0.value == squares
    assert 0 <= m1.value - m0.value - muls <= 1
    assert (ec.BUILD_QUAD_FE_MULS, ec.BUILD_QUAD_FE_SQUARES) == (3263, 1405)
    assert (ec.BUILD_WARP_FE_MULS, ec.BUILD_WARP_FE_SQUARES) == (9619, 9455)
    assert ec.BUILD_QUAD_FE_SQUARES == ec.BUILD_NEEDED_FE_SQUARES
