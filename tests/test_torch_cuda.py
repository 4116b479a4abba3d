"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they need an NVIDIA Hopper GPU and nvcc, and skip on a host
without them. On the card:  python -m pytest -m cuda tests/test_torch_cuda.py
"""
import time

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.edge_cases import (STAMP_CASES, TALLY_CASES,
                                          stamp_case, stamp_general_case,
                                          tally_edge_case)
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (torch.cuda is unavailable)")
    from cometbft_tpu_torch.device import default_device

    return default_device()


def _batch(seed, n=200, pad=256):
    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        m = rng.bytes(int(rng.integers(0, 64)))
        pub, (sig,) = ed.sign_many(rng.bytes(32), [m])
        if i % 5 == 0:
            sig = sig[:7] + bytes([sig[7] ^ 2]) + sig[8:]
        if i % 13 == 0:
            pub, m, sig = rng.bytes(32), rng.bytes(4), rng.bytes(64)
        pubs.append(pub)
        msgs.append(m)
        sigs.append(sig)
    return pubs, msgs, sigs, ek.pack_batch(pubs, msgs, sigs, pad_to=pad)


def test_ed25519_verify_kernel_equals_plain(card):
    pubs, msgs, sigs, pb = _batch(1)
    rows = torch.from_numpy(kf.pack_rows(pb)).to(card)
    before = kf.ed25519_verify.launches
    got = kf.ed25519_verify(rows)
    want = kf.ed25519_verify_plain(rows, kf.base_points(card))
    torch.cuda.synchronize()
    assert kf.ed25519_verify.launches == before + 1
    assert torch.equal(got, want)
    exp = [ed.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert got.cpu().numpy()[:len(pubs)].astype(bool).tolist() == exp


def _signed_rows(seed, n):
    """Packed rows of n signed columns (one in seven tampered) and their
    oracle verdicts."""
    pubs, msgs, sigs, _ = _batch(seed, n=n, pad=n)
    rows = kf.pack_rows(ek.pack_batch(pubs, msgs, sigs, pad_to=n))
    exp = np.array([ed.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)])
    return rows, exp


def _verify_equals_plain(card, rows):
    """One kernel call (exactly one launch) on rows, equal to plain;
    -> the verdicts."""
    r = torch.from_numpy(np.ascontiguousarray(rows)).to(card)
    before = kf.ed25519_verify.launches
    got = kf.ed25519_verify(r)
    want = kf.ed25519_verify_plain(r, kf.base_points(card))
    torch.cuda.synchronize()
    assert kf.ed25519_verify.launches == before + 1
    assert torch.equal(got, want)
    return got.cpu().numpy()


@pytest.mark.parametrize("name", ["zip215", "ragged", "one", "all_padding"])
def test_ed25519_verify_kernel_edge_shapes(card, name):
    """ZIP-215 encodings, a B that is not a multiple of a block's 16
    signatures, B = 1 and a batch of padding only."""
    from cometbft_tpu_torch.edge_cases import ed25519_zip215_cases

    if name == "zip215":
        pubs, msgs, sigs = map(list, zip(*ed25519_zip215_cases()))
        B = 8
    elif name == "all_padding":
        pubs, msgs, sigs, B = [], [], [], 64
    elif name == "ragged":
        pubs, msgs, sigs, _ = _batch(9, n=13, pad=13)
        B = 17
    else:  # one valid signature
        pub, (sig,) = ed.sign_many(b"\x07" * 32, [b"one"])
        pubs, msgs, sigs, B = [pub], [b"one"], [sig], 1
    rows = kf.pack_rows(ek.pack_batch(pubs, msgs, sigs, pad_to=B))
    got = _verify_equals_plain(card, rows)
    exp = [ed.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert got[:len(pubs)].astype(bool).tolist() == exp
    assert not got[len(pubs):].any()


@pytest.mark.parametrize("live,spread", [(10_000, False), (6_667, False),
                                         (10_000, True)])
def test_ed25519_verify_kernel_at_the_main_paths_shapes(card, live, spread):
    """16,384 columns with the commit paths' live counts: live columns
    first and padding last, as the packers put them, or scattered among
    the padding. 256 signed columns are tiled to the live count."""
    sig_rows, exp = _signed_rows(10, 256)
    B = 16_384
    pos = np.arange(live)
    if spread:
        pos = np.sort(np.random.default_rng(11).choice(B, live,
                                                       replace=False))
    rows = np.zeros((sig_rows.shape[0], B), np.int32)
    rows[:, pos] = sig_rows[:, np.arange(live) % 256]
    got = _verify_equals_plain(card, rows)
    want = np.zeros(B, bool)
    want[pos] = exp[np.arange(live) % 256]
    assert np.array_equal(got.astype(bool), want)


def test_ed25519_verify_kernel_gives_one_result_every_run(card):
    rows, _ = _signed_rows(12, 200)
    r = torch.from_numpy(rows).to(card)
    want = kf.ed25519_verify_plain(r, kf.base_points(card))
    before = kf.ed25519_verify.launches
    outs = [kf.ed25519_verify(r) for _ in range(100)]
    torch.cuda.synchronize()
    assert kf.ed25519_verify.launches == before + 100
    assert all(torch.equal(o, want) for o in outs)


def test_tally_quorum_kernel_equals_plain(card):
    rng = np.random.default_rng(2)
    B, C = 4096, 12
    powers = rng.integers(1, (2**63 - 1) // 8 // B, B)
    counted = rng.random(B) < 0.9
    cids = rng.integers(0, C, B).astype(np.int32)
    valid = (rng.random(B) < 0.8).astype(np.int32)
    th = np.stack([ek.threshold_limbs(int(t))[0]
                   for t in rng.integers(0, 2**60, C)])
    rows = torch.from_numpy(kf.pack_rows(
        ek.pack_batch([], [], [], pad_to=B), ek.power_limbs(powers),
        counted, cids, th)).to(card)
    v = torch.from_numpy(valid).to(card)
    before = kf.tally_quorum.launches
    tk, qk = kf.tally_quorum(v, rows, C)
    tp, qp = kf.tally_quorum_plain(v, rows, C)
    torch.cuda.synchronize()
    assert kf.tally_quorum.launches == before + 1
    assert torch.equal(tk, tp) and torch.equal(qk, qp)


def _tally_call(case, cached, dev):
    """(kernel call, plain call) of one tally entry on a case's inputs."""
    v = torch.from_numpy(case.valid).to(dev)
    r = torch.from_numpy(case.rows).to(dev)
    if cached:
        p5 = torch.from_numpy(case.power5).to(dev)
        return (lambda: ec.tally_quorum_cached(v, r, p5, case.C),
                lambda: ec.tally_quorum_cached_plain(v, r, p5, case.C))
    return (lambda: kf.tally_quorum(v, r, case.C),
            lambda: kf.tally_quorum_plain(v, r, case.C))


@pytest.mark.parametrize("cached", [False, True], ids=["general", "cached"])
@pytest.mark.parametrize("name", [c[0] for c in TALLY_CASES])
def test_tally_kernels_equal_plain_on_every_edge_case(card, name, cached):
    case = tally_edge_case(name, cached)
    kernel, plain = _tally_call(case, cached, card)
    counter = ec.tally_quorum_cached if cached else kf.tally_quorum
    before = counter.launches
    tk, qk = kernel()
    tp, qp = plain()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(tk, tp) and torch.equal(qk, qp)
    assert [int(x) for x in ek.tally_to_int(tk.cpu().numpy())] == case.sums


@pytest.mark.parametrize("cached", [False, True], ids=["general", "cached"])
@pytest.mark.parametrize("name", ["odd_width", "above_smem_cap"])
def test_tally_kernels_give_one_result_every_run(card, name, cached):
    """1,000 launches on one input (atomics from lanes, warps and blocks in
    whatever order they land), each equal to plain and so to one
    another."""
    case = tally_edge_case(name, cached)
    kernel, plain = _tally_call(case, cached, card)
    counter = ec.tally_quorum_cached if cached else kf.tally_quorum
    tp, qp = plain()
    before = counter.launches
    outs = [kernel() for _ in range(1000)]
    torch.cuda.synchronize()
    assert counter.launches == before + 1000
    assert all(torch.equal(t, tp) and torch.equal(q, qp) for t, q in outs)


def _table_keys(seed, n):
    rng = np.random.default_rng(seed)
    pubs = [ed.pubkey_from_seed(rng.bytes(32)) for _ in range(n)]
    pubs += [b"\xff" * 32, b"\x01" * 31, ed.pt_compress(ed.IDENT),
             int.to_bytes(1 | (1 << 255), 32, "little")]
    return pubs


def test_valset_table_build_kernel_equals_plain(card):
    from cometbft_tpu_torch.ops import ed25519_cached as ec

    a_raw, lenok = ec._pack_pub_arrays(_table_keys(3, 40), 128)
    pub = torch.from_numpy(a_raw).to(card)
    ok_len = torch.from_numpy(lenok).to(card)
    before = ec.valset_table_build.launches
    tk, ok_k = ec.valset_table_build(pub, ok_len)
    tp, ok_p = ec.valset_table_build_plain(pub, ok_len)
    torch.cuda.synchronize()
    assert ec.valset_table_build.launches == before + 1
    assert torch.equal(tk, tp) and torch.equal(ok_k, ok_p)


def _table_inputs(card, n, M, seed=7):
    """(pub_raw, lenok) on the card: n keys (the edge keys last) in M
    slots."""
    a_raw, lenok = ec._pack_pub_arrays(_table_keys(seed, n - 4), M)
    return (torch.from_numpy(a_raw).to(card),
            torch.from_numpy(lenok).to(card))


@pytest.mark.parametrize("entry", sorted(ec.TABLE_BUILD_ENTRIES))
@pytest.mark.parametrize("n,M", [(124, 128), (37, 256), (1000, 1024)])
def test_valset_table_build_entries_equal_plain(card, entry, n, M):
    """Every entry of the table build equals the plain build byte for byte
    (edge keys, live keys ending inside a block's group, the stream's
    width), and launching one directly does not count as the wrapper's
    launch."""
    pub, lenok = _table_inputs(card, n, M)
    want_tab, want_ok = ec.valset_table_build_plain(pub, lenok)
    before = ec.valset_table_build.launches
    tab, ok = ec.launch_valset_table_build(pub, lenok, entry)
    torch.cuda.synchronize()
    assert ec.valset_table_build.launches == before
    assert torch.equal(tab, want_tab) and torch.equal(ok, want_ok)


def test_valset_table_build_wrapper_launches_the_entry_it_names(
        card, monkeypatch):
    """At the crossover's last warp width and one validator above it, the
    wrapper launches the entry table_build_entry names, once, and both
    equal the plain build."""
    cap = ec.WARP_MAX_VALS_PER_SM * ec.sm_count(card)
    ran = []
    real = ec.launch_valset_table_build

    def spy(pub, lenok, entry):
        ran.append(entry)
        return real(pub, lenok, entry)

    monkeypatch.setattr(ec, "launch_valset_table_build", spy)
    for M in (cap, cap + 1):
        pub, lenok = _table_inputs(card, 200, M)
        before = ec.valset_table_build.launches
        tab, ok = ec.valset_table_build(pub, lenok)
        want_tab, want_ok = ec.valset_table_build_plain(pub, lenok)
        torch.cuda.synchronize()
        assert ec.valset_table_build.launches == before + 1
        assert torch.equal(tab, want_tab) and torch.equal(ok, want_ok)
    assert ran == ["warp", "quad"]


def test_update_table_through_the_kernel_equals_a_cold_build(card):
    """update_table builds its 128-slot delta through the kernel; the
    patched table equals a cold build of the patched key set."""
    pubs = _table_keys(8, 300)
    table = ec.build_table(pubs, device=card)
    rng = np.random.default_rng(8)
    changes = [(i, ed.pubkey_from_seed(rng.bytes(32)))
               for i in (0, 31, 32, 150, 299, 300, 400, 511)]
    changes.append((77, b"\xff" * 32))
    before = ec.valset_table_build.launches
    patched = ec.update_table(table, changes)
    torch.cuda.synchronize()
    assert ec.valset_table_build.launches == before + 1
    new = list(pubs) + [b""] * (table.n_vals - len(pubs))
    for i, p in changes:
        new[i] = p
    cold = ec.build_table(new, device=card)
    assert torch.equal(patched.tab, cold.tab)
    assert torch.equal(patched.ok, cold.ok)


def test_valset_table_build_gives_one_result_every_run(card):
    pub, lenok = _table_inputs(card, 1000, 1024, seed=9)
    before = ec.valset_table_build.launches
    outs = [ec.valset_table_build(pub, lenok) for _ in range(2)]
    torch.cuda.synchronize()
    assert ec.valset_table_build.launches == before + 2
    assert all(torch.equal(t, outs[0][0]) and torch.equal(o, outs[0][1])
               for t, o in outs)


def test_ed25519_verify_cached_kernel_equals_plain(card):
    from cometbft_tpu_torch.ops import ed25519_cached as ec

    rng = np.random.default_rng(4)
    seeds = [rng.bytes(32) for _ in range(100)]
    pubs = [ed.pubkey_from_seed(s) for s in seeds]
    msgs = [rng.bytes(int(rng.integers(0, 60))) for _ in range(100)]
    sigs = [ed.sign(s, m) for s, m in zip(seeds, msgs)]
    for i in range(0, 100, 6):
        sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 8]) + sigs[i][41:]
    for i in range(2, 100, 9):
        msgs[i] += b"!"
    pubs[7] = b"\xff" * 32
    table = ec.build_table(pubs, device=card)
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=256)
    rows = torch.from_numpy(ec.pack_rows_cached(pb)).to(card)
    before = ec.ed25519_verify_cached.launches
    got = ec.ed25519_verify_cached(rows, table.tab, table.ok)
    want = ec.ed25519_verify_cached_plain(rows, table.tab, table.ok,
                                          kf.base_points(card))
    torch.cuda.synchronize()
    assert ec.ed25519_verify_cached.launches == before + 1
    assert torch.equal(got, want)
    exp = [ed.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert got.cpu().numpy()[:100].astype(bool).tolist() == exp


def _cached_fixture():
    """128 packed cached columns over a 128-slot table: 60 signed rows
    (one in six tampered, S >= L on three, an undecodable and a short key
    whose ok is False) and 68 padding columns; -> (rows, table on the CPU,
    oracle verdict of each column)."""
    rng = np.random.default_rng(14)
    seeds = [rng.bytes(32) for _ in range(60)]
    pubs = [ed.pubkey_from_seed(s) for s in seeds]
    msgs = [rng.bytes(int(rng.integers(0, 60))) for _ in range(60)]
    sigs = [ed.sign(s, m) for s, m in zip(seeds, msgs)]
    for i in range(0, 60, 6):
        sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 8]) + sigs[i][41:]
    for i in (5, 29, 47):
        s = int.from_bytes(sigs[i][32:], "little") + ed.L
        sigs[i] = sigs[i][:32] + int.to_bytes(s, 32, "little")
    pubs[7] = b"\x02" + bytes(31)  # y = 2 is not on the curve
    pubs[13] = pubs[13][:31]
    table = ec.build_table(pubs, device="cpu")
    assert table.n_vals == 128 and not table.ok[7] and not table.ok[13]
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=128)
    exp = np.zeros(128, bool)
    exp[:60] = [len(p) == 32 and ed.verify(p, m, s)
                 for p, m, s in zip(pubs, msgs, sigs)]
    return ec.pack_rows_cached(pb), table, exp


@pytest.fixture(scope="module")
def cached_fixture():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (torch.cuda is unavailable)")
    return _cached_fixture()


def _cached_on(card, fixture, B):
    """The fixture's columns tiled to B (B > 128 wraps col mod M), on the
    card, with the plain verdicts and the oracle's."""
    rows, table, exp = fixture
    reps = -(-B // rows.shape[1])
    r = torch.from_numpy(np.ascontiguousarray(
        np.tile(rows, (1, reps))[:, :B])).to(card)
    tab, ok = table.tab.to(card), table.ok.to(card)
    want = ec.ed25519_verify_cached_plain(r, tab, ok, kf.base_points(card))
    return r, tab, ok, want, np.tile(exp, reps)[:B]


@pytest.mark.parametrize("B", [1, 17, 256, 512])
def test_ed25519_verify_cached_kernel_edge_shapes(card, cached_fixture, B):
    """B = 1, a B that is not a multiple of a block's 16 columns, and B
    above M = 128, over dead columns, failed prechecks and ok False
    slots: one launch of the entry the wrapper names, equal to plain and
    to the oracle."""
    r, tab, ok, want, exp = _cached_on(card, cached_fixture, B)
    before = ec.ed25519_verify_cached.launches
    got = ec.ed25519_verify_cached(r, tab, ok)
    torch.cuda.synchronize()
    assert ec.ed25519_verify_cached.launches == before + 1
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy().astype(bool), exp)


@pytest.mark.parametrize("entry", sorted(ec.VERIFY_CACHED_ENTRIES))
@pytest.mark.parametrize("B", [17, 512])
def test_ed25519_verify_cached_entries_equal_plain(card, cached_fixture,
                                                   entry, B):
    """Every C entry of the cached verify gives the plain verdicts, and
    launching one directly does not count as the wrapper's launch."""
    r, tab, ok, want, _ = _cached_on(card, cached_fixture, B)
    before = ec.ed25519_verify_cached.launches
    got = ec.launch_verify_cached(r, tab, ok, entry)
    torch.cuda.synchronize()
    assert ec.ed25519_verify_cached.launches == before
    assert torch.equal(got, want)


def test_ed25519_verify_cached_wrapper_launches_the_entry_it_names(
        card, cached_fixture, monkeypatch):
    """At the crossover's last quad width and one column above it, the
    wrapper launches the entry verify_cached_entry names, once, and both
    give the plain verdicts."""
    cap = ec.QUAD_MAX_COLS_PER_SM * ec.sm_count(card)
    ran = []
    real = ec.launch_verify_cached

    def spy(rows, tab, ok, entry):
        ran.append(entry)
        return real(rows, tab, ok, entry)

    monkeypatch.setattr(ec, "launch_verify_cached", spy)
    for B in (cap, cap + 1):
        r, tab, ok, want, exp = _cached_on(card, cached_fixture, B)
        before = ec.ed25519_verify_cached.launches
        got = ec.ed25519_verify_cached(r, tab, ok)
        torch.cuda.synchronize()
        assert ec.ed25519_verify_cached.launches == before + 1
        assert torch.equal(got, want)
        assert np.array_equal(got.cpu().numpy().astype(bool), exp)
    assert ran == ["quad", "thread"]


def test_ed25519_verify_cached_kernel_gives_one_result_every_run(
        card, cached_fixture):
    r, tab, ok, want, _ = _cached_on(card, cached_fixture, 512)
    before = ec.ed25519_verify_cached.launches
    outs = [ec.ed25519_verify_cached(r, tab, ok) for _ in range(2)]
    torch.cuda.synchronize()
    assert ec.ed25519_verify_cached.launches == before + 2
    assert all(torch.equal(o, want) for o in outs)


def test_tally_quorum_cached_kernel_equals_plain(card):
    from cometbft_tpu_torch.ops import ed25519_cached as ec

    rng = np.random.default_rng(5)
    M, C = 256, 8
    B = M * C
    power5 = torch.from_numpy(ek.power_limbs(
        rng.integers(1, 2**50, M))).to(card)
    flags = ((rng.random(B) < 0.9).astype(np.int32) << 2) | (
        np.repeat(np.arange(C, dtype=np.int32), M) << 3)
    rows = np.zeros(ec.packed_rows_shape(B, C), np.int32)
    rows[ec.V_FLAGS] = flags
    rows[ec.V_THRESH:].reshape(-1)[:C * 6] = np.stack(
        [ek.threshold_limbs(int(t))[0]
         for t in rng.integers(0, 2**57, C)]).reshape(-1)
    r = torch.from_numpy(rows).to(card)
    v = torch.from_numpy((rng.random(B) < 0.8).astype(np.int32)).to(card)
    before = ec.tally_quorum_cached.launches
    tk, qk = ec.tally_quorum_cached(v, r, power5, C)
    tp, qp = ec.tally_quorum_cached_plain(v, r, power5, C)
    torch.cuda.synchronize()
    assert ec.tally_quorum_cached.launches == before + 1
    assert torch.equal(tk, tp) and torch.equal(qk, qp)


def test_stamp_rows_kernel_equals_plain(card):
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_stamp as es
    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.vote import sign_bytes_template

    rng = np.random.default_rng(6)
    secs = [0, 1, 127, 128, 16383, 16384, 1_700_000_000, 2**31 - 1, 2**31,
            2**40, 2**62, -1, -2**33]
    nanos = [0, 1, 127, 128, 999_999_999, 5, 42, -7]
    tmpls = [sign_bytes_template("c" * 30, canonical.PRECOMMIT_TYPE, 9 + t,
                                 0, bid) for t, bid in enumerate(
        [None, BlockID(b"\x55" * 32, PartSetHeader(9, b"\x66" * 32))])]
    ent = es.template_entry([t.stamp_site() for t in tmpls], card)
    B, n = 256, 200
    sig = np.zeros((B, 64), np.uint8)
    sig[:n] = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    ts = np.zeros((B, 3), np.int32)
    ts[:n] = canonical.split_ts_words(
        [secs[i % len(secs)] for i in range(n)],
        [nanos[i % len(nanos)] for i in range(n)])
    fl = np.zeros(B, np.int32)
    fl[:n] = 1 | (rng.integers(0, 2, n) << 1) | (rng.integers(0, 2, n) << 2) \
        | (rng.integers(0, 5, n) << 10)
    pub = torch.from_numpy(rng.integers(0, 256, (128, 32),
                                        dtype=np.uint8)).to(card)
    thr = torch.from_numpy(ek.threshold_limbs(12345, 5)).to(card)
    t_rows = ec.packed_rows_shape(B, 5)[0] - ec.V_THRESH
    args = [torch.from_numpy(a).to(card) for a in (sig, ts, fl)]
    before = es.stamp_rows.launches
    got = es.stamp_rows(*args, ent, pub, thr, t_rows)
    want = es.stamp_rows_plain(*args, ent.pre_mat, ent.pre_len, ent.suf_mat,
                               ent.suf_len, ent.ts_tag, pub, thr,
                               ent.msg_max, t_rows)
    torch.cuda.synchronize()
    assert es.stamp_rows.launches == before + 1
    assert torch.equal(got, want)


def _stamp_both(card, dsig, dts, dfl, sites, pub_raw, thresh, t_rows):
    """One stamp_rows launch (exactly one) and its plain version on the
    same card tensors; -> (kernel rows, plain rows) on the host."""
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    ent = es.template_entry(sites, card)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(card)
            for a in (dsig, dts, dfl)]
    pub = torch.from_numpy(np.ascontiguousarray(pub_raw)).to(card)
    thr = torch.from_numpy(np.ascontiguousarray(thresh, np.int32)).to(card)
    before = es.stamp_rows.launches
    got = es.stamp_rows(*args, ent, pub, thr, t_rows)
    want = es.stamp_rows_plain(*args, ent.pre_mat, ent.pre_len, ent.suf_mat,
                               ent.suf_len, ent.ts_tag, pub, thr,
                               ent.msg_max, t_rows)
    torch.cuda.synchronize()
    assert es.stamp_rows.launches == before + 1
    return got.cpu().numpy(), want.cpu().numpy()


@pytest.mark.parametrize("name,B", [(n, 256) for n in STAMP_CASES]
                         + [("sweep", 200), ("sweep", 1000)])
def test_stamp_rows_kernel_on_the_stamp_cases(card, name, B):
    """The chain-id sweep and its twists (edge_cases.STAMP_CASES), also at
    ragged widths: kernel == plain == the host pack, byte for byte."""
    case = stamp_case(name, B)
    got, want = _stamp_both(card, case.dsig, case.dts, case.dfl, case.sites,
                            case.pub_raw, case.thresh,
                            case.ref.shape[0] - ec.V_THRESH)
    assert np.array_equal(got, want) and np.array_equal(got, case.ref)


def _stream_stamp_input(B, seed):
    """Deltas at the blocksync stream's stamp shape: a commit of 1,000
    live precommits every 1,024 columns (its own height, so its own
    template), keys of a 1,024-validator set, realistic timestamps."""
    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.vote import sign_bytes_template

    rng = np.random.default_rng(seed)
    C = B // 1024
    tmpls = [sign_bytes_template(
        "chip-smoke", canonical.PRECOMMIT_TYPE, 1 + c, 0,
        BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32))))
        for c in range(C)]
    col = np.arange(B)
    live = col % 1024 < 1000
    secs = 1_700_000_000 + col // 1024
    nanos = rng.integers(0, 10**9, B)
    dts = canonical.split_ts_words(secs, nanos)
    dfl = np.where(live, 1 | ((rng.random(B) < 0.9).astype(np.int32) << 1)
                   | ((col // 1024) << 2) | ((col // 1024) << 10),
                   0).astype(np.int32)
    dsig = rng.integers(0, 256, (B, 64), dtype=np.uint8)
    dsig[:, 63] &= 0x0f
    keys = rng.integers(0, 256, (1024, 32), dtype=np.uint8)
    thresh = np.stack([ek.threshold_limbs(667_000 + c)[0] for c in range(C)])
    t_rows = ec.packed_rows_shape(B, C)[0] - ec.V_THRESH
    return (dsig, dts, dfl, [t.stamp_site() for t in tmpls], keys, thresh,
            t_rows)


@pytest.mark.parametrize("B", [65_536, 16_384])
def test_stamp_rows_kernel_at_the_stream_shapes(card, B):
    """The stream's two stamp launches: 64,000 live rows in 65,536 columns
    and 16,000 in 16,384."""
    got, want = _stamp_both(card, *_stream_stamp_input(B, 7))
    assert np.array_equal(got, want)
    assert (got[:ec.V_THRESH, np.arange(B) % 1024 >= 1000] == 0).all()


def test_stamp_rows_kernel_repeated_launches(card):
    """100 launches on one input: every one counted, every result equal
    to plain."""
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    case = stamp_case("dead")
    ent = es.template_entry(case.sites, card)
    args = [torch.from_numpy(a).to(card)
            for a in (case.dsig, case.dts, case.dfl)]
    pub = torch.from_numpy(case.pub_raw).to(card)
    thr = torch.from_numpy(case.thresh.astype(np.int32)).to(card)
    t_rows = case.ref.shape[0] - ec.V_THRESH
    before = es.stamp_rows.launches
    outs = [es.stamp_rows(*args, ent, pub, thr, t_rows) for _ in range(100)]
    torch.cuda.synchronize()
    assert es.stamp_rows.launches == before + 100
    want = torch.from_numpy(case.ref).to(card)
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("operand", ["sig", "pub_raw"])
def test_stamp_rows_refuses_a_misaligned_operand(card, operand):
    """A view that is not 16-byte aligned raises before any launch."""
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    case = stamp_case("sweep")
    ent = es.template_entry(case.sites, card)
    sig, ts, fl = (torch.from_numpy(a).to(card)
                   for a in (case.dsig, case.dts, case.dfl))
    pub = torch.from_numpy(case.pub_raw).to(card)

    def shifted(t):  # the same bytes, 8 bytes into a fresh buffer
        buf = torch.zeros(t.numel() + 8, dtype=t.dtype, device=card)
        view = buf[8:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 8
        return view

    if operand == "sig":
        sig = shifted(sig)
    else:
        pub = shifted(pub)
    thr = torch.from_numpy(case.thresh.astype(np.int32)).to(card)
    before = es.stamp_rows.launches
    with pytest.raises(ValueError, match="aligned"):
        es.stamp_rows(sig, ts, fl, ent, pub, thr,
                      case.ref.shape[0] - ec.V_THRESH)
    assert es.stamp_rows.launches == before


def _stamp_general_both(card, dsig, dkey, dts, dfl, power, sites, thresh,
                        t_rows):
    """One stamp_rows_general launch (exactly one) and its plain version on
    the same card tensors; -> (kernel rows, plain rows) on the host."""
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    ent = es.template_entry(sites, card)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(card)
            for a in (dsig, dkey, dts, dfl, power)]
    thr = torch.from_numpy(np.ascontiguousarray(thresh, np.int32)).to(card)
    before = es.stamp_rows_general.launches
    got = es.stamp_rows_general(*args, ent, thr, t_rows)
    want = es.stamp_rows_general_plain(
        *args, ent.pre_mat, ent.pre_len, ent.suf_mat, ent.suf_len,
        ent.ts_tag, thr, ent.msg_max, t_rows)
    torch.cuda.synchronize()
    assert es.stamp_rows_general.launches == before + 1
    return got.cpu().numpy(), want.cpu().numpy()


@pytest.mark.parametrize("name,B", [(n, 256) for n in STAMP_CASES]
                         + [("sweep", 200), ("dead", 1000)])
def test_stamp_rows_general_kernel_on_the_stamp_cases(card, name, B):
    """The general stamp on the stamp cases in the general layout
    (edge_cases.stamp_general_case), also at ragged widths: kernel ==
    plain == kf.pack_rows of the host pack, byte for byte."""
    case = stamp_general_case(name, B)
    got, want = _stamp_general_both(card, case.dsig, case.key, case.dts,
                                    case.dfl, case.power, case.sites,
                                    case.thresh, case.t_rows)
    assert np.array_equal(got, want) and np.array_equal(got, case.ref)


def test_stamp_rows_general_kernel_at_the_stream_shape(card):
    """The general stream chunk: 64 commits of 1,000 live precommits
    (each its own height and template), 64,000 live rows in 65,536
    columns, the padding in the sink commit 64."""
    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.vote import sign_bytes_template

    rng = np.random.default_rng(8)
    B, C, n = 65_536, 64, 64_000
    tmpls = [sign_bytes_template(
        "portbench-chain", canonical.PRECOMMIT_TYPE, 1 + c, 0,
        BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32))))
        for c in range(C)]
    cid = np.minimum(np.arange(B) // 1000, C)
    live = np.arange(B) < n
    dts = canonical.split_ts_words(1_700_000_000 + cid,
                                   rng.integers(0, 10**9, B))
    dfl = np.where(live, 3 | (cid << 2), 0) | (cid << 10)
    dsig = rng.integers(0, 256, (B, 64), dtype=np.uint8)
    dkey = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    power = rng.integers(1, 10**6, B, dtype=np.int64)
    thresh = np.stack([ek.threshold_limbs(667_000 + c)[0]
                       for c in range(C + 1)])
    got, want = _stamp_general_both(
        card, dsig, dkey, dts, dfl.astype(np.int32), power,
        [t.stamp_site() for t in tmpls], thresh, 1)
    assert np.array_equal(got, want)
    assert (got[kf.C_CID] == cid).all()
    assert not got[:kf.C_CID, ~live].any()


@pytest.mark.parametrize("operand", ["sig", "key"])
def test_stamp_rows_general_refuses_a_misaligned_operand(card, operand):
    """A view that is not 16-byte aligned raises before any launch."""
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    case = stamp_general_case("sweep")
    ent = es.template_entry(case.sites, card)
    sig, key, ts, fl, power = (
        torch.from_numpy(a).to(card)
        for a in (case.dsig, case.key, case.dts, case.dfl, case.power))

    def shifted(t):  # the same bytes, 8 bytes into a fresh buffer
        buf = torch.zeros(t.numel() + 8, dtype=t.dtype, device=card)
        view = buf[8:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 8
        return view

    if operand == "sig":
        sig = shifted(sig)
    else:
        key = shifted(key)
    thr = torch.from_numpy(case.thresh.astype(np.int32)).to(card)
    before = es.stamp_rows_general.launches
    with pytest.raises(ValueError, match="aligned"):
        es.stamp_rows_general(sig, key, ts, fl, power, ent, thr,
                              case.t_rows)
    assert es.stamp_rows_general.launches == before


def test_stream_general_chunk_stamps_on_the_card(card):
    """A chunk of two validator sets on the card's StreamVerifier: one
    stamp_rows_general launch, no host pack, and the verdicts of the
    same chunk packed on the host."""
    from cometbft_tpu_torch.blocksync import pipeline as bp
    from cometbft_tpu_torch.crypto.keys import PubKey
    from cometbft_tpu_torch.ops import ed25519_stamp as es
    from cometbft_tpu_torch.types import commit as tcommit
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

    rng = np.random.default_rng(9)
    sets = []
    for n in (40, 56):
        seeds = [rng.bytes(32) for _ in range(n)]
        pubs = [ed.sign_many(s, [])[0] for s in seeds]
        vs = ValidatorSet([Validator(PubKey(p), 1000 - i)
                           for i, p in enumerate(pubs)])
        seed_of = dict(zip(pubs, seeds))
        sets.append((vs, [seed_of[v.pub_key.data] for v in vs.validators]))
    jobs = []
    for h in range(1, 7):
        vs, seeds = sets[h % 2]
        bid = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
        sigs = [tcommit.CommitSig(tcommit.BLOCK_ID_FLAG_COMMIT, v.address,
                                  Timestamp(1_700_000_000 + h, 7 * i))
                for i, v in enumerate(vs.validators)]
        c = tcommit.Commit(h, 0, bid, sigs)
        for cs, s, m in zip(sigs, seeds, c.sign_bytes_rows("card-chain")):
            cs.signature = ed.sign(s, m)
        if h == 3:
            sig = sigs[5].signature
            sigs[5].signature = sig[:9] + bytes([sig[9] ^ 4]) + sig[10:]
        jobs.append(bp.CommitJob(vs, bid, h, c, "card-chain"))
    before = es.stamp_rows_general.launches
    sv = bp.StreamVerifier(device=card)
    got = [None if e is None else (type(e).__name__, getattr(e, "idx", None))
           for e in sv.verify(jobs)]
    torch.cuda.synchronize()
    assert es.stamp_rows_general.launches == before + 1
    assert sv.stats["general_stamped_chunks"] == 1
    assert sv.stats["stage_ms"]["pack"] == [0.0]
    assert got == [None, None, ("InvalidSignatureError", 5), None, None,
                   None]
    host = bp.StreamVerifier(device=card)
    host._stamp_general = lambda *a: None
    assert [None if e is None else (type(e).__name__, getattr(e, "idx", None))
            for e in host.verify(jobs)] == got
    assert host.stats["general_stamped_chunks"] == 0


def test_sr25519_verify_kernel_equals_plain(card):
    from cometbft_tpu_torch.crypto import sr25519_ref as sr
    from cometbft_tpu_torch.edge_cases import sr25519_cases
    from cometbft_tpu_torch.ops import sr25519_kernel as srk

    pubs, msgs, sigs = sr25519_cases(np.random.default_rng(7), n_valid=100)
    rows = torch.from_numpy(srk.pack_batch_sr(pubs, msgs, sigs,
                                              pad_to=256)).to(card)
    before = srk.sr25519_verify.launches
    got = srk.sr25519_verify(rows)
    want = srk.sr25519_verify_plain(rows, kf.base_points(card))
    torch.cuda.synchronize()
    assert srk.sr25519_verify.launches == before + 1
    assert torch.equal(got, want)
    exp = [sr.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert got.cpu().numpy()[:len(pubs)].astype(bool).tolist() == exp
    assert not got.cpu().numpy()[len(pubs):].any()


def _sr_signed(seed, n):
    """n signed sr25519 (pub, msg, sig) rows, one in seven tampered."""
    from cometbft_tpu_torch.crypto import sr25519_ref as sr

    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        m = rng.bytes(int(rng.integers(0, 64)))
        pub, (sig,) = sr.sign_many(rng.bytes(32), [m], rng=rng.bytes(32))
        if i % 7 == 3:
            sig = sig[:9] + bytes([sig[9] ^ 4]) + sig[10:]
        pubs.append(pub)
        msgs.append(m)
        sigs.append(sig)
    return pubs, msgs, sigs


def _sr_oracle(pubs, msgs, sigs):
    from cometbft_tpu_torch.crypto import sr25519_ref as sr

    return np.array([sr.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)],
                    bool)


def _sr_verify_equals_plain(card, rows):
    """One sr25519 kernel call (exactly one launch) on rows, equal to
    plain; -> the verdicts."""
    from cometbft_tpu_torch.ops import sr25519_kernel as srk

    r = torch.from_numpy(np.ascontiguousarray(rows)).to(card)
    before = srk.sr25519_verify.launches
    got = srk.sr25519_verify(r)
    want = srk.sr25519_verify_plain(r, kf.base_points(card))
    torch.cuda.synchronize()
    assert srk.sr25519_verify.launches == before + 1
    assert torch.equal(got, want)
    return got.cpu().numpy()


@pytest.mark.parametrize("name,B", [("edge_cases", 256),
                                    ("edge_cases", 4096), ("ragged", 17),
                                    ("one", 1), ("all_padding", 64)])
def test_sr25519_verify_kernel_edge_shapes(card, name, B):
    """Every sr25519 edge case (tampered message, missing marker, s >= L,
    odd, non-canonical and non-decodable A and R, short key and signature)
    at 256 and 4,096 columns, a B that is not a multiple of a block's 16
    signatures, B = 1 and a batch of padding only."""
    from cometbft_tpu_torch.edge_cases import sr25519_cases
    from cometbft_tpu_torch.ops import sr25519_kernel as srk

    if name == "edge_cases":
        pubs, msgs, sigs = sr25519_cases(np.random.default_rng(B),
                                         n_valid=100)
    elif name == "all_padding":
        pubs, msgs, sigs = [], [], []
    else:
        pubs, msgs, sigs = _sr_signed(B, 13 if name == "ragged" else 1)
    got = _sr_verify_equals_plain(card, srk.pack_batch_sr(pubs, msgs, sigs,
                                                          pad_to=B))
    assert np.array_equal(got[:len(pubs)].astype(bool),
                          _sr_oracle(pubs, msgs, sigs))
    assert not got[len(pubs):].any()


@pytest.mark.parametrize("live,B,spread", [(5_000, 16_384, False),
                                           (3_334, 4_096, False),
                                           (5_000, 16_384, True)])
def test_sr25519_verify_kernel_at_the_main_paths_shapes(card, live, B,
                                                        spread):
    """The mixed commit's sr25519 shapes: 5,000 live of 16,384 columns (the
    full call) and 3,334 of 4,096 (the light call), live columns first and
    padding last, as the packer puts them, or scattered among the padding.
    256 signed columns are tiled to the live count."""
    from cometbft_tpu_torch.ops import sr25519_kernel as srk

    pubs, msgs, sigs = _sr_signed(20, 256)
    sig_rows = srk.pack_batch_sr(pubs, msgs, sigs, pad_to=256)
    exp = _sr_oracle(pubs, msgs, sigs)
    pos = np.arange(live)
    if spread:
        pos = np.sort(np.random.default_rng(21).choice(B, live,
                                                       replace=False))
    rows = np.zeros((sig_rows.shape[0], B), np.int32)
    rows[:, pos] = sig_rows[:, np.arange(live) % 256]
    got = _sr_verify_equals_plain(card, rows)
    want = np.zeros(B, bool)
    want[pos] = exp[np.arange(live) % 256]
    assert np.array_equal(got.astype(bool), want)


def test_sr25519_verify_kernel_gives_one_result_every_run(card):
    from cometbft_tpu_torch.ops import sr25519_kernel as srk

    pubs, msgs, sigs = _sr_signed(22, 200)
    r = torch.from_numpy(srk.pack_batch_sr(pubs, msgs, sigs,
                                           pad_to=256)).to(card)
    want = srk.sr25519_verify_plain(r, kf.base_points(card))
    assert np.array_equal(want.cpu().numpy()[:200].astype(bool),
                          _sr_oracle(pubs, msgs, sigs))
    before = srk.sr25519_verify.launches
    outs = [srk.sr25519_verify(r) for _ in range(100)]
    torch.cuda.synchronize()
    assert srk.sr25519_verify.launches == before + 100
    assert all(torch.equal(o, want) for o in outs)


def test_ecdsa_verify_kernel_equals_plain(card):
    from cometbft_tpu_torch.crypto import secp256k1_ref as secp
    from cometbft_tpu_torch.edge_cases import ecdsa_cases
    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.ops import ecdsa_kernel as eck

    pubs, msgs, sigs = ecdsa_cases(np.random.default_rng(8), n_valid=100)
    rows = torch.from_numpy(ef.pack_rows(eck.pack_batch(
        pubs, msgs, sigs, pad_to=256))).to(card)
    before = ef.ecdsa_verify.launches
    got = ef.ecdsa_verify(rows)
    want = ef.ecdsa_verify_plain(rows, ef.base_points(card))
    torch.cuda.synchronize()
    assert ef.ecdsa_verify.launches == before + 1
    assert torch.equal(got, want)
    exp = [secp.verify_py(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert got.cpu().numpy()[:len(pubs)].astype(bool).tolist() == exp
    assert not got.cpu().numpy()[len(pubs):].any()


def _ec_signed(seed, n):
    """n signed secp256k1 (pub, msg, sig) rows, one in seven tampered."""
    from cometbft_tpu_torch.crypto import secp256k1_ref as secp

    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        d = int(rng.integers(1, 2**62)) * int(rng.integers(1, 2**62))
        m = rng.bytes(int(rng.integers(0, 64)))
        sig = secp.sign(d, m)
        if i % 7 == 3:
            sig = sig[:9] + bytes([sig[9] ^ 4]) + sig[10:]
        pubs.append(secp.pubkey_from_secret(d))
        msgs.append(m)
        sigs.append(sig)
    return pubs, msgs, sigs


def _ec_oracle(pubs, msgs, sigs):
    from cometbft_tpu_torch.crypto import secp256k1_ref as secp

    return np.array([secp.verify_py(p, m, s)
                     for p, m, s in zip(pubs, msgs, sigs)], bool)


def _ec_rows(pubs, msgs, sigs, B):
    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.ops import ecdsa_kernel as eck

    return ef.pack_rows(eck.pack_batch(pubs, msgs, sigs, pad_to=B))


def _ec_verify_equals_plain(card, rows):
    """One ECDSA kernel call (exactly one launch) on rows, equal to plain;
    -> the verdicts."""
    from cometbft_tpu_torch.ops import ecdsa_fused as ef

    r = torch.from_numpy(np.ascontiguousarray(rows)).to(card)
    before = ef.ecdsa_verify.launches
    got = ef.ecdsa_verify(r)
    want = ef.ecdsa_verify_plain(r, ef.base_points(card))
    torch.cuda.synchronize()
    assert ef.ecdsa_verify.launches == before + 1
    assert torch.equal(got, want)
    return got.cpu().numpy()


@pytest.mark.parametrize("name,B", [("edge_cases", 256), ("signed", 65),
                                    ("signed", 64), ("ragged", 17),
                                    ("one", 1), ("all_padding", 64)])
def test_ecdsa_verify_kernel_edge_shapes(card, name, B):
    """Every ECDSA edge case (tampered signature and message, high S, r = 0,
    r >= N, s = 0, bad prefix, x >= p, x off the curve, short key and
    signature, the r + N branch) at 256 columns, 64 and 65 columns (a
    block's 16 signatures, and one more), a B that is not a multiple of
    16, B = 1 and a batch of padding only."""
    from cometbft_tpu_torch.edge_cases import ecdsa_cases

    if name == "edge_cases":
        pubs, msgs, sigs = ecdsa_cases(np.random.default_rng(B),
                                       n_valid=100)
    elif name == "all_padding":
        pubs, msgs, sigs = [], [], []
    else:
        pubs, msgs, sigs = _ec_signed(B, {"signed": B, "ragged": 13,
                                          "one": 1}[name])
    got = _ec_verify_equals_plain(card, _ec_rows(pubs, msgs, sigs, B))
    assert np.array_equal(got[:len(pubs)].astype(bool),
                          _ec_oracle(pubs, msgs, sigs))
    assert not got[len(pubs):].any()


@pytest.mark.parametrize("live,B,spread", [(6_667, 16_384, False),
                                           (3_334, 4_096, False),
                                           (6_667, 16_384, True)])
def test_ecdsa_verify_kernel_at_the_main_paths_shapes(card, live, B, spread):
    """The secp256k1 light pair's shapes: 6,667 live of 16,384 columns (the
    light call) and 3,334 of 4,096 (the trusting call), live columns first
    and padding last, as the packer puts them, or scattered among the
    padding. 256 signed columns are tiled to the live count."""
    pubs, msgs, sigs = _ec_signed(30, 256)
    sig_rows = _ec_rows(pubs, msgs, sigs, 256)
    exp = _ec_oracle(pubs, msgs, sigs)
    pos = np.arange(live)
    if spread:
        pos = np.sort(np.random.default_rng(31).choice(B, live,
                                                       replace=False))
    rows = np.zeros((sig_rows.shape[0], B), np.int32)
    rows[:, pos] = sig_rows[:, np.arange(live) % 256]
    got = _ec_verify_equals_plain(card, rows)
    want = np.zeros(B, bool)
    want[pos] = exp[np.arange(live) % 256]
    assert np.array_equal(got.astype(bool), want)


def test_ecdsa_verify_kernel_gives_one_result_every_run(card):
    from cometbft_tpu_torch.ops import ecdsa_fused as ef

    pubs, msgs, sigs = _ec_signed(32, 200)
    r = torch.from_numpy(_ec_rows(pubs, msgs, sigs, 256)).to(card)
    want = ef.ecdsa_verify_plain(r, ef.base_points(card))
    assert np.array_equal(want.cpu().numpy()[:200].astype(bool),
                          _ec_oracle(pubs, msgs, sigs))
    before = ef.ecdsa_verify.launches
    outs = [ef.ecdsa_verify(r) for _ in range(100)]
    torch.cuda.synchronize()
    assert ef.ecdsa_verify.launches == before + 100
    assert all(torch.equal(o, want) for o in outs)


def test_native_pack_builds_here_and_equals_plain_at_16384_rows(card):
    """The native host packer builds with this machine's C++ compiler, and
    pack_batch through it equals the numpy plain version at a 10k commit's
    padded width, 16,384 rows of 150-170-byte messages."""
    from cometbft_tpu_torch.ops import _build

    assert _build.native_lib().hostaccel_abi_version() == _build.NATIVE_ABI
    rng = np.random.default_rng(40)
    n = 16_384
    pubs = [rng.bytes(32) for _ in range(n)]
    sigs = [rng.bytes(64) for _ in range(n)]
    msgs = [rng.bytes(int(k)) for k in rng.integers(150, 171, n)]
    got = ek.pack_batch(pubs, msgs, sigs, pad_to=n)
    want = ek.pack_batch(pubs, msgs, sigs, pad_to=n, native=False)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the verify plane on the card (-k plane)
# ---------------------------------------------------------------------------

PLANE_VALS = 40


def _plane_stream():
    """PLANE_VALS precommits of one height, signed with the port's oracle
    (one tampered, one not counted), as VoteSet submits them: counted, with
    the validator index and the device stamp metadata, in one QuorumGroup
    backed by the valset. Returns (submit_many kwargs, group, verdicts,
    power of the counted valid votes)."""
    from cometbft_tpu_torch.crypto.keys import PubKey
    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.vote import sign_bytes_template
    from cometbft_tpu_torch.verifyplane import QuorumGroup

    rng = np.random.default_rng(50)
    seeds = [rng.bytes(32) for _ in range(PLANE_VALS)]
    pubs = tuple(ed.sign_many(s, [])[0] for s in seeds)
    powers = tuple(int(p) for p in rng.integers(1, 1000, PLANE_VALS))
    bid = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
    tpl = sign_bytes_template("plane-card", canonical.PRECOMMIT_TYPE, 9, 0,
                              bid)
    secs = [1_700_000_000 + i for i in range(PLANE_VALS)]
    nanos = [i * 7919 for i in range(PLANE_VALS)]
    msgs = tpl.patch_rows(secs, nanos).tolist()
    group = QuorumGroup(sum(powers) * 2 // 3 + 1, "h9",
                        valset_pubs=pubs, valset_powers=powers)
    subs, exp, power = [], [], 0
    for v, (seed, m) in enumerate(zip(seeds, msgs)):
        sig = ed.sign_many(seed, [m])[1][0]
        if v == 11:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        subs.append(dict(rows=[(PubKey(pubs[v]), m, sig)],
                         power=powers[v], group=group, counted=v != 17,
                         vidx=[v], stamp=[(tpl, secs[v], nanos[v])]))
        ok = ed.verify(pubs[v], m, sig)
        exp.append((ok,))
        power += powers[v] if ok and v != 17 else 0
    return subs, group, exp, power


def _plane_launches():
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    return (es.stamp_rows.launches, ec.valset_table_build.launches,
            ec.ed25519_verify_cached.launches,
            ec.tally_quorum_cached.launches)


def _drive_plane(plane, subs):
    plane.start()
    try:
        with plane._cv:
            futs = [plane.submit_many(**s) for s in subs]
        return [f.result(120.0) for f in futs]
    finally:
        plane.stop()


@pytest.mark.parametrize("stamping", [True, False],
                         ids=["device_stamped", "host_packed"])
def test_plane_fused_flush_on_the_card(card, stamping):
    """One flush of a height's precommits through a plane on the card: the
    oracle's verdicts, the exact tally, the quorum bit, path fused, the
    stamp column, and one launch of each kernel of the flush."""
    from cometbft_tpu_torch.crypto.batch import CircuitBreaker
    from cometbft_tpu_torch.ops import table_cache as tc
    from cometbft_tpu_torch.verifyplane import VerifyPlane
    from cometbft_tpu_torch.verifyplane import fused as fz

    tc.reset_for_tests()
    subs, group, exp, power = _plane_stream()
    brk = CircuitBreaker()
    plane = VerifyPlane(window_ms=1.0, max_batch=4096, breaker=brk)
    assert plane.device == card
    before = _plane_launches()
    fz.set_device_stamping(stamping)
    try:
        got = _drive_plane(plane, subs)
    finally:
        fz.set_device_stamping(True)
    torch.cuda.synchronize()
    after = _plane_launches()
    assert got == exp
    assert group.tally == power
    assert group.quorum_reached == (power >= group.threshold)
    rec, = plane.ledger.records()
    assert (rec["path"], rec["stamp"], rec["warm"]) == (
        "fused", "device" if stamping else "host", 0)
    assert rec["dev_ms"] > 0
    assert [a - b for a, b in zip(after, before)] == [int(stamping), 1, 1, 1]
    assert brk.faults == 0


def test_plane_readiness_is_the_flush_event(card):
    """plan_ready probes the CUDA event recorded after the flush's last
    launch: False while the stream is busy behind it, True once the work
    is done; plan_device_ms then reads the two events."""
    from cometbft_tpu_torch.ops import ed25519_stamp as es
    from cometbft_tpu_torch.verifyplane import fused as fz
    from cometbft_tpu_torch.verifyplane.plane import _Submission

    subs, group, exp, power = _plane_stream()
    batch = [_Submission(s["rows"], s["group"], s["power"], s["counted"],
                         s["vidx"], stamp=s["stamp"]) for s in subs]
    plan = fz.plan_fused(batch)
    assert plan.device == card
    real = es.verify_tally_delta_cached

    def busy(*a, **kw):
        out = real(*a, **kw)
        torch.cuda._sleep(1 << 30)  # the stream is busy past the launches
        return out

    es.verify_tally_delta_cached = busy
    try:
        fz.dispatch_fused(plan)
    finally:
        es.verify_tally_delta_cached = real
    assert plan.event is not None and not fz.plan_ready(plan)
    assert fz.plan_device_ms(plan) is None
    verdicts, tallies = fz.collect_fused(plan)
    torch.cuda.synchronize()
    assert fz.plan_ready(plan) and fz.plan_device_ms(plan) > 0
    assert verdicts == [v for (v,) in exp]
    assert tallies == {group: power}


def test_plane_two_flights_land_by_event(card):
    """pipeline_flights=2: flushes fly while the next one packs, land by
    their events, and give the single-flight results."""
    from cometbft_tpu_torch.crypto.batch import CircuitBreaker
    from cometbft_tpu_torch.verifyplane import VerifyPlane

    subs, group, exp, power = _plane_stream()
    plane = VerifyPlane(window_ms=1.0, max_batch=8, pipeline_flights=2,
                        breaker=CircuitBreaker())
    got = _drive_plane(plane, subs)
    assert got == exp and group.tally == power
    recs = plane.ledger.records()
    assert len(recs) == PLANE_VALS // 8
    assert {r["path"] for r in recs} == {"fused"}
    assert plane.stats()["deck_peak"] >= 1


def test_plane_in_flight_fault_on_the_card(card):
    """A fault where the flush's results are fetched (the
    `verifyplane.collect` failpoint) fails that flush's futures with
    DeviceError (no host fallback on the card), counts one fault on the
    breaker, and the next flush is fused with the oracle's verdicts."""
    from cometbft_tpu_torch.crypto.batch import CircuitBreaker
    from cometbft_tpu_torch.device import DeviceError
    from cometbft_tpu_torch.libs import failpoints as fp
    from cometbft_tpu_torch.verifyplane import VerifyPlane

    subs, group, exp, power = _plane_stream()
    brk = CircuitBreaker()
    plane = VerifyPlane(window_ms=1.0, max_batch=4096, breaker=brk)
    fp.arm("verifyplane.collect", "raise", count=1)
    try:
        plane.start()
        got = []
        for half in (subs[:20], subs[20:]):
            with plane._cv:
                futs = [plane.submit_many(**s) for s in half]
            for f in futs:
                try:
                    got.append(f.result(120.0))
                except DeviceError:
                    got.append("DeviceError")
    finally:
        plane.stop()
        fp.reset()
    assert got == ["DeviceError"] * 20 + exp[20:]
    assert group.tally == sum(s["power"] for s, v in zip(subs[20:], exp[20:])
                              if s["counted"] and all(v))
    assert [r["path"] for r in plane.ledger.records()] == [
        "device_fault", "fused"]
    assert brk.faults == 1 and brk.state == "closed"


# ---------------------------------------------------------------------------
# the main path's entry and the light client on the card (-k "voteset or
# warmer or light_client")
# ---------------------------------------------------------------------------

VS_VALS = 64
VS_TAMPERED = 13


def _voteset_fixture():
    """VS_VALS ed25519 validators (seeded keys and powers) and the
    precommit Vote of each for one block, signed with the port's oracle;
    VS_TAMPERED's signature has a flipped bit. Returns (valset, votes,
    block id)."""
    from cometbft_tpu_torch.crypto.keys import PubKey
    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
    from cometbft_tpu_torch.types.vote import Vote

    rng = np.random.default_rng(64)
    seeds = [rng.bytes(32) for _ in range(VS_VALS)]
    pubs = [ed.sign_many(s, [])[0] for s in seeds]
    powers = [int(p) for p in rng.integers(100, 121, VS_VALS)]
    vs = ValidatorSet([Validator(PubKey(p), w)
                       for p, w in zip(pubs, powers)])
    seed_of = {PubKey(p).address(): s for p, s in zip(pubs, seeds)}
    bid = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
    votes = []
    for i, v in enumerate(vs.validators):
        vo = Vote(vote_type=canonical.PRECOMMIT_TYPE, height=7, round=0,
                  block_id=bid, timestamp=Timestamp(1_700_000_000 + i,
                                                    i * 7919),
                  validator_address=v.address, validator_index=i)
        sig = ed.sign_many(seed_of[v.address], [vo.sign_bytes("vs-card")])
        vo.signature = sig[1][0]
        if i == VS_TAMPERED:
            vo.signature = vo.signature[:40] + bytes(
                [vo.signature[40] ^ 1]) + vo.signature[41:]
        votes.append(vo)
    return vs, votes, bid


def _add_all(vs, votes, plane, threads=4):
    """The votes into a fresh VoteSet on `plane` from `threads` threads;
    -> (VoteSet, outcome of each add)."""
    import threading

    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.vote_set import VoteSet

    vset = VoteSet("vs-card", 7, 0, canonical.PRECOMMIT_TYPE, vs)
    vset.verify_plane = plane
    outs = [None] * len(votes)

    def add(k):
        for i in range(k, len(votes), threads):
            try:
                outs[i] = vset.add_vote(votes[i])
            except Exception as e:  # noqa: BLE001 - asserted below
                outs[i] = (type(e).__name__, str(e))

    ts = [threading.Thread(target=add, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120.0)
        assert not t.is_alive()
    return vset, outs


def test_voteset_reaches_quorum_through_a_card_plane(card):
    """64 precommits into a VoteSet on a card plane: every valid vote
    admitted, the tampered one refused, the quorum from the fused tally,
    no vote on the serial path, and the commit the serial VoteSet
    makes."""
    from cometbft_tpu_torch.crypto.batch import CircuitBreaker
    from cometbft_tpu_torch.ops import table_cache as tc
    from cometbft_tpu_torch.verifyplane import VerifyPlane

    tc.reset_for_tests()
    vs, votes, bid = _voteset_fixture()
    brk = CircuitBreaker()
    plane = VerifyPlane(window_ms=1.0, breaker=brk)
    before = _plane_launches()
    plane.start()
    try:
        vset, outs = _add_all(vs, votes, plane)
    finally:
        plane.stop()
    torch.cuda.synchronize()
    after = _plane_launches()
    assert outs[VS_TAMPERED] == ("VoteSetError",
                                 "invalid vote: invalid signature")
    assert all(o is True for i, o in enumerate(outs) if i != VS_TAMPERED)
    group = vset._plane_groups[bid.key()]
    assert group.quorum_reached and vset.two_thirds_majority() == bid
    assert group.tally == vset.sum
    assert plane.rows_verified == VS_VALS  # no vote took the serial path
    recs = plane.ledger.records()
    assert {r["path"] for r in recs} == {"fused"}
    n = len(recs)
    assert [a - b for a, b in zip(after, before)] == [n, 1, n, n]
    serial, souts = _add_all(vs, votes, None, threads=1)
    assert souts == outs
    assert serial.make_commit().hash() == vset.make_commit().hash()
    assert serial.bit_array() == vset.bit_array()
    assert brk.faults == 0


def test_warmer_build_makes_the_first_post_rotation_flush_warm(card):
    """A card TableWarmer builds epoch e+1's table (a new key set: a full
    valset_table_build) before its first flush; that flush is warm, the
    cache counts one warmed hit, and no table build runs inside it."""
    from cometbft_tpu_torch.crypto.batch import CircuitBreaker
    from cometbft_tpu_torch.ops import table_cache as tc
    from cometbft_tpu_torch.verifyplane import TableWarmer, VerifyPlane

    tc.reset_for_tests()
    vs, votes, bid = _voteset_fixture()
    w = TableWarmer(breaker=CircuitBreaker())
    assert w.device == card
    w.start()
    try:
        b0 = ec.valset_table_build.launches
        w.request_valset(vs)
        assert w.wait_idle(120.0)
        assert ec.valset_table_build.launches == b0 + 1
        st = w.stats()
        assert (st["builds_ok"], st["builds_incremental"],
                st["builds_failed"]) == (1, 0, 0)
    finally:
        w.stop()
    hits0 = tc.STATS["warmed_hits"]
    plane = VerifyPlane(window_ms=1.0, breaker=CircuitBreaker())
    before = _plane_launches()
    plane.start()
    try:
        vset, outs = _add_all(vs, votes, plane)
    finally:
        plane.stop()
    torch.cuda.synchronize()
    after = _plane_launches()
    recs = plane.ledger.records()
    assert [r["warm"] for r in recs] == [1] * len(recs)
    assert tc.STATS["warmed_hits"] - hits0 == 1
    assert after[1] == before[1]  # no table build in the flushes
    assert vset.two_thirds_majority() == bid


def test_light_client_bisects_a_secp256k1_chain_through_a_card_plane(card):
    """chip_smoke phase 13's plan at 16 secp256k1 validators: the skipping
    client (batch_fn=None) bisects 1 -> 8 through a card plane, its commits
    on the plane's grouped path (one ecdsa_verify a commit check), with
    the heights and count the CPU test pins."""
    import importlib.util
    from pathlib import Path

    from cometbft_tpu_torch.crypto.batch import CircuitBreaker
    from cometbft_tpu_torch.crypto.keys import Secp256k1PrivKey
    from cometbft_tpu_torch.light.client import Client, Provider
    from cometbft_tpu_torch.light.verifier import LightBlock, SignedHeader
    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.block import Header
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                 Commit, CommitSig)
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
    from cometbft_tpu_torch.verifyplane import VerifyPlane, set_global_plane

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    plan = cs.light_plan(cs.LCC_COPY_VALS)
    keys = {s: Secp256k1PrivKey.generate(s) for vals in plan.values()
            for s, _ in vals}
    blocks, prev = {}, BlockID()
    sets = {h: ValidatorSet([Validator(keys[s].pub_key(), w)
                             for s, w in vals]) for h, vals in plan.items()}
    by_addr = {k.pub_key().address(): k for k in keys.values()}
    for h in sorted(plan):
        vs = sets[h]
        header = Header(chain_id=cs.CHAIN_ID, height=h,
                        time=Timestamp(cs.LCC_T0 + h, 0), last_block_id=prev,
                        validators_hash=vs.hash(),
                        next_validators_hash=sets.get(h + 1, vs).hash(),
                        proposer_address=vs.validators[0].address,
                        app_hash=b"\x01" * 32)
        bid = BlockID(header.hash(), PartSetHeader(1, header.hash()))
        ts = Timestamp(cs.LCC_T0 + h, 42)
        sb = canonical.canonical_vote_bytes(cs.CHAIN_ID,
                                            canonical.PRECOMMIT_TYPE, h, 0,
                                            bid, ts)
        sigs = [CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts,
                          by_addr[v.address].sign(sb))
                for v in vs.validators]
        blocks[h] = LightBlock(SignedHeader(header, Commit(h, 0, bid,
                                                           sigs)), vs)
        prev = bid
    brk = CircuitBreaker()
    plane = VerifyPlane(window_ms=1.0, breaker=brk)
    plane.start()
    set_global_plane(plane)
    b0 = ef.ecdsa_verify.launches
    try:
        c = Client(cs.CHAIN_ID, Provider(cs.CHAIN_ID, blocks.get),
                   trusting_period=1e6)
        c.trust_light_block(blocks[1])
        lb = c.verify_light_block_at_height(
            8, now=Timestamp(cs.LCC_T0 + 1000, 0))
    finally:
        set_global_plane(None)
        plane.stop()
    torch.cuda.synchronize()
    assert lb.height == 8
    assert c.store.heights() == [1, 4, 5, 6, 8] and c.verifications == 7
    recs = plane.ledger.records()
    assert len(recs) == 6 and {r["path"] for r in recs} == {"grouped"}
    assert ef.ecdsa_verify.launches - b0 == 6
    assert brk.faults == 0


# ---------------------------------------------------------------------------
# catch-up, the light-client gateway and evidence on the card (-k "catchup
# or gateway")
# ---------------------------------------------------------------------------

CU_VALS = 24          # 8 commits x 24 rows: above the stream's host-loop gate
CU_HEIGHTS = 16       # V0 signs 1-8, V1 (2 keys rotated) 9-16


def _catchup_history():
    """CU_HEIGHTS real Blocks over CU_VALS ed25519 validators, V0 for
    heights 1-8 and V1 (V0 with 2 keys rotated, same powers) for 9-16;
    -> ({height: (block, commit)}, vals_at)."""
    from cometbft_tpu_torch.crypto.keys import PubKey
    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.block import Block, Data, Header
    from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                 Commit, CommitSig)
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

    rng = np.random.default_rng(16)
    seeds0 = [rng.bytes(32) for _ in range(CU_VALS)]
    seeds1 = list(seeds0)
    seeds1[3], seeds1[11] = rng.bytes(32), rng.bytes(32)
    powers = [1000 - 7 * i for i in range(CU_VALS)]
    seed_of, sets = {}, []
    for seeds in (seeds0, seeds1):
        pubs = [ed.sign_many(s, [])[0] for s in seeds]
        sets.append(ValidatorSet([Validator(PubKey(p), w)
                                  for p, w in zip(pubs, powers)]))
        seed_of.update({PubKey(p).address(): s
                        for p, s in zip(pubs, seeds)})

    def vals_at(h):
        return sets[0] if h <= CU_HEIGHTS // 2 else sets[1]

    items, prev = {}, None
    for h in range(1, CU_HEIGHTS + 1):
        vs = vals_at(h)
        hdr = Header(chain_id="cu-card", height=h,
                     time=Timestamp(1_700_000_000 + h, 0),
                     validators_hash=vs.hash(),
                     next_validators_hash=vals_at(h + 1).hash(),
                     proposer_address=vs.validators[0].address)
        if prev is not None:
            hdr.last_block_id = prev
        blk = Block(hdr, Data())
        blk.fill_header()
        prev = blk.block_id()
        sigs = []
        for i, v in enumerate(vs.validators):
            ts = Timestamp(1_700_000_000 + h, i * 7919)
            sb = canonical.canonical_vote_bytes(
                "cu-card", canonical.PRECOMMIT_TYPE, h, 0, prev, ts)
            sigs.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts,
                                  ed.sign_many(seed_of[v.address],
                                               [sb])[1][0]))
        items[h] = (blk, Commit(h, 0, prev, sigs))
    return items, vals_at


def _catchup_run(items, vals_at, on_apply=None):
    from cometbft_tpu_torch.blocksync.catchup import CatchupEngine, \
        CatchupError

    class State:
        def __init__(self, h):
            self.chain_id = "cu-card"
            self.last_block_height = h
            self.validators = vals_at(h + 1)
            self.next_validators = vals_at(h + 2)

    class Source:
        def tip(self):
            return max(items)

        def load(self, h):
            if h not in items:
                raise CatchupError(f"history missing block {h}")
            return items[h]

    def apply_fn(st, blk, commit):
        if on_apply is not None:
            on_apply(blk.header.height)
        return State(blk.header.height)

    return CatchupEngine(Source(), State(0), apply_fn=apply_fn)


def test_catchup_replays_a_history_on_the_card(card):
    """16 heights through a CatchupEngine with its default verifier (the
    card's StreamVerifier) and a card TableWarmer mounted: two segments,
    warm-ahead of V1 at height 7 builds its table (a delta) before the
    9-16 segment, which hits it; a tampered signature at height 5 raises
    CatchupError naming it."""
    import copy

    from cometbft_tpu_torch.blocksync.catchup import CatchupError
    from cometbft_tpu_torch.crypto.batch import device_breaker
    from cometbft_tpu_torch.ops import ed25519_stamp as es
    from cometbft_tpu_torch.ops import table_cache as tc
    from cometbft_tpu_torch.verifyplane import warmer as vw

    tc.reset_for_tests()
    items, vals_at = _catchup_history()
    faults = device_breaker().faults
    w = vw.TableWarmer()
    w.start()
    vw.set_global_warmer(w)
    launches = lambda: (es.stamp_rows.launches,  # noqa: E731
                        ec.ed25519_verify_cached.launches,
                        ec.tally_quorum_cached.launches,
                        ec.valset_table_build.launches)

    def on_apply(h):
        if h == CU_HEIGHTS // 2:
            assert w.wait_idle(120.0)

    before = launches()
    try:
        eng = _catchup_run(items, vals_at, on_apply)
        assert eng.verifier.device == card
        hits0 = tc.STATS["warmed_hits"]
        eng.run()
        torch.cuda.synchronize()
        after = launches()
        bad = dict(items)
        blk, commit = items[5]
        commit = copy.copy(commit)
        commit.signatures = list(commit.signatures)
        cs = copy.copy(commit.signatures[2])
        cs.signature = cs.signature[:9] + bytes([cs.signature[9] ^ 1]) \
            + cs.signature[10:]
        commit.signatures[2] = cs
        bad[5] = (blk, commit)
        with pytest.raises(CatchupError, match=r"height 5: .*#2"):
            _catchup_run(bad, vals_at).run()
    finally:
        vw.clear_global_warmer(w)
        w.stop()
    assert eng.state.last_block_height == CU_HEIGHTS
    recs = eng.ledger.records()
    assert [(r["first"], r["last"], r["boundary"], r["warmed"])
            for r in recs] == [(1, 8, True, True), (9, 16, False, False)]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2, 2]
    assert tc.STATS["warmed_hits"] - hits0 == 1
    assert w.stats()["builds_incremental"] == 1
    assert device_breaker().faults == faults


def test_gateway_coalesces_and_takes_attack_evidence_on_the_card(card):
    """chip_smoke phase 15's waves at LCC_COPY_VALS secp256k1 validators
    through a card plane: one verification for 8 clients, LRU hits for
    the next 8, and on the era-B pair one LightClientAttackEvidence
    verified on the card; one ecdsa_verify a flush."""
    import importlib.util
    from pathlib import Path

    from cometbft_tpu_torch.crypto.batch import CircuitBreaker
    from cometbft_tpu_torch.crypto.keys import Secp256k1PrivKey
    from cometbft_tpu_torch.evidence.pool import EvidencePool
    from cometbft_tpu_torch.light.client import Provider
    from cometbft_tpu_torch.light.verifier import LightBlock, SignedHeader
    from cometbft_tpu_torch.lightgate import LightGateway
    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.types.block import Header
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                 Commit, CommitSig)
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
    from cometbft_tpu_torch.verifyplane import VerifyPlane, set_global_plane

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    plan = cs.light_plan(cs.LCC_COPY_VALS)
    keys = {s: Secp256k1PrivKey.generate(s) for vals in plan.values()
            for s, _ in vals}
    by_addr = {k.pub_key().address(): k for k in keys.values()}
    sets = {h: ValidatorSet([Validator(keys[s].pub_key(), w)
                             for s, w in vals]) for h, vals in plan.items()}

    def sign_commit(commit):
        for sig, m in zip(commit.signatures,
                          commit.sign_bytes_rows(cs.CHAIN_ID)):
            sig.signature = by_addr[sig.validator_address].sign(m)

    blocks, headers, prev = {}, {}, BlockID()
    for h in sorted(plan):
        vs = sets[h]
        headers[h] = Header(
            chain_id=cs.CHAIN_ID, height=h, time=Timestamp(cs.LCC_T0 + h, 0),
            last_block_id=prev, validators_hash=vs.hash(),
            next_validators_hash=sets.get(h + 1, vs).hash(),
            proposer_address=vs.validators[0].address, app_hash=b"\x01" * 32)
        prev = BlockID(headers[h].hash(), PartSetHeader(1, headers[h].hash()))
        ts = Timestamp(cs.LCC_T0 + h, 42)
        commit = Commit(h, 0, prev, [CommitSig(BLOCK_ID_FLAG_COMMIT,
                                               v.address, ts, b"")
                                     for v in vs.validators])
        sign_commit(commit)
        blocks[h] = LightBlock(SignedHeader(headers[h], commit), vs)
    t_h, g_h = cs.GW_ERA_B_PAIR
    claim = cs.forged_claim(headers[g_h], sets[g_h], sign_commit)
    pool = EvidencePool(cs.CHAIN_ID, sets.get)
    pool.height, pool.time_s = g_h, cs.LCC_T0 + g_h
    gw = LightGateway(cs.CHAIN_ID, Provider(cs.CHAIN_ID, blocks.get),
                      evidence_pool=pool, trusting_period=1e6,
                      coalesce_timeout=120.0)
    gw.client.trust_light_block(blocks[1])
    gw.start(register=False)
    brk = CircuitBreaker()
    plane = VerifyPlane(window_ms=1.0, breaker=brk)
    plane.start()
    set_global_plane(plane)
    b0 = ef.ecdsa_verify.launches
    marks, stats = [], []

    def mark():
        marks.append(len(plane.ledger.records()))
        stats.append(gw.stats())

    try:
        waves = cs.gateway_waves(gw, claim, Timestamp(cs.LCC_T0 + 1000, 0),
                                 8, 4, mark)
    finally:
        set_global_plane(None)
        plane.stop()
    torch.cuda.synchronize()
    recs = plane.ledger.records()
    assert not any(w[1] for w in waves), [w[1][:2] for w in waves]
    assert stats[0]["verifies"] == 1
    assert gw.client.store.heights() == [1, 4, 5, 6, 8]
    assert marks[1] == marks[0]
    assert sorted(k for k, v in waves[2][0].items()
                  if v["status"] == "divergent") == [1, 3]
    assert pool.size() == 1 and stats[2]["evidence_submitted"] == 1
    assert {r["path"] for r in recs} == {"grouped"}
    assert ef.ecdsa_verify.launches - b0 == len(recs) > marks[1]
    assert brk.faults == 0


# --------------------------------------------------------------------------
# the application boundary and block execution on the card (-k "mempool
# or executor")
# --------------------------------------------------------------------------


def test_mempool_sigtx_through_a_card_plane_bulk_lane(card):
    """64 sigtx envelopes (one with a flipped signature byte) from 8
    threads through Mempool.check_tx: their signatures ride a card plane's
    BULK lane on grouped flushes, one ed25519_verify a flush; every code
    is the built one."""
    import threading

    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.crypto.batch import CircuitBreaker
    from cometbft_tpu_torch.crypto.keys import PrivKey
    from cometbft_tpu_torch.mempool import sigtx
    from cometbft_tpu_torch.mempool.mempool import Mempool
    from cometbft_tpu_torch.verifyplane import VerifyPlane, set_global_plane

    privs = [PrivKey.generate(bytes([0x70 + k]) * 32) for k in range(8)]
    txs = [sigtx.wrap(privs[i % 8], b"card-%d=v" % i) for i in range(64)]
    bad = bytearray(txs[17])
    bad[len(sigtx.MAGIC) + sigtx.PUB_LEN + 3] ^= 1
    txs[17] = bytes(bad)
    brk = CircuitBreaker()
    plane = VerifyPlane(window_ms=1.0, breaker=brk)
    plane.start()
    set_global_plane(plane)
    mp = Mempool(KVStoreApplication(), verify_sigs=True)
    codes, b0 = {}, kf.ed25519_verify.launches
    try:
        def run(k):
            for tx in txs[k::8]:
                codes[tx] = mp.check_tx(tx).code

        threads = [threading.Thread(target=run, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        set_global_plane(None)
        plane.stop()
    torch.cuda.synchronize()
    recs = plane.ledger.records()
    assert [codes[tx] for tx in txs] == [
        abci.CODE_TYPE_BAD_SIGNATURE if i == 17 else abci.CODE_TYPE_OK
        for i in range(64)]
    assert plane.stats()["lane_rows"]["bulk"] == 64
    assert {r["path"] for r in recs} == {"grouped"}
    assert kf.ed25519_verify.launches - b0 == len(recs)
    assert mp.size() == mp.gas_entries() == 63 and brk.faults == 0


def test_block_executor_verifies_last_commits_on_the_card(card):
    """Three heights of a BlockExecutor with batch_fn=None and no plane
    over 16 validators: each LastCommit after height 1 is one
    ed25519_verify on the card; height 1's val: txs rotate a validator,
    and the card TableWarmer builds the next set's table (one
    valset_table_build)."""
    import base64

    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.crypto.batch import CircuitBreaker
    from cometbft_tpu_torch.crypto.keys import PrivKey
    from cometbft_tpu_torch.mempool.mempool import Mempool
    from cometbft_tpu_torch.ops import table_cache as tc
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import StateStore
    from cometbft_tpu_torch.store.blockstore import BlockStore
    from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                 Commit, CommitSig)
    from cometbft_tpu_torch.types.genesis import (GenesisDoc,
                                                  GenesisValidator)
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.verifyplane import (TableWarmer,
                                                clear_global_warmer,
                                                global_plane,
                                                set_global_warmer)

    assert global_plane() is None
    tc.reset_for_tests()
    chain, t0 = "card-exec", 1_700_500_000
    privs = [PrivKey.generate(bytes([0x90, i + 1]) + b"\x11" * 30)
             for i in range(16)]
    new = PrivKey.generate(b"\x9f" * 32)
    by_addr = {p.pub_key().address(): p for p in privs + [new]}
    doc = GenesisDoc(chain_id=chain, genesis_time=Timestamp(t0, 0),
                     validators=[GenesisValidator(p.pub_key(), 10 + i)
                                 for i, p in enumerate(privs)])
    state = doc.make_state()
    app = KVStoreApplication()
    mp = Mempool(app, verify_sigs=False)
    store, blocks = StateStore(), BlockStore()
    ex = BlockExecutor(app, store, batch_fn=None, mempool=mp)
    gone = state.validators.validators[-1].pub_key.data
    for tx in (b"val:" + base64.b64encode(gone) + b"!0",
               b"val:" + base64.b64encode(new.pub_key().data) + b"!30",
               b"k=v"):
        assert mp.check_tx(tx).code == 0
    w = TableWarmer(breaker=CircuitBreaker())
    assert w.device == card
    w.start()
    set_global_warmer(w)
    l0, b0 = kf.ed25519_verify.launches, ec.valset_table_build.launches
    last = None
    try:
        for h in (1, 2, 3):
            block = ex.create_proposal_block(
                h, state, last, state.validators.get_proposer().address)
            bid = block.block_id()
            commit = Commit(h, 0, bid, [
                CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                          Timestamp(t0 + h, 1000 * i), b"")
                for i, v in enumerate(state.validators.validators)])
            for i, cs in enumerate(commit.signatures):
                cs.signature = by_addr[cs.validator_address].sign(
                    commit.vote_sign_bytes(chain, i))
            state = ex.apply_block(state, bid, block)
            blocks.save_block(block, commit)
            last = commit
            if h == 1:
                assert w.wait_idle(120.0)
        stats = w.stats()
    finally:
        clear_global_warmer(w)
        w.stop()
    torch.cuda.synchronize()
    assert kf.ed25519_verify.launches - l0 == 2
    assert ec.valset_table_build.launches - b0 == 1
    assert (stats["builds_ok"], stats["builds_failed"]) == (1, 0)
    assert state.last_height_validators_changed == 3
    assert new.pub_key().address() in {cs.validator_address
                                       for cs in last.signatures}
    assert store.load().app_hash == state.app_hash == app.app_hash
    assert blocks.height() == 3 and mp.size() == 0


# ---------------------------------------------------------------------------
# the mesh over slots of the card (parallel/mesh.py, cbt_carry_quorum)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev,C", [(1, 1), (3, 2), (8, 5), (8, 300)])
def test_carry_quorum_kernel_equals_plain(card, n_dev, C):
    rng = np.random.default_rng(n_dev * 1000 + C)
    parts = rng.integers(0, 1 << 13, (n_dev, C, ek.TALLY_LIMBS)).astype(
        np.int32)
    parts[:, 0] = (1 << 13) - 1  # every limb of commit 0 carries
    p = torch.from_numpy(parts).to(card)
    want_t, _ = ek.carry_quorum_plain(p.cpu(), torch.zeros(
        (C, ek.TALLY_LIMBS), dtype=torch.int32))
    thresh = want_t.clone()
    thresh[1::2, 0] -= 1  # odd commits clear their threshold by one
    thr = thresh.to(card)
    before = ek.carry_quorum.launches
    t, q = ek.carry_quorum(p, thr)
    tp, qp = ek.carry_quorum_plain(p, thr)
    torch.cuda.synchronize()
    assert ek.carry_quorum.launches == before + 1
    assert torch.equal(t, tp) and torch.equal(q, qp)
    assert q.cpu().tolist() == [k % 2 == 1 for k in range(C)]


def test_sharded_stream_step_on_eight_slots_equals_one_device(card):
    """16 commits of a 1,000-validator set (M = 1,024) over 8 slots of the
    card, 2 commits a slot: verdicts, tally limbs and quorum bits equal the
    one-device launches; each slot launches the cached verify and tally
    once on its own stream, then one carry_quorum."""
    from cometbft_tpu_torch.parallel import mesh as pm

    rng = np.random.default_rng(88)
    n, C = 1000, 16
    seeds = [rng.bytes(32) for _ in range(64)]
    pubs = [ed.pubkey_from_seed(s) for s in seeds] * (n // 64) \
        + [ed.pubkey_from_seed(s) for s in seeds[: n % 64]]
    table = ec.build_table(pubs, [7] * n, device=card)
    M = table.n_vals
    spubs, smsgs, ssigs = [], [], []
    for c in range(C):
        for i in range(M):
            if i < n and i % 50 == c:  # a few signed columns a commit
                m = b"mesh-%d-%d" % (c, i)
                spubs.append(pubs[i])
                smsgs.append(m)
                ssigs.append(ed.sign(seeds[i % 64], m))
            else:
                spubs.append(pubs[i] if i < n else b"\x00" * 32)
                smsgs.append(b"")
                ssigs.append(b"\x00" * 64)
    ssigs[3 * M + 3] = b"\x01" * 64  # one of commit 3's 20 columns, broken
    pb = ek.pack_batch(spubs, smsgs, ssigs, pad_to=C * M)
    counted = np.ones(C * M, np.bool_)
    cids = np.repeat(np.arange(C, dtype=np.int32), M)
    thresh = ek.threshold_limbs(20 * 7 - 1, C)  # 20 signed a commit
    one = ec.verify_tally_rows_cached(
        ec.pack_rows_cached(pb, counted, cids, thresh), table, C)
    mesh = pm.make_mesh([pm.Slot(i, card) for i in range(8)])
    step = pm.sharded_stream_verify(mesh, C)
    rows = ec.pack_rows_cached(pb, counted, cids)
    v0, t0 = ec.ed25519_verify_cached.launches, ek.carry_quorum.launches
    got = step(rows, table.tab, table.ok, table.power5, None, thresh)
    torch.cuda.synchronize()
    assert ec.ed25519_verify_cached.launches == v0 + 8
    assert ek.carry_quorum.launches == t0 + 1
    for g, w in zip(got, one):
        assert torch.equal(g, w)
    q = got[2].cpu().tolist()
    assert q == [c != 3 for c in range(C)]


def _node_net(tmp_path, n, card, chain, with_plane, key):
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.consensus.ticker import TimeoutParams
    from cometbft_tpu_torch.crypto.keys import PrivKey
    from cometbft_tpu_torch.node.node import LocalNetwork, Node
    from cometbft_tpu_torch.privval.file_pv import FilePV
    from cometbft_tpu_torch.state.state import State
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
    from cometbft_tpu_torch.verifyplane import VerifyPlane

    privs = [PrivKey.generate(bytes([key, i + 1]) + b"\x21" * 30)
             for i in range(n)]
    state = State.make_genesis(chain, ValidatorSet(
        [Validator(p.pub_key(), 10) for p in privs]))
    fast = TimeoutParams(propose=0.4, propose_delta=0.1, prevote=0.2,
                         prevote_delta=0.1, precommit=0.2,
                         precommit_delta=0.1, commit=0.01)
    net = LocalNetwork()
    for i, priv in enumerate(privs):
        net.add(Node(KVStoreApplication(), state.copy(),
                     privval=FilePV(priv), home=str(tmp_path / f"n{i}"),
                     broadcast=net.broadcaster(i), timeouts=fast,
                     verify_plane=VerifyPlane(window_ms=1.5)
                     if with_plane and i == 0 else None))
    return net


def test_node_network_commits_on_a_card_plane(card, tmp_path):
    """4 port Nodes (device=None: the card), node 0's card plane the
    global one: 5 heights; every vote flush fused (stamp_rows,
    ed25519_verify_cached and tally_quorum_cached once each), every
    LastCommit flush grouped (one ed25519_verify, as is a direct verify
    once the plane stopped), the genesis set's table built once; no
    breaker fault."""
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import ed25519_stamp as es
    from cometbft_tpu_torch.ops import table_cache as tc

    tc.reset_for_tests()
    brk = cbatch.device_breaker()
    faults0 = brk.faults
    net = _node_net(tmp_path, 4, card, "card-node", True, 0xA1)
    plane = net.nodes[0].verify_plane
    assert plane.device == card and net.nodes[1].device == card
    kernels = (es.stamp_rows, ec.ed25519_verify_cached,
               ec.tally_quorum_cached, kf.ed25519_verify,
               ec.valset_table_build)
    before = [k.launches for k in kernels]
    direct, real = [], cbatch.verify_batch_direct

    def spy(pubs, msgs, sigs, **kw):
        import sys

        if sys._getframe(1).f_code.co_name != "_verify_rows":
            direct.append(len(pubs))  # not a grouped flush of the plane
        return real(pubs, msgs, sigs, **kw)

    cbatch.verify_batch_direct = spy
    for n in net.nodes:
        n.start()
    try:
        net.nodes[1].broadcast_tx(b"card=node")
        for n in net.nodes:
            assert n.consensus.wait_for_height(5, timeout=60), n.height()
        assert len({n.block_store.load_block(4).hash()
                    for n in net.nodes}) == 1
    finally:
        for n in reversed(net.nodes):
            n.stop()
        cbatch.verify_batch_direct = real
    torch.cuda.synchronize()
    got = [k.launches - b for k, b in zip(kernels, before)]
    recs = plane.ledger.records()
    paths = [r["path"] for r in recs]
    n_f, n_g = paths.count("fused"), paths.count("grouped")
    assert set(paths) <= {"fused", "grouped"} and n_f > 0 and n_g > 0
    # a direct verify: node 0 stops its plane before its consensus, so a
    # LastCommit the stopping plane refuses goes to the card without it
    assert got == [n_f, n_f, n_f, n_g + len(direct), 1]
    assert net.nodes[2].query(b"card").value == b"node"
    assert brk.faults == faults0


def test_planeless_node_verifies_votes_on_the_card(card, tmp_path):
    """One validator, no plane: each vote is one verify_batch_direct call
    on the card (one ed25519_verify launch); 3 heights."""
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.verifyplane import global_plane

    assert global_plane() is None
    calls = []
    real = cbatch.verify_batch_direct

    def spy(pubs, msgs, sigs, device=None, **kw):
        calls.append((len(pubs), str(device)))
        return real(pubs, msgs, sigs, device=device, **kw)

    cbatch.verify_batch_direct = spy
    net = _node_net(tmp_path, 1, card, "card-solo", False, 0xA2)
    node = net.nodes[0]
    b0 = kf.ed25519_verify.launches
    node.start()
    try:
        assert node.consensus.wait_for_height(3, timeout=60)
    finally:
        node.stop()
        cbatch.verify_batch_direct = real
    torch.cuda.synchronize()
    assert node.verify_plane is None and node.device == card
    assert len(calls) >= 6 and set(calls) == {(1, str(card))}
    assert kf.ed25519_verify.launches - b0 == len(calls)


def _p2p_node(tmp_path, card, name, chain_state, priv=None, key=0,
              **kw):
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.consensus.ticker import TimeoutParams
    from cometbft_tpu_torch.crypto.keys import PrivKey
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.p2p.key import NodeKey
    from cometbft_tpu_torch.privval.file_pv import FilePV

    fast = TimeoutParams(propose=1.0, propose_delta=0.2, prevote=0.5,
                         prevote_delta=0.1, precommit=0.5,
                         precommit_delta=0.1, commit=0.02)
    node = Node(KVStoreApplication(), chain_state.copy(),
                privval=FilePV(priv) if priv is not None else None,
                home=str(tmp_path / name), timeouts=fast, p2p=True,
                node_key=NodeKey(PrivKey.generate(bytes([key]) * 32)), **kw)
    return node, node.listen("127.0.0.1", 0)


def test_p2p_nodes_verify_votes_on_the_card(card, tmp_path):
    """Two Node(p2p=True) validators (device=None: the card), no plane,
    over loopback with secret connections: every vote their VoteSets
    admit is one verify_batch_direct call on the card; 3 heights, equal
    blocks."""
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto.keys import PrivKey
    from cometbft_tpu_torch.state.state import State
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
    from cometbft_tpu_torch.verifyplane import global_plane

    assert global_plane() is None
    privs = [PrivKey.generate(bytes([0xB1, i]) + b"\x31" * 30)
             for i in range(2)]
    state = State.make_genesis("card-p2p", ValidatorSet(
        [Validator(p.pub_key(), 10) for p in privs]))
    calls, real = [], cbatch.verify_batch_direct

    def spy(pubs, msgs, sigs, device=None, **kw):
        calls.append((len(pubs), str(device)))
        return real(pubs, msgs, sigs, device=device, **kw)

    cbatch.verify_batch_direct = spy
    nodes, addrs = [], []
    for i, p in enumerate(privs):
        n, a = _p2p_node(tmp_path, card, f"p{i}", state, p, key=0xC0 + i)
        nodes.append(n)
        addrs.append(a)
    b0 = kf.ed25519_verify.launches
    try:
        for n in nodes:
            n.start()
        nodes[0].dial(addrs[1])
        for n in nodes:
            assert n.consensus.wait_for_height(3, timeout=60), n.height()
        assert nodes[0].block_store.load_block(2).hash() == \
            nodes[1].block_store.load_block(2).hash()
    finally:
        for n in nodes:
            n.stop()
        cbatch.verify_batch_direct = real
    torch.cuda.synchronize()
    assert all(n.device == card for n in nodes)
    assert calls and {d for _, d in calls} == {str(card)}
    assert kf.ed25519_verify.launches - b0 == len(calls)


def test_blocksync_node_verifies_on_the_card(card, tmp_path):
    """A Node(p2p=True, blocksync=True) on the card: its engine's
    StreamVerifier is on the card; it blocksyncs a one-validator card
    node's chain over loopback (one row a commit: under min_device_sigs,
    the host loop, as in the JAX package) and equals its blocks."""
    from cometbft_tpu_torch.blocksync.pipeline import StreamVerifier
    from cometbft_tpu_torch.crypto.keys import PrivKey
    from cometbft_tpu_torch.state.state import State
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

    priv = PrivKey.generate(b"\xb2" * 32)
    state = State.make_genesis("card-sync", ValidatorSet(
        [Validator(priv.pub_key(), 10)]))
    srv, addr = _p2p_node(tmp_path, card, "srv", state, priv, key=0xC4)
    late, _ = _p2p_node(tmp_path, card, "late", state, key=0xC5,
                        blocksync=True)
    eng = late.blocksync_engine
    assert isinstance(eng.verifier, StreamVerifier)
    assert eng.verifier.device == card
    try:
        srv.start()
        assert srv.consensus.wait_for_height(5, timeout=60)
        late.start()
        late.dial(addr)
        target = srv.height()
        deadline = time.time() + 60
        while late.height() < target:
            assert time.time() < deadline, late.height()
            time.sleep(0.05)
        for h in range(1, target + 1):
            assert late.block_store.load_block(h).hash() == \
                srv.block_store.load_block(h).hash()
    finally:
        late.stop()
        srv.stop()
    assert eng.verifier.stats["stamped_chunks"] == 0


def test_start_process_verifies_on_the_card(card, tmp_path):
    """`python -m cometbft_tpu_torch start` as an operator runs it, with
    the default [crypto] verifier = "tpu" and [verify_plane] enable: the
    process commits over its RPC, its flushes all ran on its card plane
    (no host path), and SIGTERM stops it with exit code 0."""
    import json
    import os
    import signal
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    from cometbft_tpu_torch.cmd import cli
    from cometbft_tpu_torch.config.config import load_config, save_config

    root = Path(__file__).resolve().parents[1]
    home = str(tmp_path / "node")
    assert cli.main(["init", "--home", home, "--chain-id", "card-cli"]) == 0
    path = os.path.join(home, "config", "config.toml")
    cfg = load_config(path)
    assert cfg.crypto.verifier == "tpu"
    cfg.verify_plane.enable = True
    cfg.consensus.timeout_commit = 0.05
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.base.blocksync = False
    save_config(cfg, path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cometbft_tpu_torch", "start", "--home",
         home], cwd=str(root), env=dict(os.environ, PYTHONPATH=str(root)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = next(line.split()[-1] for line in proc.stdout
                   if line.startswith("rpc listening on "))
        deadline = time.time() + 120
        height = 0
        while height < 3:
            assert time.time() < deadline, height
            with urllib.request.urlopen(f"{url}/status", timeout=10) as r:
                height = json.loads(r.read())["result"]["sync_info"][
                    "latest_block_height"]
            time.sleep(0.1)
        with urllib.request.urlopen(f"{url}/dump_flushes", timeout=10) as r:
            paths = {f["path"] for f in json.loads(r.read())["flushes"]}
        assert "fused" in paths and paths <= {"fused", "grouped"}, paths
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
