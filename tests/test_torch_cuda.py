"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they need an NVIDIA Hopper GPU and nvcc, and skip on a host
without them. On the card:  python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ed25519_ref as ed
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
