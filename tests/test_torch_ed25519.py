"""The port's ed25519 slice against the JAX package on the same seeded
inputs: packing is byte-identical, and the plain PyTorch versions of the
verify and tally kernels give exactly the JAX verdicts, tallies and quorum
bits (and the oracle's). The verify kernel's own arithmetic
(csrc/ed25519_core.cuh) is also built for the host and held against the
oracle. The CUDA kernels themselves run in tests/test_torch_cuda.py."""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519_ref as jref
from cometbft_tpu.ops import ed25519_kernel as jek
from cometbft_tpu.ops import ed25519_pallas as jkp
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import field as fe

CPU = torch.device("cpu")

# The plain versions run many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the host.
torch.set_num_threads(1)


def signed(rng, n):
    pubs, msgs, sigs = [], [], []
    for _ in range(n):
        m = rng.bytes(int(rng.integers(0, 80)))
        pub, (sig,) = ed.sign_many(rng.bytes(32), [m])
        pubs.append(pub)
        msgs.append(m)
        sigs.append(sig)
    return pubs, msgs, sigs


def zip215_cases():
    """Non-canonical, small-order and -0 encodings (the matrix of
    tests/test_ed25519_pallas.py::test_zip215_edges, plus small-order A and
    R at y = 0)."""
    ident = ed.pt_compress(ed.IDENT)
    cases = [(ident, b"m", ident + b"\x00" * 32)]
    for y in range(19):
        u, v = (y * y - 1) % ed.P, (ed.D * y * y + 1) % ed.P
        ok, x = ed._sqrt_ratio(u, v)
        if ok:
            enc_nc = int.to_bytes((y + ed.P) | ((x & 1) << 255), 32, "little")
            break
    pub, (sig,) = ed.sign_many(bytes(32), [b"x"])
    cases.append((pub, b"x", enc_nc + sig[32:]))
    cases.append((enc_nc, b"x", sig))
    neg_zero = int.to_bytes(1 | (1 << 255), 32, "little")
    cases.append((neg_zero, b"m", neg_zero + b"\x00" * 32))
    cases.append((bytes(32), b"s", ident + b"\x00" * 32))
    cases.append((ident, b"s", bytes(32) + b"\x00" * 32))
    return cases


def mixed_batch(seed=0, n_valid=24):
    """Valid, flipped-bit, tampered-message, S >= L, garbage, bad-length
    and ZIP-215 rows (<= 64, one JAX bucket)."""
    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = signed(rng, n_valid)
    for i in range(0, n_valid, 5):
        sigs[i] = sigs[i][:9] + bytes([sigs[i][9] ^ 4]) + sigs[i][10:]
    for i in range(1, n_valid, 7):
        msgs[i] = msgs[i] + b"?"
    s = int.from_bytes(sigs[3][32:], "little") + ed.L
    sigs[3] = sigs[3][:32] + int.to_bytes(s, 32, "little")
    for _ in range(6):
        pubs.append(rng.bytes(32))
        msgs.append(rng.bytes(3))
        sigs.append(rng.bytes(64))
    for p, m, s in zip215_cases():
        pubs.append(p)
        msgs.append(m)
        sigs.append(s)
    return pubs, msgs, sigs


def oracle(pubs, msgs, sigs):
    return np.array([jref.verify(p, m, s) for p, m, s in zip(pubs, msgs,
                                                             sigs)])


# --------------------------------------------------------------------------
# packing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pad", [None, 128, 256])
def test_pack_batch_and_pack_rows_are_byte_identical(pad):
    pubs, msgs, sigs = mixed_batch(1)
    a = ek.pack_batch(pubs, msgs, sigs, pad_to=pad)
    b = jek.pack_batch(pubs, msgs, sigs, pad_to=pad)
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert np.array_equal(np.asarray(x), np.asarray(y)), name
        assert np.asarray(x).dtype == np.asarray(y).dtype, name
    rng = np.random.default_rng(2)
    B = a.padded
    power5 = ek.power_limbs(rng.integers(0, 2**60, B))
    counted = rng.integers(0, 2, B).astype(bool)
    cids = rng.integers(0, 3, B).astype(np.int32)
    thresh = np.stack([ek.threshold_limbs(int(t))[0]
                       for t in rng.integers(0, 2**62, 3)])
    ra = kf.pack_rows(a, power5, counted, cids, thresh)
    rb = jkp.pack_rows(b, power5, counted, cids, thresh)
    assert ra.dtype == rb.dtype == np.int32
    assert ra.tobytes() == rb.tobytes()
    assert kf.pack_rows(a).tobytes() == jkp.pack_rows(b).tobytes()


def test_pack_batch_all_valid_rows_match():
    pubs, msgs, sigs = signed(np.random.default_rng(3), 40)
    a, b = ek.pack_batch(pubs, msgs, sigs), jek.pack_batch(pubs, msgs, sigs)
    assert kf.pack_rows(a).tobytes() == jkp.pack_rows(b).tobytes()


def test_layout_helpers_match_the_jax_package():
    assert ek.BUCKETS == jek.BUCKETS and ek.TALLY_LIMBS == jek.TALLY_LIMBS
    for n in (0, 1, 64, 65, 128, 129, 6667, 10_000, 16_000, 65_536):
        assert kf.pad_to_tile(n) == jkp.pad_to_tile(n)
    for name in ("C_AY", "C_RY", "C_S8", "C_H4", "C_FLAGS", "C_KROWS",
                 "C_POW", "C_CID", "C_THRESH"):
        assert getattr(kf, name) == getattr(jkp, name), name
    powers = np.array([0, 1, 8191, 8192, 2**62 - 1, 2**40 + 12345])
    assert np.array_equal(ek.power_limbs(powers), jek.power_limbs(powers))
    for v in (0, 1, 2**63 - 1, 6_666_666):
        assert np.array_equal(ek.threshold_limbs(v, 3),
                              jek.threshold_limbs(v, 3))
        assert ek.tally_to_int(ek.threshold_limbs(v))[0] == v


def test_rows_from_jax_checks_shape_and_dtype():
    pubs, msgs, sigs = signed(np.random.default_rng(4), 3)
    rows = jkp.pack_rows(jek.pack_batch(pubs, msgs, sigs, pad_to=128))
    t = convert.rows_from_jax(rows, "cpu")
    assert t.dtype == torch.int32 and t.numpy().tobytes() == rows.tobytes()
    with pytest.raises(ValueError):
        convert.rows_from_jax(rows.astype(np.int64), "cpu")
    with pytest.raises(ValueError):
        convert.rows_from_jax(rows[:, :100], "cpu")


# --------------------------------------------------------------------------
# field and curve (plain torch ops)
# --------------------------------------------------------------------------


def test_plain_field_ops_against_python_ints():
    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(32), "little") % fe.P
            for _ in range(64)] + [0, 1, fe.P - 1, fe.P - 19, 2**255 - 20]
    a = torch.from_numpy(np.stack([fe.int_to_limbs(v) for v in vals]))
    b = torch.flip(a, [0])
    wv = vals[::-1]

    def ints(t):
        return [int(x) for x in fe.limbs_to_int(t.numpy())]

    assert [x % fe.P for x in ints(fe.mul(a, b))] == [
        x * y % fe.P for x, y in zip(vals, wv)]
    canon = fe.canonical(fe.sub(a, b))
    assert ints(canon) == [(x - y) % fe.P for x, y in zip(vals, wv)]
    assert int(canon.min()) >= 0 and int(canon.max()) <= fe.MASK
    assert [x % fe.P for x in ints(fe.pow_p58(a))] == [
        pow(x, (fe.P - 5) // 8, fe.P) for x in vals]
    # adversarial limbs at the bound every op promises (|limb| < 2^14)
    m = torch.full((2, fe.NLIMBS), 2**14 - 1, dtype=torch.int64)
    m[1] = -m[1]
    for x in (m, fe.mul(m, m), fe.mul(m, -m), fe.sub(m, -m)):
        assert int(x.abs().max()) < 2**15
        assert ints(fe.canonical(x)) == [v % fe.P for v in ints(x)]
    y = np.frombuffer(rng.bytes(64), np.uint8).reshape(2, 32)
    assert np.array_equal(fe.from_bytes_le(y, 255),
                          jek.F.from_bytes_le(y, nbits=255))


# --------------------------------------------------------------------------
# verify: plain version vs JAX XLA kernel vs oracle vs the kernel's host build
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch64():
    pubs, msgs, sigs = mixed_batch(6)
    assert len(pubs) <= 64
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=64)
    return pubs, msgs, sigs, pb, kf.pack_rows(pb)


def test_plain_verify_matches_jax_xla_kernel_and_oracle(batch64):
    pubs, msgs, sigs, pb, rows = batch64
    got = kf.verify_rows(rows, device="cpu").numpy()
    jpb = jek.pack_batch(pubs, msgs, sigs, pad_to=64)
    want = np.asarray(jek.verify_kernel(
        jpb.ay, jpb.asign, jpb.ry, jpb.rsign, jpb.sdig, jpb.hdig,
        jpb.precheck))
    exp = oracle(pubs, msgs, sigs)
    assert np.array_equal(got, want)
    assert np.array_equal(got[:len(pubs)], exp)
    assert not got[len(pubs):].any()
    assert exp.any() and not exp.all()


def test_verify_batch_on_the_host_matches_the_oracle():
    pubs, msgs, sigs = mixed_batch(7, n_valid=10)
    got = kf.verify_batch(pubs, msgs, sigs, device="cpu")
    assert got.shape == (len(pubs),)
    assert np.array_equal(got, oracle(pubs, msgs, sigs))


needs_cxx = pytest.mark.skipif(
    shutil.which("c++") is None and shutil.which("g++") is None,
    reason="no C++ compiler for the host build of the kernel arithmetic")


def _host_verify(lib, rows, table):
    rows = np.ascontiguousarray(rows)
    out = np.zeros(rows.shape[1], np.int32)
    lib.cbt_host_verify(rows.ctypes.data, rows.shape[1], table.ctypes.data,
                        out.ctypes.data)
    return out


@needs_cxx
def test_kernel_arithmetic_host_build_matches_the_oracle(batch64):
    pubs, msgs, sigs, pb, rows = batch64
    out = _host_verify(_build.host_lib(), rows, kf.niels_table_np())
    assert np.array_equal(out[:len(pubs)].astype(bool),
                          oracle(pubs, msgs, sigs))
    assert not out[len(pubs):].any()


@needs_cxx
def test_kernel_arithmetic_host_build_on_random_signatures():
    rng = np.random.default_rng(8)
    pubs, msgs, sigs = signed(rng, 96)
    for i in rng.choice(96, 24, replace=False):
        b = int(rng.integers(0, 64))
        sigs[i] = sigs[i][:b] + bytes([sigs[i][b] ^ 0x80]) + sigs[i][b + 1:]
    rows = kf.pack_rows(ek.pack_batch(pubs, msgs, sigs, pad_to=128))
    out = _host_verify(_build.host_lib(), rows, kf.niels_table_np())
    assert np.array_equal(out[:96].astype(bool), oracle(pubs, msgs, sigs))


@needs_cxx
def test_field_op_count_behind_the_bound():
    """The per-signature multiplication count the bound uses is the count
    the kernel's code performs (one extra multiplication per
    decompression that takes the sqrt(-1) branch)."""
    lib = _build.host_lib(count_ops=True)
    table = kf.niels_table_np()
    m0, s0 = ctypes.c_longlong(), ctypes.c_longlong()
    m1, s1 = ctypes.c_longlong(), ctypes.c_longlong()
    for seed in range(4):
        pubs, msgs, sigs = signed(np.random.default_rng(20 + seed), 1)
        rows = kf.pack_rows(ek.pack_batch(pubs, msgs, sigs, pad_to=1))
        lib.cbt_host_op_counts(ctypes.byref(m0), ctypes.byref(s0))
        assert _host_verify(lib, rows, table)[0] == 1
        lib.cbt_host_op_counts(ctypes.byref(m1), ctypes.byref(s1))
        assert s1.value - s0.value == kf.VERIFY_FE_SQUARES
        assert 0 <= m1.value - m0.value - kf.VERIFY_FE_MULS <= 2
    assert kf.verify_products_per_signature() == 1738 * 100 + 1530 * 55


def test_base_table_from_jax_equals_the_ports_own_table():
    t = convert.base_table_from_jax(jkp.base_f32())
    assert t.dtype == torch.int32 and tuple(t.shape) == (8192, 3, 10)
    assert np.array_equal(t.numpy(), kf.niels_table_np())
    # and the plain version's table is the JAX package's, limb for limb
    assert np.array_equal(
        kf.base_points(CPU).numpy().reshape(8192, 80),
        jkp.base_f32().astype(np.int64))


# --------------------------------------------------------------------------
# tally and quorum
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_commits", [(0, 1), (1, 3), (2, 8)])
def test_plain_tally_and_quorum_match_jax_exactly(seed, n_commits):
    rng = np.random.default_rng(40 + seed)
    B = 256
    big = (2**63 - 1) // 8 // B  # MaxTotalVotingPower spread over B rows
    powers = np.where(rng.random(B) < 0.5, big - rng.integers(0, 99, B),
                      rng.integers(0, 2**20, B))
    valid = rng.random(B) < 0.7
    counted = rng.random(B) < 0.8
    cids = rng.integers(0, n_commits, B).astype(np.int32)
    p5 = ek.power_limbs(powers)
    t_port = ek.tally_core(torch.from_numpy(valid), torch.from_numpy(p5),
                           torch.from_numpy(counted), torch.from_numpy(cids),
                           n_commits)
    t_jax = np.asarray(jek.tally_core(valid, p5, counted, cids, n_commits))
    assert np.array_equal(t_port.numpy(), t_jax)
    sums = [int(powers[valid & counted & (cids == c)].astype(object).sum())
            for c in range(n_commits)]
    assert [int(x) for x in ek.tally_to_int(t_port.numpy())] == sums
    thr = [s - 1 if c % 2 else s for c, s in enumerate(sums)]
    th = np.stack([ek.threshold_limbs(t)[0] for t in thr])
    q_port = ek.quorum_core(t_port, torch.from_numpy(th)).numpy()
    q_jax = np.asarray(jek.quorum_core(t_jax, th))
    assert np.array_equal(q_port, q_jax)
    assert q_port.tolist() == [bool(c % 2) for c in range(n_commits)]


def test_tally_quorum_wrapper_reads_the_packed_rows():
    rng = np.random.default_rng(50)
    B, C = 128, 4
    powers = rng.integers(1, 2**50, B)
    counted = rng.random(B) < 0.9
    cids = rng.integers(0, C, B).astype(np.int32)
    valid = (rng.random(B) < 0.8).astype(np.int32)
    sums = [int(powers[(valid != 0) & counted & (cids == c)]
                .astype(object).sum()) for c in range(C)]
    th = np.stack([ek.threshold_limbs(s - (c != 2))[0]
                   for c, s in enumerate(sums)])
    rows = kf.pack_rows(ek.pack_batch([], [], [], pad_to=B),
                        ek.power_limbs(powers), counted, cids, th)
    tally, quorum = kf.tally_quorum(torch.from_numpy(valid),
                                    torch.from_numpy(rows), C)
    assert [int(x) for x in ek.tally_to_int(tally.numpy())] == sums
    assert quorum.tolist() == [True, True, False, True]
    assert kf.tally_quorum.launches == 0  # the host never launches


# --------------------------------------------------------------------------
# the fused step against the JAX Pallas step (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.slow  # ~75 s or more: the JAX Pallas kernel in interpret mode
def test_fused_step_matches_jax_pallas_interpret():
    pubs, msgs, sigs = mixed_batch(9, n_valid=40)
    n = len(pubs)
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=128)
    rng = np.random.default_rng(60)
    powers = rng.integers(1, 2**40, 128)
    counted = np.arange(128) < n
    cids = (np.arange(128) % 3).astype(np.int32)
    th = np.stack([ek.threshold_limbs(int(t))[0]
                   for t in rng.integers(0, 2**42, 3)])
    rows = kf.pack_rows(pb, ek.power_limbs(powers), counted, cids, th)
    v_t, t_t, q_t = kf.verify_tally_rows(rows, 3, device="cpu")
    v_j, t_j, q_j = jkp._verify_tally_rows(rows, jkp.base_dev(), 3)
    assert np.array_equal(v_t.numpy(), np.asarray(v_j))
    assert np.array_equal(t_t.numpy(), np.asarray(t_j))
    assert np.array_equal(q_t.numpy(), np.asarray(q_j))
    assert np.array_equal(v_t.numpy()[:n], oracle(pubs, msgs, sigs))
