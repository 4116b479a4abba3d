"""The port's secp256k1 ECDSA slice against the JAX package on the same
seeded inputs: the copied oracle agrees with the JAX package's, the plain
field is exact near p, `pack_batch` + `pack_rows` are byte-identical over
the malformed cases, the comb table equals the converted JAX table, and
the plain PyTorch verify, the host build of the one-thread arithmetic
(csrc/secp256k1_core.cuh) and of the kernel's quad lane program
(csrc/secp256k1_quad.cuh) give exactly the oracle's verdicts, and the
quad's addition and doubling give the oracle's points. The last
tests put a mixed ed25519 + sr25519 + secp256k1 commit through the
VerifyCommit family. The CUDA kernel itself runs in
tests/test_torch_cuda.py."""
import ctypes
import hashlib
import random
import shutil

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import secp256k1_ref as jref
from cometbft_tpu.ops import ecdsa_kernel as jeck
from cometbft_tpu.ops import ecdsa_pallas as jep
from cometbft_tpu.types import block_id as jbid
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validation as jv
from cometbft_tpu.types import validator as jval
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import secp256k1_ref as ref
from cometbft_tpu_torch.edge_cases import ecdsa_cases
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ecdsa_fused as ef
from cometbft_tpu_torch.ops import ecdsa_kernel as eck
from cometbft_tpu_torch.ops import field as fe
from cometbft_tpu_torch.ops import secp256k1 as curve
from cometbft_tpu_torch.types import block_id as tbid
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import validation as tv
from cometbft_tpu_torch.types import validator as tval

F = fe.FSECP

# The plain versions run many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the host.
torch.set_num_threads(1)

needs_cxx = pytest.mark.skipif(
    shutil.which("c++") is None and shutil.which("g++") is None,
    reason="no C++ compiler for the host build of the kernel arithmetic")


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------


def oracle(pubs, msgs, sigs):
    return np.asarray([jref.verify_py(p, m, s)
                       for p, m, s in zip(pubs, msgs, sigs)])


@pytest.fixture(scope="module")
def cases():
    pubs, msgs, sigs = ecdsa_cases(np.random.default_rng(21))
    pb = eck.pack_batch(pubs, msgs, sigs, pad_to=32)
    return pubs, msgs, sigs, ef.pack_rows(pb)


# --------------------------------------------------------------------------
# the copied oracle and keys against the JAX package's
# --------------------------------------------------------------------------


def test_oracle_matches_jax(monkeypatch):
    # the JAX oracle signs through OpenSSL when `cryptography` is present
    # (random k); its pure-Python RFC 6979 path is the port's
    monkeypatch.setattr(jref, "_HAVE_OPENSSL", False)
    rng = random.Random(7)
    for i in range(3):
        d = rng.randrange(1, ref.N)
        msg = b"oracle-%d" % i
        pub = ref.pubkey_from_secret(d)
        assert pub == jref.pubkey_from_secret(d)
        assert ref.decompress(pub) == jref.decompress(pub)
        sig = ref.sign(d, msg)
        assert sig == jref.sign(d, msg)
        assert ref.verify(pub, msg, sig) and jref.verify(pub, msg, sig)
        assert not ref.verify_py(pub, msg + b"x", sig)
        k = rng.randrange(1, ref.N)
        q = ref.decompress(pub)
        assert ref._mul(k, q) == jref.pt_mul(k, q)
        assert ref.address(pub) == jref.address(pub)
    assert ref.decompress(b"\x02" + ref.P.to_bytes(32, "big")) is None


@pytest.mark.parametrize("n", [0, 1, 55, 56, 64, 119, 200])
def test_pure_python_ripemd160_matches_hashlib(n):
    d = np.random.default_rng(n).bytes(n)
    assert ref.ripemd160(d) == hashlib.new("ripemd160", d).digest()


def test_keys_match_jax():
    priv = tkeys.Secp256k1PrivKey.generate(b"\x21" * 32)
    jpriv = jkeys.Secp256k1PrivKey.generate(b"\x21" * 32)
    assert priv.data == jpriv.data
    pub = priv.pub_key()
    assert pub.key_type == tkeys.SECP256K1_KEY_TYPE
    assert pub.data == jpriv.pub_key().data
    assert pub.address() == jpriv.pub_key().address()
    sig = priv.sign(b"vote")
    assert pub.verify_signature(b"vote", sig)
    assert jpriv.pub_key().verify_signature(b"vote", sig)
    assert not pub.verify_signature(b"vote!", sig)


def test_case_mix_covers_every_edge(cases):
    pubs, msgs, sigs, rows = cases
    exp = oracle(pubs, msgs, sigs)
    assert exp[:12].all() and exp[-1] and exp[-2]
    assert not exp[12:-2].any()
    # the xr2 row packs r + N < p as its second candidate
    pb = eck.pack_batch(pubs[-2:-1], msgs[-2:-1], sigs[-2:-1], pad_to=1)
    r = int.from_bytes(sigs[-2][:32], "big")
    assert int(fe.limbs_to_int(pb.xr2[0])) == r + ref.N < ref.P


# --------------------------------------------------------------------------
# the plain field and curve against Python ints and the oracle
# --------------------------------------------------------------------------


EDGE_VALUES = [0, 1, 2, ref.P - 1, ref.P, ref.P + 1, 2**256 - 1, 2**255,
               2**256 - 2**32 - 978, ref.P - 2**32, 2**32 + 977, ref.N]


def _t(vals):
    return torch.from_numpy(np.stack([fe.int_to_limbs(v) for v in vals]))


def _ints(t):
    return [int(v) for v in fe.limbs_to_int(F.canonical(t).numpy())]


def test_plain_field_is_exact_near_p():
    rng = random.Random(3)
    vals = EDGE_VALUES + [rng.randrange(0, 2**256) for _ in range(40)]
    other = list(reversed(vals))
    a, b = _t(vals), _t(other)
    P = ref.P
    assert _ints(F.mul(a, b)) == [x * y % P for x, y in zip(vals, other)]
    assert _ints(F.square(a)) == [x * x % P for x in vals]
    assert _ints(F.add(a, b)) == [(x + y) % P for x, y in zip(vals, other)]
    assert _ints(F.sub(a, b)) == [(x - y) % P for x, y in zip(vals, other)]
    assert _ints(F.mul_small(-a, 21)) == [-21 * x % P for x in vals]
    assert _ints(F.pow_sqrt(a)) == [pow(x, (P + 1) // 4, P) for x in vals]
    assert F.is_zero(a).tolist() == [v % P == 0 for v in vals]
    assert F.parity(a).tolist() == [v % P & 1 for v in vals]
    canon = F.canonical(F.mul(a, b))
    assert int(canon.min()) >= 0 and int(canon.max()) < 2**13
    # limbs stay bounded along a chain of products
    x, want = a, list(vals)
    for _ in range(30):
        x = F.mul(F.sub(x, b), F.add(x, a))
        want = [(w - y) * (w + z) % P for w, y, z in zip(want, other, vals)]
        assert int(x.abs().max()) < 2**14
    assert _ints(x) == want
    for v in (ref.GX, ref.P - 1, 2**256 - 1):
        assert np.array_equal(F.from_int(v), jeck.F.from_int(v))
    raw = np.frombuffer(bytes(range(64)), np.uint8).reshape(2, 32)
    assert np.array_equal(F.from_bytes_le(raw), jeck.F.from_bytes_le(raw))


def _affine(p):
    X, Y, Z = (_ints(c) for c in p)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, ref.P - 2, ref.P)
        out.append((x * zi % ref.P, y * zi % ref.P))
    return out


def test_plain_curve_ops_match_the_oracle():
    rng = random.Random(4)
    pts = [ref.pt_mul(rng.randrange(1, ref.N), (ref.GX, ref.GY))
           for _ in range(4)]
    x, y = pts[0]
    dev = torch.from_numpy(np.stack(
        [curve.from_affine_int(*p) for p in pts]
        + [curve.from_affine_int(x, ref.P - y),
           np.stack([F.from_int(0), F.from_int(1), F.from_int(0)])]
    ).astype(np.int64))
    P_ = tuple(dev[:, c] for c in range(3))
    Q_ = tuple(dev[[1, 2, 3, 0, 0, 5], c] for c in range(3))
    want = [ref.pt_add(pts[0], pts[1]), ref.pt_add(pts[1], pts[2]),
            ref.pt_add(pts[2], pts[3]), ref.pt_add(pts[3], pts[0]),
            None, None]  # P + (-P), identity + identity
    assert _affine(curve.add(P_, Q_)) == want
    assert _affine(curve.double(P_)) == [ref.pt_add(p, p) for p in pts] + [
        ref.pt_add((x, ref.P - y), (x, ref.P - y)), None]
    ks = [1, 2, 0xDEADBEEF, ref.N - 1]
    digs = torch.from_numpy(np.stack([
        np.frombuffer(k.to_bytes(32, "little"), np.uint8) for k in ks
    ]).astype(np.int64))
    nib = torch.stack([digs & 15, digs >> 4], -1).reshape(4, 64)
    g = tuple(dev[[0, 0, 0, 0], c] for c in range(3))
    assert _affine(curve.scalar_mul_windowed(nib, g)) == [
        ref.pt_mul(k, pts[0]) for k in ks]
    table = ef.base_points(torch.device("cpu"))
    assert _affine(curve.base_scalar_mul(digs, table)) == [
        ref.pt_mul(k, (ref.GX, ref.GY)) for k in ks]


# --------------------------------------------------------------------------
# host pack and tables: byte for byte the JAX package's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pad", [None, 32, 128])
def test_pack_batch_and_pack_rows_are_byte_identical(pad, cases):
    pubs, msgs, sigs, _ = cases
    pb = eck.pack_batch(pubs, msgs, sigs, pad_to=pad)
    jpb = jeck.pack_batch(pubs, msgs, sigs, pad_to=pad)
    for name in jeck.PackedEcdsaBatch._fields:
        a, b = getattr(pb, name), getattr(jpb, name)
        if isinstance(a, int):
            assert a == b, name
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(ef.pack_rows(pb), jep.pack_rows(jpb))
    assert (ef.E_QX, ef.E_XR1, ef.E_XR2, ef.E_U1, ef.E_U2, ef.E_FLAGS,
            ef.E_KROWS) == (jep.E_QX, jep.E_XR1, jep.E_XR2, jep.E_U1,
                            jep.E_U2, jep.E_FLAGS, jep.E_KROWS)
    assert ef.pad_to_tile(len(pubs)) == jep.pad_to_tile(len(pubs))


def test_secp_base_from_jax_equals_the_ports_own_table():
    t = convert.secp_base_from_jax(jep.base_table8_np())
    assert t.dtype == torch.int32 and tuple(t.shape) == (8192, 3, 10)
    assert np.array_equal(t.numpy(), ef.comb_table_np())
    # the plain version's table is the JAX package's, limb for limb
    assert np.array_equal(curve.base_table8_np().reshape(8192, 60),
                          jep.base_table8_np().astype(np.int64))
    with pytest.raises(ValueError):
        convert.secp_base_from_jax(jep.base_table8_np()[:100])


# --------------------------------------------------------------------------
# verify: plain version and the kernel's host build vs the oracle
# --------------------------------------------------------------------------


def test_plain_verify_matches_the_oracle(cases):
    pubs, msgs, sigs, rows = cases
    got = ef.verify_rows(rows, device="cpu").numpy()
    n = len(pubs)
    assert np.array_equal(got[:n], oracle(pubs, msgs, sigs))
    assert not got[n:].any()
    assert ef.ecdsa_verify.launches == 0  # the host never launches


def test_verify_batch_on_the_host_matches_the_oracle():
    pubs, msgs, sigs = ecdsa_cases(np.random.default_rng(22), n_valid=3)
    got = ef.verify_batch(pubs, msgs, sigs, device="cpu")
    assert got.shape == (len(pubs),)
    assert np.array_equal(got, oracle(pubs, msgs, sigs))


def _host_verify(lib, rows, table):
    rows = np.ascontiguousarray(rows)
    out = np.zeros(rows.shape[1], np.int32)
    lib.cbt_host_ecdsa_verify(rows.ctypes.data, rows.shape[1],
                              table.ctypes.data, out.ctypes.data)
    return out


@needs_cxx
def test_kernel_arithmetic_host_build_matches_the_oracle(cases):
    pubs, msgs, sigs, rows = cases
    out = _host_verify(_build.host_lib(), rows, ef.comb_table_np())
    n = len(pubs)
    assert np.array_equal(out[:n].astype(bool), oracle(pubs, msgs, sigs))
    assert not out[n:].any()


def _limbs26(v):
    return [(v >> (26 * i)) & ((1 << 26) - 1) for i in range(9)] + [v >> 234]


def _val26(limbs):
    return sum(int(x) << (26 * i) for i, x in enumerate(limbs))


@needs_cxx
def test_kernel_field_host_build_is_exact_near_p():
    lib = _build.host_lib()
    rng = random.Random(5)
    vals = EDGE_VALUES + [rng.randrange(0, 2**256) for _ in range(60)]
    a = np.array([_limbs26(v) for v in vals], np.int32)
    b = np.ascontiguousarray(a[::-1])
    other = vals[::-1]

    def run(op, x, y):
        out = np.zeros_like(x)
        lib.cbt_host_secp_fe(op, x.ctypes.data, y.ctypes.data, len(x),
                             out.ctypes.data)
        return out

    def canon(x):
        c = run(4, x, x)
        assert c.min() >= 0 and c[:, :9].max() < 2**26 and c[:, 9].max() < 2**22
        return [_val26(r) for r in c]

    P = ref.P
    assert canon(run(0, a, b)) == [x * y % P for x, y in zip(vals, other)]
    assert canon(run(1, a, a)) == [x * x % P for x in vals]
    assert canon(run(2, a, b)) == [(x + y) % P for x, y in zip(vals, other)]
    assert canon(run(3, a, b)) == [(x - y) % P for x, y in zip(vals, other)]
    assert canon(np.ascontiguousarray(-a)) == [(-x) % P for x in vals]
    assert canon(run(5, a, a)) == [pow(x, (P + 1) // 4, P) for x in vals]
    assert run(6, a, a)[:, 0].tolist() == [int(v % P == 0) for v in vals]
    assert run(7, a, a)[:, 0].tolist() == [v % P & 1 for v in vals]
    x, want = a, list(vals)
    for _ in range(60):
        x = run(0, run(3, x, b), run(2, x, a))
        want = [(w - y) * (w + z) % P for w, y, z in zip(want, other, vals)]
        assert x[:, :9].min() >= 0 and x[:, :9].max() < 2**26
        assert -8 <= x[:, 9].min() and x[:, 9].max() <= 2**26 + 8
    assert canon(x) == want


@needs_cxx
def test_field_op_count_behind_the_bound():
    lib = _build.host_lib(count_ops=True)
    table = ef.comb_table_np()
    m0, s0 = ctypes.c_longlong(), ctypes.c_longlong()
    m1, s1 = ctypes.c_longlong(), ctypes.c_longlong()
    for d in (3, 1 << 200, ref.N - 5):
        pub, msg = ref.pubkey_from_secret(d), b"count"
        rows = ef.pack_rows(eck.pack_batch([pub], [msg], [ref.sign(d, msg)],
                                           pad_to=1))
        lib.cbt_host_op_counts(ctypes.byref(m0), ctypes.byref(s0))
        assert _host_verify(lib, rows, table)[0] == 1
        lib.cbt_host_op_counts(ctypes.byref(m1), ctypes.byref(s1))
        assert m1.value - m0.value == ef.VERIFY_FE_MULS
        assert s1.value - s0.value == ef.VERIFY_FE_SQUARES
    assert ef.verify_products_per_signature() == 2836 * 100 + 759 * 55


def _quad_case(name):
    """(pubs, msgs, sigs, B) of one input the quad program is held on."""
    rng = np.random.default_rng(90)
    if name == "edge_cases":
        return (*ecdsa_cases(rng), 32)
    n = {"random_tampered": 64, "ragged": 13, "one": 1, "all_padding": 0}[
        name]
    pubs, msgs, sigs = [], [], []
    for _ in range(n):
        d = int(rng.integers(1, 2**62)) * int(rng.integers(1, 2**62))
        m = rng.bytes(int(rng.integers(0, 120)))
        pubs.append(ref.pubkey_from_secret(d))
        msgs.append(m)
        sigs.append(ref.sign(d, m))
    if name == "random_tampered":
        for i in rng.choice(n, 12, replace=False):
            b = int(rng.integers(0, 64))
            sigs[i] = sigs[i][:b] + bytes([sigs[i][b] ^ (1 << int(
                rng.integers(0, 8)))]) + sigs[i][b + 1:]
        for i in rng.choice(n, 4, replace=False):
            msgs[i] = msgs[i] + b"~"
    B = {"random_tampered": 64, "ragged": 17, "one": 1, "all_padding": 64}[
        name]
    return pubs, msgs, sigs, B


@needs_cxx
@pytest.mark.parametrize("name", ["edge_cases", "random_tampered", "ragged",
                                  "one", "all_padding"])
def test_quad_lane_program_matches_host_plain_and_oracle(name):
    """cbt_host_ecdsa_verify_quad runs the quad kernel's lane program
    (csrc/secp256k1_quad.cuh) with its four lanes on one thread; it must
    give the single-thread host build's, the plain version's and the
    oracle's verdict on every column, padding and the xr2 case included."""
    pubs, msgs, sigs, B = _quad_case(name)
    rows = ef.pack_rows(eck.pack_batch(pubs, msgs, sigs, pad_to=B))
    assert rows.shape[1] == B
    lib, table = _build.host_lib(), ef.comb_table_np()
    quad = np.zeros(B, np.int32)
    lib.cbt_host_ecdsa_verify_quad(rows.ctypes.data, B, table.ctypes.data,
                                   quad.ctypes.data)
    assert np.array_equal(quad, _host_verify(lib, rows, table))
    plain = ef.ecdsa_verify_plain(torch.from_numpy(rows),
                                  ef.base_points(torch.device("cpu")))
    assert np.array_equal(quad, plain.numpy())
    assert np.array_equal(quad[:len(pubs)].astype(bool),
                          oracle(pubs, msgs, sigs))
    assert not quad[len(pubs):].any()
    if name == "edge_cases":  # the xr2 row verifies only through r + N
        assert quad[len(pubs) - 2] == 1


def _proj(pts, rng):
    """Affine points (None: the identity) -> (n, 3, 10) int32 projective
    (X, Y, Z) in 26-bit limbs, each scaled by a random Z (the identity as
    (0, Z, 0))."""
    out = []
    for p in pts:
        z = int(rng.integers(1, 2**62)) ** 4 % ref.P
        x, y = (0, 1) if p is None else p
        xyz = (0 if p is None else x * z % ref.P, y * z % ref.P,
               0 if p is None else z)
        out.append([_limbs26(c) for c in xyz])
    return np.ascontiguousarray(np.array(out, np.int32))


def _quad_pt(lib, op, a, b):
    n = len(a)
    out = np.zeros((n, 4, 10), np.int32)
    lib.cbt_host_secp_quad_pt(op, a.ctypes.data, b.ctypes.data, n,
                              out.ctypes.data)
    res = []
    for lanes in out:
        y0, y1, z, x = (_val26(r) % ref.P for r in lanes)
        assert y0 == y1  # lanes 0 and 1 both hold Y
        if z == 0:
            assert x == 0 and y0 != 0
            res.append(None)
            continue
        zi = pow(z, ref.P - 2, ref.P)
        res.append((x * zi % ref.P, y0 * zi % ref.P))
    return res


@needs_cxx
def test_quad_point_ops_are_complete():
    """The quad's addition and doubling (no branch) on the inputs the
    complete formulas must carry: random points, the identity on either
    side and on both, P + P, P + (-P), and comb entries of G (Z = 1, the
    identity rows (0, 1, 0)) as addends; against the oracle's point
    operations."""
    lib = _build.host_lib()
    rng = np.random.default_rng(91)
    pts = [ref.pt_mul(int(rng.integers(1, 2**62)) * 7919 + i,
                      (ref.GX, ref.GY)) for i in range(8)]
    neg = [(x, ref.P - y) for x, y in pts]
    pairs = ([(pts[i], pts[i + 1]) for i in range(7)]
             + [(None, pts[0]), (pts[1], None), (None, None)]
             + [(p, p) for p in pts[:3]] + [(p, q) for p, q in
                                            zip(pts[:3], neg[:3])])
    a = _proj([p for p, _ in pairs], rng)
    b = _proj([q for _, q in pairs], rng)
    assert _quad_pt(lib, 0, a, b) == [ref.pt_add(p, q) for p, q in pairs]
    singles = pts + neg[:2] + [None]
    a = _proj(singles, rng)
    assert _quad_pt(lib, 1, a, a) == [ref.pt_add(p, p) for p in singles]
    # comb entries as addends: [d 256^w]G with Z = 1, and d = 0's identity
    table = ef.comb_table_np()
    idx = [0, 1, 2, 255, 256, 257, 31 * 256, 31 * 256 + 200, 8191]
    comb = np.ascontiguousarray(table[idx])
    want_b = [None if d % 256 == 0 else ref.pt_mul(
        (d % 256) * 256 ** (d // 256), (ref.GX, ref.GY)) for d in idx]
    assert all(comb[i, 2, 0] == (0 if w is None else 1)
               for i, w in enumerate(want_b))
    acc = [pts[i % 8] for i in range(len(idx))]
    acc[1] = want_b[1]      # P + P through a comb entry
    acc[3] = None           # the identity plus a comb entry
    acc[5] = (want_b[5][0], ref.P - want_b[5][1])  # P + (-P)
    got = _quad_pt(lib, 0, _proj(acc, rng), comb)
    assert got == [ref.pt_add(p, q) for p, q in zip(acc, want_b)]


@pytest.mark.slow  # ~70 s or more: the JAX XLA ECDSA kernel's compile
def test_plain_verify_matches_jax_xla_kernel(cases):
    pubs, msgs, sigs, rows = cases
    got = ef.verify_rows(rows, device="cpu").numpy()[:len(pubs)]
    assert np.array_equal(got, jeck.verify_batch(pubs, msgs, sigs))


@pytest.mark.slow  # ~6-8 min: the JAX Pallas kernel in interpret mode
def test_plain_verify_matches_jax_pallas_interpret(cases):
    pubs, msgs, sigs, rows = cases
    rows = ef.pack_rows(eck.pack_batch(pubs, msgs, sigs, pad_to=128))
    got = ef.verify_rows(rows, device="cpu").numpy()
    assert np.array_equal(got, np.asarray(jep.verify_rows(rows)))


# --------------------------------------------------------------------------
# a mixed ed25519 + sr25519 + secp256k1 commit through the VerifyCommit
# family, against the JAX package
# --------------------------------------------------------------------------

CHAIN = "mixed-chain"
HEIGHT = 41


class MixedPair:
    """One 9-validator commit (three of each key type) built from each
    package's types; `bad` tampers validator idx's signature."""

    def __init__(self, bad=None):
        privs = []
        for i in range(9):
            seed = bytes([60 + i]) * 32
            kind = i % 3
            privs.append((tkeys.PrivKey.generate(seed), jkeys.PrivKey.generate(
                seed)) if kind == 0 else (tkeys.Sr25519PrivKey.generate(seed),
                                          jkeys.Sr25519PrivKey.generate(seed))
                if kind == 1 else (tkeys.Secp256k1PrivKey.generate(seed),
                                   jkeys.Secp256k1PrivKey.generate(seed)))
        powers = [100 + 10 * i for i in range(9)]
        self.tvals = tval.ValidatorSet([tval.Validator(t.pub_key(), w)
                                        for (t, _), w in zip(privs, powers)])
        self.jvals = jval.ValidatorSet([jval.Validator(
            jkeys.PubKey(j.pub_key().data, j.pub_key().key_type), w)
            for (_, j), w in zip(privs, powers)])
        signer = {t.pub_key().address(): t for t, _ in privs}
        self.tbid = tbid.BlockID(b"\x31" * 32, tbid.PartSetHeader(3, b"\x32"
                                                                  * 32))
        self.jbid = jbid.BlockID(b"\x31" * 32, jbid.PartSetHeader(3, b"\x32"
                                                                  * 32))
        ts_, js = [], []
        for idx, v in enumerate(self.tvals.validators):
            t = (1_700_000_000 + 997 * idx, idx * 7_777_777)
            ts_.append(tcommit.CommitSig(tcommit.BLOCK_ID_FLAG_COMMIT,
                                         v.address, tts.Timestamp(*t)))
            js.append(jcommit.CommitSig(jcommit.BLOCK_ID_FLAG_COMMIT,
                                        v.address, jts.Timestamp(*t)))
        self.tc = tcommit.Commit(HEIGHT, 0, self.tbid, ts_)
        self.jc = jcommit.Commit(HEIGHT, 0, self.jbid, js)
        for idx, (a, b) in enumerate(zip(ts_, js)):
            sig = signer[a.validator_address].sign(
                self.tc.vote_sign_bytes(CHAIN, idx))
            if idx == bad:
                sig = sig[:20] + bytes([sig[20] ^ 4]) + sig[21:]
            a.signature = b.signature = sig


def outcome(fn, *args):
    try:
        fn(*args)
        return ("ok",)
    except (jv.InvalidSignatureError, tv.InvalidSignatureError) as e:
        return ("InvalidSignatureError", e.idx)
    except (jv.NotEnoughPowerError, tv.NotEnoughPowerError) as e:
        return ("NotEnoughPowerError", e.got, e.needed)


def _calls(p, which, port: bool):
    if which == "verify_commit_light_trusting":
        return ((tv if port else jv).verify_commit_light_trusting, CHAIN,
                p.tvals if port else p.jvals, p.tc if port else p.jc, (1, 3))
    return (getattr(tv if port else jv, which), CHAIN,
            p.tvals if port else p.jvals, p.tbid if port else p.jbid,
            HEIGHT, p.tc if port else p.jc)


def _bad_index(p, kind):
    return next(i for i, v in enumerate(p.tvals.validators)
                if v.pub_key.key_type == kind)


@pytest.fixture(scope="module")
def mixed():
    clean = MixedPair()
    pairs = {None: clean}
    for kind in ("sr25519", "secp256k1"):
        pairs[kind] = MixedPair(_bad_index(clean, kind))
    return pairs


# each verify is three plain kernels on 128 columns (~7 s on one core), so
# the matrix is cut to six cells that still cover every call and tamper
MIXED = [("verify_commit", None), ("verify_commit", "sr25519"),
         ("verify_commit", "secp256k1"), ("verify_commit_light", "secp256k1"),
         ("verify_commit_light_trusting", None),
         ("verify_commit_light_trusting", "sr25519")]


@pytest.mark.parametrize("which,kind", MIXED)
def test_mixed_commit_same_outcome_as_the_jax_package(mixed, which, kind):
    p = mixed[kind]
    bad = None if kind is None else _bad_index(p, kind)
    assert {v.pub_key.key_type for v in p.tvals.validators} == {
        "ed25519", "sr25519", "secp256k1"}
    faults = tbatch.device_breaker().faults
    port_out = outcome(*_calls(p, which, True),
                       tv.device_batch_fn(device="cpu"))
    jax_out = outcome(*_calls(p, which, False), jv.oracle_batch_fn())
    assert port_out == jax_out
    assert tbatch.device_breaker().faults == faults
    if which == "verify_commit" and bad is not None:
        assert port_out == ("InvalidSignatureError", bad)


def test_mixed_commit_makes_one_kernel_call_per_key_type(monkeypatch, mixed):
    p = mixed[None]
    routed = []
    real = tbatch._kernel_for

    def counting(kt):
        fn = real(kt)

        def call(pubs, msgs, sigs, device=None):
            routed.append((kt, len(pubs)))
            return fn(pubs, msgs, sigs, device=device)
        return call

    monkeypatch.setattr(tbatch, "_kernel_for", counting)
    tv.verify_commit(CHAIN, p.tvals, p.tbid, HEIGHT, p.tc,
                     tv.device_batch_fn(device="cpu"))
    assert sorted(routed) == [("ed25519", 3), ("secp256k1", 3),
                              ("sr25519", 3)]


def test_unknown_key_type_rows_are_invalid_not_raised(mixed):
    p = mixed[None]
    keep = [i for i, v in enumerate(p.tvals.validators)
            if v.pub_key.key_type == "secp256k1"]
    pubs = [p.tvals.validators[i].pub_key for i in keep]
    msgs = p.tc.sign_bytes_rows(CHAIN, keep)
    sigs = [p.tc.signatures[i].signature for i in keep]
    pubs[1] = tkeys.PubKey(pubs[1].data, "bls12381")
    valid = tbatch.verify_batch(pubs, msgs, sigs, device="cpu",
                                breaker=tbatch.CircuitBreaker())
    assert valid.tolist() == [True, False, True]


@pytest.mark.slow  # ~2 min: the JAX XLA ed25519 and ECDSA kernels compile
@pytest.mark.parametrize("kind", [None, "secp256k1"])
def test_mixed_commit_matches_jax_device_batch_fn(monkeypatch, kind):
    """Against JAX device_batch_fn(use_pallas=False). Its sr25519 group
    would run the Pallas kernel in interpret mode (~6 min), so that one
    seam is pointed at the JAX oracle."""
    from cometbft_tpu.crypto import sr25519_ref as jsr
    from cometbft_tpu.ops import sr25519_kernel as jsrk

    monkeypatch.setattr(jsrk, "verify_batch", lambda pubs, msgs, sigs: np.asarray(
        [jsr.verify(a, b, c) for a, b, c in zip(pubs, msgs, sigs)]))
    p = MixedPair()
    if kind is not None:
        p = MixedPair(_bad_index(p, kind))
    for which in ("verify_commit", "verify_commit_light"):
        port_out = outcome(*_calls(p, which, True),
                           tv.device_batch_fn(device="cpu"))
        jax_out = outcome(*_calls(p, which, False),
                          jv.device_batch_fn(use_pallas=False))
        assert port_out == jax_out
