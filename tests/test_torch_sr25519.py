"""The port's sr25519 slice against the JAX package on the same seeded
inputs: the copied keccak, merlin, ristretto and schnorrkel oracles agree
with the JAX package's, `pack_batch_sr` rows are byte-identical, and the
plain PyTorch verify and the host build of the kernel's arithmetic
(csrc/ristretto_core.cuh) give exactly the oracle's verdicts. The CUDA
kernel itself runs in tests/test_torch_cuda.py."""
import ctypes
import hashlib
import shutil

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keccak as jkeccak
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import merlin as jmerlin
from cometbft_tpu.crypto import ristretto_ref as jrist
from cometbft_tpu.crypto import sr25519_ref as jsr
from cometbft_tpu.ops import sr25519_kernel as jsrk
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.crypto import keccak, merlin
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import ristretto_ref as rist
from cometbft_tpu_torch.crypto import sr25519_ref as sr
from cometbft_tpu_torch.edge_cases import sr25519_cases
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import field as fe
from cometbft_tpu_torch.ops import sr25519_kernel as srk

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
    return np.asarray([jsr.verify(p, m, s) for p, m, s in zip(pubs, msgs,
                                                               sigs)])


@pytest.fixture(scope="module")
def cases():
    pubs, msgs, sigs = sr25519_cases(np.random.default_rng(11))
    rows = srk.pack_batch_sr(pubs, msgs, sigs, pad_to=32)
    return pubs, msgs, sigs, rows


# --------------------------------------------------------------------------
# copied host modules against the JAX package's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 135, 136, 137, 500])
def test_keccak_sponge_matches_hashlib_and_jax(n):
    d = np.random.default_rng(n).bytes(n)
    assert keccak.sha3_256(d) == hashlib.sha3_256(d).digest()
    assert keccak.sha3_256(d) == jkeccak.sha3_256(d)


def test_batched_keccak_matches_jax_and_scalar():
    rng = np.random.default_rng(1)
    sts = rng.integers(0, 1 << 63, (6, 25), np.int64).astype(np.uint64)
    out = keccak.keccak_f1600_np(sts.copy())
    assert np.array_equal(out, jkeccak.keccak_f1600_np(sts.copy()))
    for i in range(6):
        assert [int(x) for x in out[i]] == keccak.keccak_f1600(
            [int(x) for x in sts[i]])


def test_merlin_conformance_vector_and_batch_match_jax():
    t = merlin.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")
    rng = np.random.default_rng(2)
    for ln in (0, 40, 170, 400):  # 170 and 400 cross the 166-byte rate
        msgs = np.frombuffer(rng.bytes(5 * ln), np.uint8).reshape(5, ln)
        outs = []
        for mod in (merlin, jmerlin):
            prefix = mod.Transcript(b"proto")
            prefix.append_message(b"ctx", b"shared")
            bt = mod.BatchTranscript(5, prefix)
            bt.append_message_batch(b"m", msgs)
            bt.append_message_shared(b"s", b"xyz")
            outs.append(bt.challenge_bytes_batch(b"c", 64))
        assert np.array_equal(outs[0], outs[1])
        for i in range(5):
            ts = jmerlin.Transcript(b"proto")
            ts.append_message(b"ctx", b"shared")
            ts.append_message(b"m", bytes(msgs[i]))
            ts.append_message(b"s", b"xyz")
            assert bytes(outs[0][i]) == ts.challenge_bytes(b"c", 64)


def test_ristretto_oracle_matches_jax():
    encs = [rist.encode(ed.pt_mul(k, ed.BASE_EXT))
            for k in (1, 2, 7, 123456, ed.L - 1)]
    encs += [s.to_bytes(32, "little") for s in range(0, 40)]
    encs += [(rist.P + 2).to_bytes(32, "little"), b"\xff" * 32, b"\x00" * 31]
    decoded = 0
    for b in encs:
        got, want = rist.decode(b), jrist.decode(b)
        assert got == want
        if got is not None:
            decoded += 1
            assert rist.encode(got) == jrist.encode(want) == b
            assert rist.equals(got, want)
    assert 5 < decoded < len(encs)
    for u, v in [(1, 5), (3, 7), (2, 0), (0, 9)]:
        assert rist.sqrt_ratio_m1(u, v) == jrist.sqrt_ratio_m1(u, v)


def test_sr25519_oracle_and_keys_match_jax():
    rng = np.random.default_rng(3)
    for i in range(4):
        seed, m, rnd = rng.bytes(32), rng.bytes(30 * i), rng.bytes(32)
        pk = sr.pubkey_from_seed(seed)
        assert pk == jsr.pubkey_from_seed(seed)
        sig = sr.sign(seed, m, rnd)
        assert sig == jsr.sign(seed, m, rnd)
        assert sr.sign_many(seed, [m, m + b"x"], rnd) == (
            pk, [sig, jsr.sign(seed, m + b"x", rnd)])
        assert sr.challenge_scalar(m, pk, sig[:32]) == \
            jsr.challenge_scalar(m, pk, sig[:32])
        assert sr.verify(pk, m, sig) and jsr.verify(pk, m, sig)
        assert not sr.verify(pk, m + b"!", sig)
    priv = tkeys.Sr25519PrivKey.generate(b"\x11" * 32)
    jpriv = jkeys.Sr25519PrivKey.generate(b"\x11" * 32)
    pub = priv.pub_key()
    assert pub.key_type == tkeys.SR25519_KEY_TYPE
    assert pub.data == jpriv.pub_key().data
    assert pub.address() == jpriv.pub_key().address()
    sig = priv.sign(b"hello")
    assert pub.verify_signature(b"hello", sig)
    assert jpriv.pub_key().verify_signature(b"hello", sig)
    assert not pub.verify_signature(b"hellp", sig)


def test_case_mix_covers_every_edge(cases):
    pubs, msgs, sigs, _ = cases
    exp = oracle(pubs, msgs, sigs)
    assert exp[:16].all() and exp[-1]
    assert not exp[16:-1].any()


# --------------------------------------------------------------------------
# host pack: byte for byte the JAX package's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_batch_sr_is_byte_identical(seed, cases):
    pubs, msgs, sigs, rows = cases
    if seed:
        rng = np.random.default_rng(seed)
        pubs, msgs, sigs = pubs[:16], msgs[:16], sigs[:16]
        n = len(pubs)
        power5 = ek.power_limbs(rng.integers(1, 2**40, 128))
        counted = rng.random(128) < 0.9
        cids = (np.arange(128) % 3).astype(np.int32)
        th = ek.threshold_limbs(12345, 3)
        rows = srk.pack_batch_sr(pubs, msgs, sigs, pad_to=128,
                                 power5=power5, counted=counted,
                                 commit_ids=cids, thresh=th)
        want = jsrk.pack_batch_sr(pubs, msgs, sigs, pad_to=128,
                                  power5=power5, counted=counted,
                                  commit_ids=cids, thresh=th)
        assert rows.shape[1] == 128 and n == 16
    else:
        # JAX's challenge batching reshapes every key to 32 bytes, so the
        # short-key row is left out of its pack
        keep = [i for i, p in enumerate(pubs) if len(p) == 32]
        sub = [[x[i] for i in keep] for x in (pubs, msgs, sigs)]
        rows = srk.pack_batch_sr(*sub, pad_to=32)
        want = jsrk.pack_batch_sr(*sub, pad_to=32)
    assert rows.dtype == np.int32
    assert np.array_equal(rows, want)


def test_batch_challenges_group_by_length():
    rng = np.random.default_rng(4)
    msgs = [rng.bytes(int(k)) for k in rng.integers(0, 4, 12) * 60]
    pubs = [rng.bytes(32) for _ in msgs]
    rs = [rng.bytes(32) for _ in msgs]
    ch = srk.batch_challenges(msgs, pubs, rs)
    assert len({len(m) for m in msgs}) >= 3
    for i in range(12):
        assert int.from_bytes(bytes(ch[i]), "little") % sr.L == \
            jsr.challenge_scalar(msgs[i], pubs[i], rs[i])


# --------------------------------------------------------------------------
# verify: plain version and the kernel's host build vs the oracle
# --------------------------------------------------------------------------


def test_plain_rist_decode_matches_the_oracle():
    encs = [s.to_bytes(32, "little") for s in range(0, 64, 2)]
    encs += [rist.encode(ed.pt_mul(k, ed.BASE_EXT)) for k in (1, 9, 77)]
    limbs = torch.from_numpy(fe.from_bytes_le(
        np.frombuffer(b"".join(encs), np.uint8).reshape(-1, 32)
    ).astype(np.int64))
    (x, y, z, t), ok = srk.rist_decode(limbs)
    for i, b in enumerate(encs):
        want = rist.decode(b)
        assert bool(ok[i]) == (want is not None)
        if want is not None:
            got = [int(v) for v in fe.limbs_to_int(
                fe.canonical(torch.stack([x[i], y[i], t[i]])).numpy())]
            assert got == [want[0], want[1], want[3]]


def test_plain_verify_matches_the_oracle(cases):
    pubs, msgs, sigs, rows = cases
    got = srk.verify_rows(rows, device="cpu").numpy()
    n = len(pubs)
    assert np.array_equal(got[:n], oracle(pubs, msgs, sigs))
    assert not got[n:].any()
    assert srk.sr25519_verify.launches == 0  # the host never launches


def test_verify_batch_on_the_host_matches_the_oracle():
    pubs, msgs, sigs = sr25519_cases(np.random.default_rng(12), n_valid=4)
    got = srk.verify_batch(pubs, msgs, sigs, device="cpu")
    assert got.shape == (len(pubs),)
    assert np.array_equal(got, oracle(pubs, msgs, sigs))


def test_short_key_is_invalid_without_a_device_fault():
    """A 31-byte sr25519 key through the port's batch verifier: the row is
    invalid, as the oracle says, the rest of the batch verifies, and the
    breaker records no fault. The JAX package's challenge batching raises
    on the key instead, and its breaker counts that as a device fault
    before it host-verifies the group (ROADMAP, faults of the reference):
    the port must not copy it, since its breaker fails the batch on a
    device fault, so one malformed key from a peer would fail a commit."""
    from cometbft_tpu_torch.crypto import batch as cbatch

    pubs, msgs, sigs = sr25519_cases(np.random.default_rng(14), n_valid=4)
    short = [i for i, p in enumerate(pubs) if len(p) == 31]
    assert len(short) == 1
    with pytest.raises(ValueError):
        jsrk.batch_challenges(msgs, pubs, [s[:32] for s in sigs])
    keys = [tkeys.PubKey(p, tkeys.SR25519_KEY_TYPE) for p in pubs]
    brk = cbatch.device_breaker()
    before = (brk.faults, brk.trips)
    got = cbatch.verify_batch(keys, msgs, sigs, device="cpu")
    assert (brk.faults, brk.trips) == before
    assert got.tolist() == [sr.verify(p, m, s)
                            for p, m, s in zip(pubs, msgs, sigs)]
    assert got.tolist() == oracle(pubs, msgs, sigs).tolist()
    assert not got[short[0]] and got[:4].all()


def test_verify_tally_rows_on_the_host():
    pubs, msgs, sigs = sr25519_cases(np.random.default_rng(13), n_valid=6)
    n = len(pubs)
    powers = np.arange(1, 129) * 1000
    cids = (np.arange(128) % 2).astype(np.int32)
    counted = np.arange(128) < n
    exp = oracle(pubs, msgs, sigs)
    sums = [int(powers[:n][exp & (cids[:n] == c)].sum()) for c in range(2)]
    th = np.stack([ek.threshold_limbs(sums[0] - 1)[0],
                   ek.threshold_limbs(sums[1])[0]])
    rows = srk.pack_batch_sr(pubs, msgs, sigs, pad_to=128,
                             power5=ek.power_limbs(powers), counted=counted,
                             commit_ids=cids, thresh=th)
    valid, tally, quorum = srk.verify_tally_rows(rows, 2, device="cpu")
    assert np.array_equal(valid.numpy()[:n], exp)
    assert [int(v) for v in ek.tally_to_int(tally.numpy())] == sums
    assert quorum.tolist() == [True, False]


def _host_verify(lib, rows, table):
    rows = np.ascontiguousarray(rows)
    out = np.zeros(rows.shape[1], np.int32)
    lib.cbt_host_sr25519_verify(rows.ctypes.data, rows.shape[1],
                                table.ctypes.data, out.ctypes.data)
    return out


@needs_cxx
def test_kernel_arithmetic_host_build_matches_the_oracle(cases):
    pubs, msgs, sigs, rows = cases
    out = _host_verify(_build.host_lib(), rows, kf.niels_table_np())
    n = len(pubs)
    assert np.array_equal(out[:n].astype(bool), oracle(pubs, msgs, sigs))
    assert not out[n:].any()


def _quad_case(name):
    """(pubs, msgs, sigs, B) of one input the quad program is held on."""
    rng = np.random.default_rng(80)
    if name == "edge_cases":
        return (*sr25519_cases(rng, n_valid=16), 32)
    n = {"random_tampered": 64, "ragged": 13, "one": 1, "all_padding": 0}[
        name]
    pubs, msgs, sigs = [], [], []
    for _ in range(n):
        m = rng.bytes(int(rng.integers(0, 120)))
        pk, (sig,) = sr.sign_many(rng.bytes(32), [m], rng=rng.bytes(32))
        pubs.append(pk)
        msgs.append(m)
        sigs.append(sig)
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
    """cbt_host_sr25519_verify_quad runs the quad kernel's lane program
    (csrc/sr25519_quad.cuh) with its four lanes on one thread; it must give
    the single-thread host build's, the plain version's and the oracle's
    verdict on every column, padding included."""
    pubs, msgs, sigs, B = _quad_case(name)
    rows = srk.pack_batch_sr(pubs, msgs, sigs, pad_to=B)
    assert rows.shape[1] == B
    lib, table = _build.host_lib(), kf.niels_table_np()
    quad = np.zeros(B, np.int32)
    lib.cbt_host_sr25519_verify_quad(rows.ctypes.data, B, table.ctypes.data,
                                     quad.ctypes.data)
    assert np.array_equal(quad, _host_verify(lib, rows, table))
    plain = srk.sr25519_verify_plain(torch.from_numpy(rows),
                                     kf.base_points(torch.device("cpu")))
    assert np.array_equal(quad, plain.numpy())
    assert np.array_equal(quad[:len(pubs)].astype(bool),
                          oracle(pubs, msgs, sigs))
    assert not quad[len(pubs):].any()


@needs_cxx
def test_field_op_count_behind_the_bound():
    """The per-signature multiplication count the bound uses is the count
    the kernel's code performs (one more per decode whose check is -1 or
    -sqrt(-1))."""
    lib = _build.host_lib(count_ops=True)
    table = kf.niels_table_np()
    m0, s0 = ctypes.c_longlong(), ctypes.c_longlong()
    m1, s1 = ctypes.c_longlong(), ctypes.c_longlong()
    rng = np.random.default_rng(14)
    for _ in range(4):
        pk, (sig,) = sr.sign_many(rng.bytes(32), [b"count"], rng=bytes(32))
        rows = srk.pack_batch_sr([pk], [b"count"], [sig], pad_to=1)
        lib.cbt_host_op_counts(ctypes.byref(m0), ctypes.byref(s0))
        assert _host_verify(lib, rows, table)[0] == 1
        lib.cbt_host_op_counts(ctypes.byref(m1), ctypes.byref(s1))
        assert s1.value - s0.value == srk.VERIFY_FE_SQUARES
        assert 0 <= m1.value - m0.value - srk.VERIFY_FE_MULS <= 2
    assert srk.verify_products_per_signature() == 1732 * 100 + 1522 * 55


@pytest.mark.slow  # ~3-6 min: the JAX Pallas kernel in interpret mode
def test_plain_verify_matches_jax_pallas_interpret(cases):
    pubs, msgs, sigs, rows = cases
    keep = [i for i, p in enumerate(pubs) if len(p) == 32]
    sub = [[x[i] for i in keep] for x in (pubs, msgs, sigs)]
    rows = srk.pack_batch_sr(*sub, pad_to=128)
    got = srk.verify_rows(rows, device="cpu").numpy()
    want = np.asarray(jsrk.verify_rows(rows))
    assert np.array_equal(got, want)
