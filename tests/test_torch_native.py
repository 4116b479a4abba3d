"""The port's native host packer (cometbft_tpu_torch/native over
csrc/hostaccel.cpp) against the JAX package's native packer and against the
port's numpy plain versions, byte for byte and dtype for dtype, on seeded
inputs; then the slice on the CPU: verify_commit, the pipeline's
host-packed chunks and commit_packed_batch against the JAX package."""
import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu import native as jn
from cometbft_tpu.blocksync import pipeline as jp
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.ops import ed25519_kernel as jek
from cometbft_tpu.ops import sr25519_kernel as jsrk
from cometbft_tpu.types import block_id as jbid
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validation as jv
from cometbft_tpu.types import validator as jval
from cometbft_tpu_torch import native as tn
from cometbft_tpu_torch.blocksync import pipeline as bp
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.crypto import keccak, merlin
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import sr25519_ref as sr
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_stamp as es
from cometbft_tpu_torch.ops import sr25519_kernel as srk
from cometbft_tpu_torch.types import block_id as tbid
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import validation as tv
from cometbft_tpu_torch.types import validator as tval

CHAIN = "native-chain"
L = ed.L
# (seconds, nanos): zero fields (omitted from the encoding), negative
# values (10-byte varints), the largest nanos, varint width edges
TIMESTAMPS = [(0, 0), (0, 5), (1_700_000_000, 0), (-1, 0), (0, -7),
              (-2**63, -2**31), (2**63 - 1, 999_999_999), (127, 128),
              (16383, 16384), (1_700_000_000, 999_999_999)]

# The plain versions run many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the host.
torch.set_num_threads(1)


def _same(a, b):
    """Equal bytes, dtype and shape, through tuples of arrays."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _msgs(rng, n):
    """n messages of 0-300 bytes, both ends included once n >= 2."""
    lens = rng.integers(0, 301, n)
    if n >= 2:
        lens[:2] = (0, 300)
    return [rng.bytes(int(k)) for k in lens]


def _keys_sigs(rng, n):
    """n 32-byte keys and 64-byte signatures; every third S >= L."""
    pubs = [rng.bytes(32) for _ in range(n)]
    sigs = [rng.bytes(64) for _ in range(n)]
    for i in range(0, n, 3):
        sigs[i] = sigs[i][:32] + bytes([0xFF] * 32)
    return pubs, sigs


def _digests(rng, n):
    """(n, 64) digests: 0, L - 1, L and 2^512 - 1 first, then seeded."""
    edges = [0, L - 1, L, 2**512 - 1]
    vals = edges[:n] + [int.from_bytes(rng.bytes(64), "little")
                        for _ in range(n - len(edges[:n]))]
    return np.frombuffer(b"".join(v.to_bytes(64, "little") for v in vals),
                         np.uint8).reshape(n, 64)


def _mod_l(digests):
    return np.frombuffer(b"".join(
        (int.from_bytes(bytes(d), "little") % L).to_bytes(32, "little")
        for d in digests), np.uint8).reshape(len(digests), 32)


def _ts_rows(rng, n):
    return [TIMESTAMPS[i % len(TIMESTAMPS)] if i < 2 * len(TIMESTAMPS)
            else (int(rng.integers(0, 2**40)), int(rng.integers(0, 10**9)))
            for i in range(n)]


def _templates():
    """Block and nil sign-bytes templates of one precommit."""
    bid = tbid.BlockID(b"\x11" * 32, tbid.PartSetHeader(3, b"\x22" * 32))
    return [canonical.VoteRowTemplate(CHAIN, canonical.PRECOMMIT_TYPE, 9, 2,
                                      b) for b in (bid, None)]


def _sha512(rng, n):
    rows = _msgs(rng, n)
    plain = np.frombuffer(b"".join(hashlib.sha512(r).digest() for r in rows),
                          np.uint8).reshape(n, 64)
    return tn.batch_sha512(rows), jn.batch_sha512(rows), plain


def _r_a_msgs(rng, n):
    r = rng.integers(0, 256, (n, 32), np.uint8)
    a = rng.integers(0, 256, (n, 32), np.uint8)
    return r, a, _msgs(rng, n)


def _digest_rows(r, a, msgs):
    return np.frombuffer(b"".join(
        hashlib.sha512(bytes(r[i]) + bytes(a[i]) + m).digest()
        for i, m in enumerate(msgs)), np.uint8).reshape(len(msgs), 64)


def _batch_digest(rng, n):
    r, a, msgs = _r_a_msgs(rng, n)
    return (tn.ed25519_batch_digest(r, a, msgs),
            jn.ed25519_batch_digest(r, a, msgs), _digest_rows(r, a, msgs))


def _batch_challenge(rng, n):
    r, a, msgs = _r_a_msgs(rng, n)
    return (tn.ed25519_batch_challenge(r, a, msgs),
            jn.ed25519_batch_challenge(r, a, msgs),
            _mod_l(_digest_rows(r, a, msgs)))


def _reduce(rng, n):
    d = _digests(rng, n)
    return tn.batch_reduce_mod_l(d), jn.batch_reduce_mod_l(d), _mod_l(d)


def _plain_pack(pb):
    return (pb.ay, pb.asign, pb.ry, pb.rsign, pb.sdig, pb.hdig, pb.precheck)


def _pack(rng, n):
    pubs, sigs = _keys_sigs(rng, n)
    msgs = _msgs(rng, n)
    pub_cat, sig_cat = b"".join(pubs), b"".join(sigs)
    return (tn.ed25519_pack(pub_cat, sig_cat, msgs, n + 3),
            jn.ed25519_pack(pub_cat, sig_cat, msgs, n + 3),
            _plain_pack(ek.pack_batch(pubs, msgs, sigs, pad_to=n + 3,
                                      native=False)))


def _pack_commits(rng, n):
    pubs, sigs = _keys_sigs(rng, n)
    tpls = _templates()
    which = np.arange(n, dtype=np.int32) % 2  # block, nil, block, ...
    ts = _ts_rows(rng, n)
    secs = np.asarray([s for s, _ in ts], np.int64)
    nanos = np.asarray([t for _, t in ts], np.int64)
    msgs = [tpls[w].bytes_for(tts.Timestamp(s, t))
            for w, (s, t) in zip(which, ts)]
    args = (b"".join(pubs), b"".join(sigs), [t.template for t in tpls],
            which, secs, nanos, n + 2)
    return (tn.ed25519_pack_commits(*args), jn.ed25519_pack_commits(*args),
            _plain_pack(ek.pack_batch(pubs, msgs, sigs, pad_to=n + 2,
                                      native=False)))


def _keccak(rng, n):
    st = rng.integers(0, 2**63, (n, 25), np.int64).astype(np.uint64)
    st[:, 0] |= np.uint64(1 << 63)
    return (tn.batch_keccak_f1600(st), jn.batch_keccak_f1600(st),
            keccak.keccak_f1600_np(st.copy()))


def _sr_challenges(rng, n, ln=160):
    msgs = rng.integers(0, 256, (n, ln), np.uint8)
    pks = rng.integers(0, 256, (n, 32), np.uint8)
    rs = rng.integers(0, 256, (n, 32), np.uint8)
    prefix = sr._signing_prefix()
    st = prefix.strobe
    args = (bytes(st.st), st.pos, st.pos_begin, st.cur_flags, msgs, pks, rs)
    bt = merlin.BatchTranscript(n, prefix, native=False)
    bt.append_message_batch(b"sign-bytes", msgs)
    bt.append_message_shared(b"proto-name", b"Schnorr-sig")
    bt.append_message_batch(b"sign:pk", pks)
    bt.append_message_batch(b"sign:R", rs)
    return (tn.sr25519_batch_challenges(*args),
            jn.sr25519_batch_challenges(*args),
            bt.challenge_bytes_batch(b"sign:c", 64))


ENTRIES = {
    "batch_sha512": _sha512,
    "ed25519_batch_digest": _batch_digest,
    "ed25519_batch_challenge": _batch_challenge,
    "batch_reduce_mod_l": _reduce,
    "ed25519_pack": _pack,
    "ed25519_pack_commits": _pack_commits,
    "batch_keccak_f1600": _keccak,
    "sr25519_batch_challenges": _sr_challenges,
}


# --------------------------------------------------------------------------
# each native entry against the JAX package's and the plain version
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 4, 45])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_matches_jax_native_and_plain(entry, n):
    port, jax_native, plain = ENTRIES[entry](np.random.default_rng(n), n)
    _same(port, jax_native)
    _same(port, plain)


def test_reduce_mod_l_edges():
    got = tn.batch_reduce_mod_l(_digests(np.random.default_rng(0), 4))
    want = [0, L - 1, 0, (2**512 - 1) % L]
    assert [int.from_bytes(bytes(r), "little") for r in got] == want


@pytest.mark.parametrize("ln", [0, 1, 165, 166, 167, 400])
def test_sr25519_challenges_at_every_rate_edge(ln):
    """Message lengths around the STROBE rate (166 bytes), and none."""
    port, jax_native, plain = _sr_challenges(np.random.default_rng(ln), 5, ln)
    _same(port, jax_native)
    _same(port, plain)


def test_pack_commits_every_timestamp_width_and_both_templates():
    """Every TIMESTAMPS row under each template: the native sign-bytes
    equal the plain VoteRowTemplate.patch_rows bytes (through the
    digest)."""
    rng = np.random.default_rng(7)
    tpls = _templates()
    n = len(TIMESTAMPS)
    pubs, sigs = _keys_sigs(rng, n)
    secs = np.asarray([s for s, _ in TIMESTAMPS], np.int64)
    nanos = np.asarray([t for _, t in TIMESTAMPS], np.int64)
    for w, tpl in enumerate(tpls):
        got = tn.ed25519_pack_commits(
            b"".join(pubs), b"".join(sigs), [t.template for t in tpls],
            np.full(n, w, np.int32), secs, nanos, n)
        msgs = tpl.patch_rows(secs, nanos).tolist()
        _same(got, _plain_pack(ek.pack_batch(pubs, msgs, sigs, pad_to=n,
                                             native=False)))


# --------------------------------------------------------------------------
# the packers: native (default) == plain == the JAX package
# --------------------------------------------------------------------------


def _rows(rng, n, bad=()):
    pubs, sigs = _keys_sigs(rng, n)
    msgs = _msgs(rng, n)
    for i in bad:
        if i % 2:
            pubs[i] = pubs[i][:31]
        else:
            sigs[i] = sigs[i][:63]
    return pubs, msgs, sigs


@pytest.mark.parametrize("n,bad", [(0, ()), (1, ()), (70, ()),
                                   (70, (3, 40)), (5, (0, 1, 2, 3, 4))])
def test_pack_batch_native_equals_plain_and_jax(n, bad):
    pubs, msgs, sigs = _rows(np.random.default_rng(n + len(bad)), n, bad)
    got = ek.pack_batch(pubs, msgs, sigs)
    _same(tuple(got), tuple(ek.pack_batch(pubs, msgs, sigs, native=False)))
    _same(tuple(got), tuple(jek.pack_batch(pubs, msgs, sigs)))
    assert got.precheck.dtype == np.bool_


def _sr_rows(rng):
    """sr25519 rows in groups of several message lengths, one empty, with
    a short key, a short signature and a missing marker bit."""
    pubs, msgs, sigs = [], [], []
    for i in range(40):
        ln = (0, 150, 151, 159, 300)[i % 5]
        pubs.append(rng.bytes(32))
        msgs.append(rng.bytes(ln))
        s = bytearray(rng.bytes(64))
        s[63] |= 0x80
        s[0] &= 0xFE
        sigs.append(bytes(s))
    pk, (s,) = sr.sign_many(rng.bytes(32), [b"a signed row"])
    pubs[5], msgs[5], sigs[5] = pk, b"a signed row", s
    pubs[7] = pubs[7][:31]
    sigs[9] = sigs[9][:63]
    sigs[11] = sigs[11][:63] + bytes([sigs[11][63] & 0x7F])
    return pubs, msgs, sigs


def test_pack_batch_sr_native_equals_plain_and_jax():
    pubs, msgs, sigs = _sr_rows(np.random.default_rng(8))
    got = srk.pack_batch_sr(pubs, msgs, sigs)
    _same(got, srk.pack_batch_sr(pubs, msgs, sigs, native=False))
    # the JAX pack raises on the short key (ROADMAP C, recorded); its
    # other rows are the port's
    keep = [i for i in range(len(pubs)) if i != 7]
    sub = [[x[i] for i in keep] for x in (pubs, msgs, sigs)]
    _same(srk.pack_batch_sr(*sub), jsrk.pack_batch_sr(*sub))
    # the signed row passes the precheck; the three malformed rows fail it
    prechecked = (got[kf.C_FLAGS] >> 2) & 1
    assert prechecked[[5, 7, 9, 11]].tolist() == [1, 0, 0, 0]


def test_batch_challenges_native_equals_plain():
    rng = np.random.default_rng(9)
    msgs = [rng.bytes((0, 12, 200)[i % 3]) for i in range(12)]
    pubs = [rng.bytes(32) for _ in msgs]
    rs = [rng.bytes(32) for _ in msgs]
    _same(srk.batch_challenges(msgs, pubs, rs),
          srk.batch_challenges(msgs, pubs, rs, native=False))


def test_batch_strobe_native_equals_numpy():
    prefix = sr._signing_prefix()
    out = []
    for native in (True, False):
        bt = merlin.BatchTranscript(6, prefix, native)
        for ln in (0, 100, 166, 333):
            bt.append_message_batch(b"m", np.frombuffer(
                np.random.default_rng(ln).bytes(6 * ln),
                np.uint8).reshape(6, ln))
        out.append(bt.challenge_bytes_batch(b"c", 400))
    _same(out[0], out[1])


# --------------------------------------------------------------------------
# the slice on the CPU
# --------------------------------------------------------------------------


class Commit:
    """One signed commit built from each package's types. nil: slots that
    voted nil; absent: slots that did not vote; ts: {slot: (secs, nanos)}
    overrides of the seeded timestamps; tamper: a slot whose signature is
    flipped."""

    def __init__(self, rng, vals, height, nil=(), absent=(), ts=None,
                 tamper=None):
        bh, ph = rng.bytes(32), rng.bytes(32)
        self.tbid = tbid.BlockID(bh, tbid.PartSetHeader(1, ph))
        self.jbid = jbid.BlockID(bh, jbid.PartSetHeader(1, ph))
        t_sigs, j_sigs = [], []
        for i, v in enumerate(vals.t.validators):
            if i in absent:
                t_sigs.append(tcommit.CommitSig())
                j_sigs.append(jcommit.CommitSig())
                continue
            flag = (tcommit.BLOCK_ID_FLAG_NIL if i in nil
                    else tcommit.BLOCK_ID_FLAG_COMMIT)
            t = (ts or {}).get(i, (1_700_000_000 + height,
                                   int(rng.integers(0, 10**9))))
            t_sigs.append(tcommit.CommitSig(flag, v.address,
                                            tts.Timestamp(*t)))
            j_sigs.append(jcommit.CommitSig(flag, v.address,
                                            jts.Timestamp(*t)))
        self.height = height
        self.t = tcommit.Commit(height, 0, self.tbid, t_sigs)
        self.j = jcommit.Commit(height, 0, self.jbid, j_sigs)
        msgs = self.t.sign_bytes_rows(CHAIN)
        for i, (a, b) in enumerate(zip(t_sigs, j_sigs)):
            if i in absent:
                continue
            sig = ed.sign(vals.seed_of[a.validator_address], msgs[i])
            if i == tamper:
                sig = sig[:40] + bytes([sig[40] ^ 2]) + sig[41:]
            a.signature = b.signature = sig


class Vals:
    """One validator set from each package's types; distinct powers keep
    the slots in key order."""

    def __init__(self, rng, n):
        seeds = [rng.bytes(32) for _ in range(n)]
        pubs = [ed.sign_many(s, [])[0] for s in seeds]
        powers = [1000 - i for i in range(n)]
        self.pubs = pubs
        self.t = tval.ValidatorSet([tval.Validator(tkeys.PubKey(p), w)
                                    for p, w in zip(pubs, powers)])
        self.j = jval.ValidatorSet([jval.Validator(jkeys.PubKey(p), w)
                                    for p, w in zip(pubs, powers)])
        self.seed_of = {tkeys.PubKey(p).address(): s
                        for p, s in zip(pubs, seeds)}


def _outcome(fn):
    try:
        fn()
        return ("ok",)
    except (tv.InvalidSignatureError, jv.InvalidSignatureError) as e:
        return ("InvalidSignatureError", e.idx)
    except (tv.VerificationError, jv.VerificationError) as e:
        return (type(e).__name__,)


@pytest.fixture(scope="module")
def v64():
    return Vals(np.random.default_rng(64), 64)


@pytest.mark.parametrize("tamper", [None, 0, 37])
def test_verify_commit_64_validators_matches_jax(v64, tamper):
    rng = np.random.default_rng(100 + (tamper or 0))
    c = Commit(rng, v64, 12, nil=(5, 50), absent=(9,), tamper=tamper,
               ts={1: (0, 0), 2: (-5, 999_999_999)})
    got = _outcome(lambda: tv.verify_commit(
        CHAIN, v64.t, c.tbid, c.height, c.t, tv.device_batch_fn("cpu")))
    want = _outcome(lambda: jv.verify_commit(
        CHAIN, v64.j, c.jbid, c.height, c.j, jv.oracle_batch_fn()))
    assert got == want
    assert got == (("ok",) if tamper is None
                   else ("InvalidSignatureError", tamper))


@pytest.mark.parametrize("pad_to", [None, 80])
def test_commit_packed_batch_matches_jax_and_plain(v64, pad_to):
    rng = np.random.default_rng(11)
    c = Commit(rng, v64, 13, nil=(3, 4, 60), absent=(0, 63),
               ts={i: TIMESTAMPS[i % len(TIMESTAMPS)] for i in range(20)})
    every = [i for i, cs in enumerate(c.t.signatures) if not cs.is_absent()]
    for idxs in (None, every):
        pb, got_idxs = tv.commit_packed_batch(CHAIN, c.t, v64.pubs, idxs,
                                              pad_to)
        jpb, jidxs = jv.commit_packed_batch(CHAIN, c.j, v64.pubs, idxs,
                                            pad_to)
        plain, _ = tv.commit_packed_batch(CHAIN, c.t, v64.pubs, idxs, pad_to,
                                          native=False)
        assert got_idxs == jidxs
        _same(tuple(pb), tuple(jpb))
        _same(tuple(pb), tuple(plain))
    # a nil row's sign-bytes are the nil template's: its row verifies
    valid = kf.verify_rows(kf.pack_rows(pb), "cpu").numpy()[:len(every)]
    assert valid.all()


def _capture(monkeypatch):
    """Record (copies of) the packed rows of every general chunk (packed
    on the host, or stamped on the device) and every host-packed cached
    chunk the port's pipeline dispatches."""
    seen = {"general": [], "cached": []}
    real_g, real_c = kf.verify_tally_rows, ec.verify_tally_rows_cached
    real_s = es.stamp_rows_general

    def general(rows, n_commits, device=None):
        seen["general"].append(np.array(rows))
        return real_g(rows, n_commits, device)

    def stamped(*args):
        rows = real_s(*args)
        seen["general"].append(rows.cpu().numpy())
        return rows

    def cached(rows, table, n_commits):
        seen["cached"].append(np.array(rows))
        return real_c(rows, table, n_commits)

    monkeypatch.setattr(kf, "verify_tally_rows", general)
    monkeypatch.setattr(ec, "verify_tally_rows_cached", cached)
    monkeypatch.setattr(es, "stamp_rows_general", stamped)
    return seen


def test_stream_host_packs_native_equal_plain_and_jax(monkeypatch):
    """Two valsets of 16: cached chunks that must host-pack (a nanos
    outside int32, among zero, negative and 10-byte timestamps) and a
    general chunk (both valsets) that is stamped on the device (zero,
    negative and 10-byte timestamps, nanos at the int32 edges). The native
    chunks' rows equal the plain ones; the outcomes equal the JAX
    StreamVerifier's, whose device step runs the port's plain verify and
    tally on the JAX package's packed rows, which equal the port's host
    packs and its stamped general rows."""
    rng = np.random.default_rng(12)
    va, vb = Vals(rng, 16), Vals(rng, 16)
    wide = {0: (2**63 - 1, 2**31), 1: (0, 0), 2: (-1, -1), 3: (0, 999_999_999)}
    edge = {0: (2**63 - 1, 2**31 - 1), 1: (0, 0), 2: (-1, -2**31),
            3: (0, 999_999_999)}
    commits = [(va, Commit(rng, va, 20, ts=wide)),
               (va, Commit(rng, va, 21, tamper=2, ts={0: (5, 2**31)})),
               (va, Commit(rng, va, 22, absent=range(4, 16))),
               (va, Commit(rng, va, 23, ts=wide)),
               (va, Commit(rng, va, 24)), (vb, Commit(rng, vb, 25, tamper=6)),
               (va, Commit(rng, va, 26, ts=edge)),
               (vb, Commit(rng, vb, 27, absent=range(3)))]
    t_jobs = [bp.CommitJob(v.t, c.tbid, c.height, c.t, CHAIN)
              for v, c in commits]
    seen = _capture(monkeypatch)
    outcomes, rows = [], []
    for native in (True, False):
        sv = bp.StreamVerifier(max_sigs=4 * 16, device="cpu",
                               min_device_sigs=1, native=native)
        outcomes.append([_outcome(lambda e=e: _raise(e))
                         for e in sv.verify(t_jobs)])
        # a 16-validator table has M = 128 columns a commit, so the first
        # four commits are four cached chunks: the three with a wide
        # timestamp host-pack, the other stamps
        assert sv.stats["host_packed_cached_chunks"] == 3
        assert sv.stats["stamped_chunks"] == 1
        assert sv.stats["general_chunks"] == 1
        assert sv.stats["general_stamped_chunks"] == 1
        rows.append({k: list(v) for k, v in seen.items()})
        for v in seen.values():
            v.clear()
    assert len(rows[0]["cached"]) == len(rows[1]["cached"]) == 3
    assert len(rows[0]["general"]) == len(rows[1]["general"]) == 1
    for kind in ("general", "cached"):
        for got, want in zip(rows[0][kind], rows[1][kind]):
            _same(got, want)

    jpacked = []

    def dispatch(pb, power5, counted, commit_ids, thresh, n_commits):
        jpacked.append(pb)
        out = kf.verify_tally_rows(
            kf.pack_rows(pb, power5, counted, commit_ids, thresh),
            thresh.shape[0], "cpu")
        return tuple(t.numpy() for t in out)

    jsv = jp.StreamVerifier(max_sigs=4 * 16, use_pallas=False,
                            min_device_sigs=1)
    monkeypatch.setattr(jsv, "_dispatch", dispatch)
    j_jobs = [jp.CommitJob(v.j, c.jbid, c.height, c.j, CHAIN)
              for v, c in commits]
    want = [_outcome(lambda e=e: _raise(e)) for e in jsv.verify(j_jobs)]
    assert outcomes[0] == outcomes[1] == want
    assert want[:2] == [("ok",), ("InvalidSignatureError", 2)]
    assert want[2] == ("NotEnoughPowerError",)
    assert want[5] == ("InvalidSignatureError", 6)
    # the JAX package packs both chunks on the general path: its second
    # chunk's signature rows are the port's stamped general chunk's (the
    # two pad to different widths)
    n = jpacked[1].n
    want_rows = kf.pack_rows(jpacked[1])
    got_rows = rows[0]["general"][0]
    _same(got_rows[:kf.C_FLAGS, :n], want_rows[:kf.C_FLAGS, :n])
    _same(got_rows[kf.C_FLAGS, :n] & 7, want_rows[kf.C_FLAGS, :n] & 7)


def _raise(err):
    if err is not None:
        raise err


def test_stamped_general_rows_equal_pack_rows_of_the_host_pack(monkeypatch):
    """A general chunk of two valsets of different sizes (16 and 24) with
    zero, negative and 10-byte timestamps, nanos at the int32 edges,
    absent, nil and tampered rows and a signature whose S is L: the rows
    stamped on the device equal kf.pack_rows of the native host pack of
    the same chunk byte for byte, in every column and row (the padding
    and the threshold rows included), and the outcomes equal the JAX
    package's VerifyCommitLight with the oracle."""
    rng = np.random.default_rng(27)
    va, vb = Vals(rng, 16), Vals(rng, 24)
    edge = dict(enumerate(TIMESTAMPS + [(1, 2**31 - 1)]))
    commits = [(va, Commit(rng, va, 40, ts=edge)),
               (vb, Commit(rng, vb, 41, ts=edge, tamper=13, absent=(2, 3),
                           nil=(20,))),
               (va, Commit(rng, va, 42, absent=range(6, 16))),
               (vb, Commit(rng, vb, 43))]
    for cs in (commits[0][1].t.signatures[3], commits[0][1].j.signatures[3]):
        cs.signature = cs.signature[:32] + L.to_bytes(32, "little")
    jobs = [bp.CommitJob(v.t, c.tbid, c.height, c.t, CHAIN)
            for v, c in commits]
    want = [_outcome(lambda v=v, c=c: jv.verify_commit_light(
        CHAIN, v.j, c.jbid, c.height, c.j, jv.oracle_batch_fn()))
        for v, c in commits]
    assert want == [("InvalidSignatureError", 3),
                    ("InvalidSignatureError", 13),
                    ("NotEnoughPowerError",), ("ok",)]
    seen = _capture(monkeypatch)
    outcomes = []
    for stamp in (True, False):
        if not stamp:
            monkeypatch.setattr(bp.StreamVerifier, "_stamp_general",
                                lambda *a: None)
        sv = bp.StreamVerifier(max_sigs=80, device="cpu", min_device_sigs=1)
        outcomes.append([_outcome(lambda e=e: _raise(e))
                         for e in sv.verify(jobs)])
        assert sv.stats["general_chunks"] == 1
        assert sv.stats["general_stamped_chunks"] == int(stamp)
    assert outcomes[0] == outcomes[1] == want
    stamped, packed = seen["general"]
    assert stamped.dtype == packed.dtype == np.int32
    assert stamped.shape == packed.shape == (kf.C_THRESH + 2, 256)
    assert stamped.tobytes() == packed.tobytes()
    # what the chunk claims to cover: keys and R with the top bit set,
    # an S >= L row, padding columns in the sink commit
    n = 16 + 21 + 6 + 24
    flags = stamped[kf.C_FLAGS, :n]
    assert (flags & 1).any() and (flags & 2).any()
    assert ((flags & 4) == 0).sum() == 1
    assert (stamped[kf.C_CID, n:] == bp.MAX_COMMITS_PER_CHUNK).all()


# --------------------------------------------------------------------------
# no silent fallback
# --------------------------------------------------------------------------


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory and library cache."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})


def test_missing_compiler_raises_build_error(fresh_build, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    assert not tn.available()
    with pytest.raises(_build.BuildError, match="no C.. compiler"):
        tn.batch_sha512([b""])
    pubs, msgs, sigs = _rows(np.random.default_rng(1), 3)
    # every packer goes through the library by default
    with pytest.raises(_build.BuildError):
        ek.pack_batch(pubs, msgs, sigs)
    with pytest.raises(_build.BuildError):
        srk.pack_batch_sr(pubs, msgs, sigs)
    with pytest.raises(_build.BuildError):
        merlin.BatchTranscript(2, sr._signing_prefix()).challenge_bytes_batch(
            b"c", 200)
    # the plain versions ask for no library
    assert ek.pack_batch(pubs, msgs, sigs, native=False).n == 3
    assert srk.pack_batch_sr(pubs, msgs, sigs, native=False).shape[1] >= 3


def test_missing_compiler_stops_the_commit_packs(v64, fresh_build,
                                                 monkeypatch):
    # a nanos word past int32: the stream's chunk packs on the host
    c = Commit(np.random.default_rng(13), v64, 14, ts={0: (5, 2**31)})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(_build.BuildError):
        tv.commit_packed_batch(CHAIN, c.t, v64.pubs)
    job = bp.CommitJob(v64.t, c.tbid, c.height, c.t, CHAIN)
    with pytest.raises(_build.BuildError):
        bp.StreamVerifier(device="cpu")._pack_chunk([(0, job)])
    assert tv.commit_packed_batch(CHAIN, c.t, v64.pubs,
                                  native=False)[0].n == 64


def test_failed_build_raises_build_error(fresh_build, monkeypatch):
    monkeypatch.setattr(_build, "NATIVE_FLAGS",
                        _build.NATIVE_FLAGS + ("-DHOSTACCEL_BROKEN=(",
                                               "-include", "nonexistent.h"))
    with pytest.raises(_build.BuildError, match="build failed"):
        tn.batch_keccak_f1600(np.zeros((1, 25), np.uint64))
    assert not any((_build.BUILD_DIR).glob("hostaccel-*.so"))
