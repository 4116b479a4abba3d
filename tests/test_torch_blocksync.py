"""The port's blocksync StreamVerifier on the host (device="cpu", the plain
versions of the kernels) against the JAX package's VerifyCommitLight with
the oracle, on the same seeded commits: every commit's outcome (success, or
the exception type and blamed index) agrees. The scenarios reach both chunk
branches: cached chunks (device stamping, and the host pack for a
timestamp outside the staged words), a mixed-valset chunk (general
kernels), and a churned valset (the near-miss table update)."""
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.types import block_id as jbid
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validation as jv
from cometbft_tpu.types import validator as jval
from cometbft_tpu_torch.blocksync import pipeline as bp
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.device import DeviceError
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.types import block_id as tbid
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import validation as tv
from cometbft_tpu_torch.types import validator as tval

CHAIN = "sync-chain"
N_VALS = 16

torch.set_num_threads(1)


class Valset:
    """One validator set built from each package's types."""

    def __init__(self, seeds, powers):
        self.seeds = seeds
        pubs = [ed.sign_many(s, [])[0] for s in seeds]
        self.t = tval.ValidatorSet([tval.Validator(tkeys.PubKey(p), w)
                                    for p, w in zip(pubs, powers)])
        self.j = jval.ValidatorSet([jval.Validator(jkeys.PubKey(p), w)
                                    for p, w in zip(pubs, powers)])
        self.seed_of = {tkeys.PubKey(p).address(): s
                        for p, s in zip(pubs, seeds)}


def make_valset(rng, n=N_VALS, rotate=None, base=None):
    """Distinct powers keep the power order, so rotating a key keeps its
    slot (a near-miss of the base set)."""
    seeds = list(base.seeds) if base else [rng.bytes(32) for _ in range(n)]
    for i in rotate or ():
        seeds[i] = rng.bytes(32)
    return Valset(seeds, [1000 - 10 * i for i in range(n)])


def make_job(rng, vs, height, tamper=None, absent=(), nanos=None):
    """(port CommitJob, JAX arguments) of one signed commit; validator
    slot i is the i-th of the power-sorted set. nanos: {slot: nanos}
    overrides of the random timestamps."""
    bh, ph = rng.bytes(32), rng.bytes(32)
    t_bid = tbid.BlockID(bh, tbid.PartSetHeader(1, ph))
    j_bid = jbid.BlockID(bh, jbid.PartSetHeader(1, ph))
    ts_, js = [], []
    for i, v in enumerate(vs.t.validators):
        if i in absent:
            ts_.append(tcommit.CommitSig())
            js.append(jcommit.CommitSig())
            continue
        t = (1_700_000_000 + height, int(rng.integers(0, 10**9)))
        if nanos and i in nanos:
            t = (t[0], nanos[i])
        ts_.append(tcommit.CommitSig(tcommit.BLOCK_ID_FLAG_COMMIT, v.address,
                                     tts.Timestamp(*t)))
        js.append(jcommit.CommitSig(jcommit.BLOCK_ID_FLAG_COMMIT, v.address,
                                    jts.Timestamp(*t)))
    tc_ = tcommit.Commit(height, 0, t_bid, ts_)
    jc_ = jcommit.Commit(height, 0, j_bid, js)
    msgs = tc_.sign_bytes_rows(CHAIN)
    for i, (a, b) in enumerate(zip(ts_, js)):
        if i in absent:
            continue
        sig = ed.sign(vs.seed_of[a.validator_address], msgs[i])
        if i == tamper:
            sig = sig[:40] + bytes([sig[40] ^ 2]) + sig[41:]
        a.signature = b.signature = sig
    return (bp.CommitJob(vs.t, t_bid, height, tc_, CHAIN),
            (CHAIN, vs.j, j_bid, height, jc_))


def outcome(err):
    if err is None:
        return ("ok",)
    if isinstance(err, (tv.InvalidSignatureError, jv.InvalidSignatureError)):
        return ("InvalidSignatureError", err.idx)
    return (type(err).__name__,)


def jax_outcome(args):
    try:
        jv.verify_commit_light(*args, jv.oracle_batch_fn())
        return ("ok",)
    except jv.VerificationError as e:
        return outcome(e)


def run(pairs, min_device_sigs=1):
    """The stream's outcomes, held equal to JAX's; a tampered signature
    must lie before the light quorum's early break (index 10 here), where
    VerifyCommitLight still checks it."""
    sv = bp.StreamVerifier(max_sigs=4 * 128, device="cpu",
                           min_device_sigs=min_device_sigs)
    faults = tbatch.device_breaker().faults
    got = [outcome(r) for r in sv.verify([p[0] for p in pairs])]
    assert got == [jax_outcome(p[1]) for p in pairs]
    assert tbatch.device_breaker().faults == faults
    return got, sv


@pytest.fixture(scope="module")
def v0():
    return make_valset(np.random.default_rng(31))


def test_cached_chunks_stamped_on_the_device_agree_with_jax(v0):
    rng = np.random.default_rng(32)
    pairs = [make_job(rng, v0, 10), make_job(rng, v0, 11, tamper=3),
             make_job(rng, v0, 12, absent=range(0, 8)),
             make_job(rng, v0, 13), make_job(rng, v0, 14, tamper=8),
             make_job(rng, v0, 15)]
    got, sv = run(pairs)
    assert got == [("ok",), ("InvalidSignatureError", 3),
                   ("NotEnoughPowerError",), ("ok",),
                   ("InvalidSignatureError", 8), ("ok",)]
    # 6 commits at 4 per cached chunk (M = 128): two stamped chunks
    assert sv.stats["stamped_chunks"] == 2
    assert sv.stats["general_chunks"] == 0
    assert sv.stats["host_packed_cached_chunks"] == 0


def test_cached_chunk_host_packed_agrees_with_jax(v0):
    """A nanos word outside int32 cannot be staged as a delta: the cached
    chunk packs on the host, and its signed bytes still verify."""
    rng = np.random.default_rng(33)
    pairs = [make_job(rng, v0, 20, nanos={4: 2**31}),
             make_job(rng, v0, 21, tamper=0),
             make_job(rng, v0, 22, absent=range(5, 16))]
    got, sv = run(pairs)
    assert got[:2] == [("ok",), ("InvalidSignatureError", 0)]
    assert sv.stats["host_packed_cached_chunks"] == 1
    assert sv.stats["stamped_chunks"] == 0


def test_mixed_valset_chunk_takes_the_general_kernels(v0):
    rng = np.random.default_rng(34)
    v2 = make_valset(rng)
    pairs = [make_job(rng, v0, 30), make_job(rng, v2, 31, tamper=7),
             make_job(rng, v0, 32), make_job(rng, v2, 33, absent=range(6))]
    got, sv = run(pairs)
    assert got == [("ok",), ("InvalidSignatureError", 7), ("ok",),
                   ("NotEnoughPowerError",)]
    assert sv.stats["general_chunks"] == 1
    assert sv.stats["stamped_chunks"] == 0


def test_churned_valset_patches_the_cached_table(v0):
    rng = np.random.default_rng(35)
    # the base table is cached first, then a set with 2 rotated keys
    run([make_job(rng, v0, 40)])
    v1 = make_valset(rng, rotate=(2, 9), base=v0)
    p0 = ec.table_cache_stats()["incremental_patches"]
    pairs = [make_job(rng, v1, 41), make_job(rng, v1, 42, tamper=9)]
    got, sv = run(pairs)
    assert got == [("ok",), ("InvalidSignatureError", 9)]
    assert ec.table_cache_stats()["incremental_patches"] == p0 + 1
    assert sv.stats["stamped_chunks"] == 1


def test_small_streams_verify_on_the_host_loop(v0):
    rng = np.random.default_rng(36)
    pairs = [make_job(rng, v0, 50, tamper=1), make_job(rng, v0, 51)]
    got, sv = run(pairs, min_device_sigs=129)  # 32 rows
    assert got == [("InvalidSignatureError", 1), ("ok",)]
    assert sv.stats["host_ms"] == []


def test_make_stream_verifier_needs_a_card_or_the_cpu():
    sv = bp.make_stream_verifier(device="cpu", max_sigs=1024)
    assert sv.device == torch.device("cpu") and sv.max_sigs == 1024
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            bp.make_stream_verifier()


def test_verify_commit_with_the_cached_batch_fn_agrees_with_jax(
        monkeypatch):
    """device_batch_fn(cached=True) sends a whole-valset batch (>= 128
    rows) through the cached-valset kernel; the blamed index equals JAX's
    VerifyCommit with the oracle."""
    rng = np.random.default_rng(37)
    vs = make_valset(rng, n=130)
    job, jargs = make_job(rng, vs, 60, tamper=77)
    calls = []
    real = ec.verify_batch_cached
    monkeypatch.setattr(ec, "verify_batch_cached",
                        lambda *a, **k: calls.append(len(a[0])) or
                        real(*a, **k))
    fn = tv.device_batch_fn(device="cpu", cached=True)
    try:
        tv.verify_commit(CHAIN, job.vals, job.block_id, job.height,
                         job.commit, fn)
        got = ("ok",)
    except tv.VerificationError as e:
        got = outcome(e)
    try:
        jv.verify_commit(*jargs, jv.oracle_batch_fn())
        want = ("ok",)
    except jv.VerificationError as e:
        want = outcome(e)
    assert got == want == ("InvalidSignatureError", 77)
    assert calls == [130]
