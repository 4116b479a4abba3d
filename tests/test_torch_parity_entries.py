"""The JAX package's entry points that the port took on last, each held to
its JAX counterpart (or, where that is a jitted XLA kernel, to the
ed25519_ref oracle) on the same seeded inputs: crypto/batch.py's
supports_batch_verifier, batch_fn and CircuitBreaker.reset;
ops/ed25519_kernel.py's scalar_digits, verify_kernel, verify_tally_kernel
and verify_batch; ops/ecdsa_kernel.py's verify_batch; the stamping names
under ops/ed25519_cached.py; types/canonical.py's DeltaRows;
ristretto_ref.is_identity and sr25519_ref.keygen. The device rule holds
for each: device=None is the card (DeviceError here), "cpu" the plain
versions."""
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import ristretto_ref as jrist
from cometbft_tpu.crypto import sr25519_ref as jsr
from cometbft_tpu.ops import ed25519_kernel as jek
from cometbft_tpu.types import block_id as jbid
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.crypto import ristretto_ref as rist
from cometbft_tpu_torch.crypto import secp256k1_ref as secp
from cometbft_tpu_torch.crypto import sr25519_ref as sr
from cometbft_tpu_torch.device import DeviceError
from cometbft_tpu_torch.ops import ecdsa_kernel as eck
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import ed25519_stamp as es
from cometbft_tpu_torch.types import block_id as tbid
from cometbft_tpu_torch.types import canonical

# The plain versions run many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the host.
torch.set_num_threads(1)

KEY_TYPES = ["ed25519", "secp256k1", "sr25519", "bls12_381", "", "ED25519"]


def _ed_rows(n, seed=3, bad=()):
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n)]
    msgs = [rng.bytes(int(rng.integers(0, 120))) for _ in range(n)]
    pubs = [ed.pubkey_from_seed(s) for s in seeds]
    sigs = [ed.sign(s, m) for s, m in zip(seeds, msgs)]
    for i in bad:
        sigs[i] = sigs[i][:7] + bytes([sigs[i][7] ^ 4]) + sigs[i][8:]
    return pubs, msgs, sigs


@pytest.mark.parametrize("key_type", KEY_TYPES)
def test_supports_batch_verifier_matches_the_jax_package(key_type):
    assert tbatch.supports_batch_verifier(key_type) \
        == jbatch.supports_batch_verifier(key_type)


def test_batch_fn_keeps_the_device_rule():
    with pytest.raises(DeviceError):
        tbatch.batch_fn()
    pubs, msgs, sigs = _ed_rows(6, bad=(4,))
    keys = [tkeys.PubKey(p) for p in pubs]
    got = tbatch.batch_fn("cpu")(keys, msgs, sigs)
    assert got.tolist() == [ed.verify(p, m, s)
                            for p, m, s in zip(pubs, msgs, sigs)]
    assert got.tolist() == [True] * 4 + [False, True]


def _trip(brk, fail):
    """A fixed run of allow / record calls on either package's breaker."""
    out = []
    for f in fail:
        out.append(brk.allow())
        (brk.record_failure if f else brk.record_success)()
        out.append((brk.state, brk.trips, brk.closes, brk.probes))
    return out


def test_breaker_reset_matches_the_jax_package():
    seq = [1, 1, 0, 1, 1, 1]
    j = jbatch.CircuitBreaker(failure_threshold=2, cooldown=0.0)
    t = tbatch.CircuitBreaker(failure_threshold=2, cooldown=0.0)
    assert _trip(t, seq) == _trip(j, seq)
    assert t.state == j.state == "open"
    j.reset()
    t.reset()
    for b in (j, t):
        assert (b.state, b._failures, b._open_until) == ("closed", 0, 0.0)
    # the counters keep their totals in both packages
    assert (t.trips, t.closes, t.probes) == (j.trips, j.closes, j.probes)
    assert t.faults == sum(seq)
    # a fresh run of faults trips it again from zero
    assert _trip(t, [1, 1]) == _trip(j, [1, 1])


def test_a_faulted_dispatch_raises_device_error_and_counts():
    """crypto.device_dispatch fires before the kernel: the breaker counts
    the fault and the caller gets DeviceError (C1), where the JAX package
    verifies on the host."""
    from cometbft_tpu_torch.libs import failpoints as fp

    pubs, msgs, sigs = _ed_rows(3)
    keys = [tkeys.PubKey(p) for p in pubs]
    brk = tbatch.CircuitBreaker(failure_threshold=5)
    fp.arm("crypto.device_dispatch", "raise", count=1)
    try:
        with pytest.raises(DeviceError, match="FailpointError"):
            tbatch.verify_batch(keys, msgs, sigs, device="cpu", breaker=brk)
    finally:
        fp.disarm("crypto.device_dispatch")
    assert brk.faults == 1 and brk.state == "closed"
    assert tbatch.verify_batch(keys, msgs, sigs, device="cpu",
                               breaker=brk).all()


@pytest.mark.parametrize("v", [0, 1, 15, 16, ed.L - 1, 2**255 - 19,
                               2**256 - 1, 0x0123456789ABCDEF << 190])
def test_scalar_digits_matches_the_jax_package(v):
    got, want = ek.scalar_digits(v), jek.scalar_digits(v)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_verify_kernel_and_verify_tally_kernel_match_the_oracle():
    pubs, msgs, sigs = _ed_rows(10, seed=8, bad=(2, 7))
    oracle = [ed.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    pb = ek.pack_batch(pubs, msgs, sigs)
    fields = (pb.ay, pb.asign, pb.ry, pb.rsign, pb.sdig, pb.hdig,
              pb.precheck)
    with pytest.raises(DeviceError):
        ek.verify_kernel(*fields)
    valid = ek.verify_kernel(*fields, device="cpu")
    assert valid.dtype == torch.bool and valid.shape == (pb.padded,)
    assert valid[:10].tolist() == oracle and not valid[10:].any()
    assert ek.verify_batch(pubs, msgs, sigs, device="cpu").tolist() == oracle
    # two commits in one batch; powers near the 2^63 ceiling
    powers = np.array([2**60, 3, 5, 7, 11, 2**59, 13, 17, 19, 23], np.int64)
    power5 = np.zeros((pb.padded, ek.POWER_LIMBS), np.int32)
    power5[:10] = ek.power_limbs(powers)
    counted = np.zeros(pb.padded, np.bool_)
    counted[:10] = True
    counted[4] = False
    cids = np.zeros(pb.padded, np.int32)
    cids[5:10] = 1
    want = [sum(int(powers[i]) for i in range(c * 5, c * 5 + 5)
                if oracle[i] and counted[i]) for c in (0, 1)]
    thresh = np.concatenate([ek.threshold_limbs(want[0]),
                             ek.threshold_limbs(want[1] - 1)])
    v, tally, quorum = ek.verify_tally_kernel(
        *fields, torch.from_numpy(power5), counted, cids, thresh,
        n_commits=2, device="cpu")
    assert torch.equal(v, valid)
    assert [int(x) for x in ek.tally_to_int(tally.numpy())] == want
    assert quorum.tolist() == [False, True]


def test_ecdsa_verify_batch_matches_the_oracle():
    rng = np.random.default_rng(12)
    ds = [int(rng.integers(1, 2**62)) for _ in range(5)]
    msgs = [b"ecdsa-entry-%d" % i for i in range(5)]
    pubs = [secp.pubkey_from_secret(d) for d in ds]
    sigs = [secp.sign(d, m) for d, m in zip(ds, msgs)]
    sigs[3] = sigs[3][:40] + bytes([sigs[3][40] ^ 1]) + sigs[3][41:]
    with pytest.raises(DeviceError):
        eck.verify_batch(pubs, msgs, sigs)
    got = eck.verify_batch(pubs, msgs, sigs, device="cpu")
    assert got.tolist() == [secp.verify(p, m, s)
                            for p, m, s in zip(pubs, msgs, sigs)]
    assert got.tolist() == [True, True, True, False, True]


def test_stamping_names_under_ed25519_cached_are_the_stamp_module_s():
    for name in ec.STAMP_NAMES:
        assert getattr(ec, name) is getattr(es, name)
    from cometbft_tpu_torch.ops.ed25519_cached import template_entry

    assert template_entry is es.template_entry
    with pytest.raises(AttributeError):
        ec.no_such_name  # noqa: B018


SECS = [0, 1, -1, 127, 128, 2**31 - 1, 2**31, -(2**31), 2**32 + 5,
        2**62, -(2**62), 1_700_000_000]
NANOS = [0, 1, 999_999_999, 127, 128, 16_383, 16_384, 500_000_000, 2, 3,
         -5, 123_456_789]


@pytest.mark.parametrize("bid", ["nil", "block"])
def test_delta_rows_match_the_jax_package(bid):
    parts = (3, b"\x5a" * 32)
    tb = tbid.BlockID(b"\x11" * 32, tbid.PartSetHeader(*parts)) \
        if bid == "block" else None
    jb = jbid.BlockID(b"\x11" * 32, jbid.PartSetHeader(*parts)) \
        if bid == "block" else None
    t = canonical.VoteRowTemplate("delta-chain", canonical.PRECOMMIT_TYPE,
                                  99, 2, tb).delta_rows(SECS, NANOS)
    j = jcanon.VoteRowTemplate("delta-chain", jcanon.PRECOMMIT_TYPE,
                               99, 2, jb).delta_rows(SECS, NANOS)
    assert isinstance(t, canonical.DeltaRows) and len(t) == len(j)
    assert t.stampable() == j.stampable() is True
    assert t.nbytes == j.nbytes == 12 * len(SECS)
    assert np.array_equal(t.ts_words(), j.ts_words())
    assert t.expand().tolist() == j.expand().tolist()
    assert t.expand().tolist() == t.template.patch_rows(SECS,
                                                        NANOS).tolist()
    wide = canonical.VoteRowTemplate("c", 1, 1, 0, None).delta_rows(
        [1], [2**31])
    assert wide.stampable() is False


def test_is_identity_and_keygen_match_the_jax_package():
    seed = bytes(range(32))
    assert sr.keygen(seed) == jsr.keygen(seed)
    s, pk = sr.keygen()
    assert len(s) == 32 and pk == jsr.pubkey_from_seed(s)
    pt = rist.decode(sr.pubkey_from_seed(seed))
    for p in [(0, 1, 1, 0), pt, (0, ed.P - 1, 1, 0), (5, 0, 1, 7)]:
        assert rist.is_identity(p) == jrist.is_identity(p)
    assert rist.is_identity((0, 1, 1, 0)) and not rist.is_identity(pt)
