"""VerifyCommit family: the port with device_batch_fn(device="cpu") (the
plain PyTorch verify) against the JAX package with oracle_batch_fn, on the
same seeded commits. Outcomes must agree: success, or the same exception
type with the same blamed index / power figures."""
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.types import block_id as jbid
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validation as jv
from cometbft_tpu.types import validator as jval
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.types import block_id as tbid
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import validation as tv
from cometbft_tpu_torch.types import validator as tval

CHAIN = "port-chain"
HEIGHT = 77

# The plain versions run many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the host.
torch.set_num_threads(1)


class Pair:
    """One scenario built twice, from each package's types."""

    def __init__(self, seed, n_vals, powers=None, invalid=(), absent=(),
                 nil=(), trusted_subset=None):
        rng = np.random.default_rng(seed)
        seeds = [rng.bytes(32) for _ in range(n_vals)]
        pubs = [ed.sign_many(s, [])[0] for s in seeds]
        powers = powers or [100] * n_vals
        self.jvals = jval.ValidatorSet(
            [jval.Validator(jkeys.PubKey(p), w) for p, w in zip(pubs, powers)])
        self.tvals = tval.ValidatorSet(
            [tval.Validator(tkeys.PubKey(p), w) for p, w in zip(pubs, powers)])
        keep = trusted_subset or range(n_vals)
        self.jtrust = jval.ValidatorSet(
            [jval.Validator(jkeys.PubKey(pubs[i]), powers[i]) for i in keep])
        self.ttrust = tval.ValidatorSet(
            [tval.Validator(tkeys.PubKey(pubs[i]), powers[i]) for i in keep])
        seed_of = {tkeys.PubKey(p).address(): s for p, s in zip(pubs, seeds)}
        bh, ph = rng.bytes(32), rng.bytes(32)
        self.jbid = jbid.BlockID(bh, jbid.PartSetHeader(2, ph))
        self.tbid = tbid.BlockID(bh, tbid.PartSetHeader(2, ph))
        js, ts_ = [], []
        for idx, v in enumerate(self.tvals.validators):
            if idx in absent:
                js.append(jcommit.CommitSig())
                ts_.append(tcommit.CommitSig())
                continue
            flag = (jcommit.BLOCK_ID_FLAG_NIL if idx in nil
                    else jcommit.BLOCK_ID_FLAG_COMMIT)
            t = (1_700_000_000 + int(rng.integers(0, 2**20)),
                 int(rng.integers(0, 10**9)))
            js.append(jcommit.CommitSig(flag, v.address, jts.Timestamp(*t)))
            ts_.append(tcommit.CommitSig(flag, v.address, tts.Timestamp(*t)))
        self.jc = jcommit.Commit(HEIGHT, 1, self.jbid, js)
        self.tc = tcommit.Commit(HEIGHT, 1, self.tbid, ts_)
        for idx, (a, b) in enumerate(zip(js, ts_)):
            if a.is_absent():
                continue
            msg = self.tc.vote_sign_bytes(CHAIN, idx)
            _, (sig,) = ed.sign_many(seed_of[b.validator_address], [msg])
            if idx in invalid:
                sig = sig[:40] + bytes([sig[40] ^ 8]) + sig[41:]
            a.signature = b.signature = sig


def outcome(fn, *args):
    try:
        fn(*args)
        return ("ok",)
    except (jv.InvalidSignatureError, tv.InvalidSignatureError) as e:
        return ("InvalidSignatureError", e.idx)
    except (jv.NotEnoughPowerError, tv.NotEnoughPowerError) as e:
        return ("NotEnoughPowerError", e.got, e.needed)
    except (jv.VerificationError, tv.VerificationError) as e:
        return ("VerificationError", str(e))


SCENARIOS = {
    "clean": dict(seed=1, n_vals=8),
    "tampered_early": dict(seed=2, n_vals=8, invalid=(1,)),
    "tampered_past_light_quorum": dict(seed=3, n_vals=8, invalid=(7,)),
    "nil_and_absent": dict(seed=4, n_vals=10, nil=(2,), absent=(5,)),
    "tampered_nil": dict(seed=5, n_vals=10, nil=(3,), invalid=(3,)),
    "short_of_power": dict(seed=6, n_vals=8, absent=(0, 1, 2)),
    "weighted_16": dict(seed=7, n_vals=16, absent=(9,),
                        powers=[5000, 3000, 700, 600, 500, 400, 300, 200,
                                100, 90, 80, 70, 60, 50, 40, 30],
                        invalid=(12,), nil=(4,)),
}


@pytest.fixture(scope="module")
def pairs():
    return {k: Pair(**v) for k, v in SCENARIOS.items()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("which", ["verify_commit", "verify_commit_light"])
def test_same_outcome_as_the_jax_package(pairs, name, which):
    p = pairs[name]
    port_fn = tv.device_batch_fn(device="cpu")
    jax_out = outcome(getattr(jv, which), CHAIN, p.jvals, p.jbid, HEIGHT,
                      p.jc, jv.oracle_batch_fn())
    faults = tbatch.device_breaker().faults
    port_out = outcome(getattr(tv, which), CHAIN, p.tvals, p.tbid, HEIGHT,
                       p.tc, port_fn)
    assert port_out == jax_out
    assert tbatch.device_breaker().faults == faults  # no host fallback


@pytest.mark.parametrize("name,subset", [
    ("clean", None), ("tampered_early", None),
    ("weighted_16", [0, 1, 2, 3, 5, 8, 12, 15]),
])
def test_trusting_same_outcome_as_the_jax_package(name, subset):
    kw = dict(SCENARIOS[name], trusted_subset=subset)
    p = Pair(**kw)
    jax_out = outcome(jv.verify_commit_light_trusting, CHAIN, p.jtrust,
                      p.jc, (1, 3), jv.oracle_batch_fn())
    port_out = outcome(tv.verify_commit_light_trusting, CHAIN, p.ttrust,
                       p.tc, (1, 3), tv.device_batch_fn(device="cpu"))
    assert port_out == jax_out


def test_expected_outcomes_of_the_scenarios(pairs):
    """The matrix exercises every outcome, not only agreement."""
    got = {name: outcome(tv.verify_commit, CHAIN, p.tvals, p.tbid, HEIGHT,
                         p.tc, tv.oracle_batch_fn())[0]
           for name, p in pairs.items()}
    assert got == {
        "clean": "ok", "tampered_early": "InvalidSignatureError",
        "tampered_past_light_quorum": "InvalidSignatureError",
        "nil_and_absent": "ok", "tampered_nil": "InvalidSignatureError",
        "short_of_power": "NotEnoughPowerError",
        "weighted_16": "InvalidSignatureError",
    }
    p = pairs["tampered_past_light_quorum"]
    assert outcome(tv.verify_commit_light, CHAIN, p.tvals, p.tbid, HEIGHT,
                   p.tc, tv.oracle_batch_fn()) == ("ok",)


def _broken_kernel(pubs, msgs, sigs, device=None):
    raise RuntimeError("device lost")


def _batch(p):
    pubs = [v.pub_key for v in p.tvals.validators]
    msgs = p.tc.sign_bytes_rows(CHAIN)
    sigs = [cs.signature for cs in p.tc.signatures]
    return pubs, msgs, sigs


def test_breaker_raises_a_device_fault_and_trips_it(monkeypatch):
    """No host fallback hides a device fault: it is counted, trips the
    breaker and reaches the caller; only device="cpu" runs on the host."""
    p = Pair(seed=8, n_vals=4, invalid=(2,))
    brk = tbatch.CircuitBreaker(failure_threshold=1, cooldown=60)
    pubs, msgs, sigs = _batch(p)
    valid = tbatch.verify_batch(pubs, msgs, sigs, device="cpu", breaker=brk)
    assert valid.tolist() == [True, True, False, True]
    assert brk.faults == 0
    monkeypatch.setattr(tbatch, "_kernel_for", lambda kt: _broken_kernel)
    with pytest.raises(RuntimeError, match="device lost"):
        tbatch.verify_batch(pubs, msgs, sigs, device="cpu", breaker=brk)
    assert brk.faults == 1 and brk.trips == 1 and brk.state == "open"


def test_open_breaker_fails_fast_and_a_probe_closes_it(monkeypatch):
    p = Pair(seed=9, n_vals=4)
    brk = tbatch.CircuitBreaker(failure_threshold=1, cooldown=60)
    pubs, msgs, sigs = _batch(p)
    real = tbatch._kernel_for("ed25519")
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    brk.record_failure()
    assert brk.state == "open"
    monkeypatch.setattr(tbatch, "_kernel_for", lambda kt: counted)
    with pytest.raises(tbatch.DeviceError, match="open"):
        tbatch.verify_batch(pubs, msgs, sigs, device="cpu", breaker=brk)
    assert calls == []
    brk._open_until = 0.0  # the cooldown has passed: one probe goes through
    valid = tbatch.verify_batch(pubs, msgs, sigs, device="cpu", breaker=brk)
    assert valid.all() and calls == [1]
    assert brk.state == "closed" and brk.probes == 1 and brk.closes == 1


def test_device_batch_fn_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(tbatch.DeviceError):
        tv.device_batch_fn()
