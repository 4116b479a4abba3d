"""The port's host types (its own copies) against the JAX package's: the
same seeded commits give byte-identical sign-bytes, and the same validators
give the same total power, order and hash."""
import numpy as np
import pytest

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.types import block_id as jbid
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validator as jval
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.types import block_id as tbid
from cometbft_tpu_torch.types import canonical as tcanon
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import validator as tval

# varint width boundaries of the timestamp fields (and zero-skipping)
SECS = [0, 1, 127, 128, 2**14 - 1, 2**14, 2**21, 2**28, 2**31 - 1, 2**31,
        2**35, 2**56, 2**63 - 1, -1, -(2**31), jts.GO_ZERO_SECONDS,
        1_700_000_000]
NANOS = [0, 1, 127, 128, 2**14 - 1, 2**14, 2**21 - 1, 2**21, 999_999_999]


def _pair(rng, n, flags):
    """The same random commit built from both packages' types."""
    bh, ph = rng.bytes(32), rng.bytes(32)
    total = int(rng.integers(1, 5))
    height, round_ = int(rng.integers(1, 2**40)), int(rng.integers(0, 5))
    sigs_j, sigs_t = [], []
    for i in range(n):
        flag = int(flags[i])
        ts = (int(rng.choice(SECS)), int(rng.choice(NANOS)))
        addr, sig = rng.bytes(20), rng.bytes(64)
        if flag == jcommit.BLOCK_ID_FLAG_ABSENT:
            sigs_j.append(jcommit.CommitSig())
            sigs_t.append(tcommit.CommitSig())
            continue
        sigs_j.append(jcommit.CommitSig(flag, addr, jts.Timestamp(*ts), sig))
        sigs_t.append(tcommit.CommitSig(flag, addr, tts.Timestamp(*ts), sig))
    cj = jcommit.Commit(height, round_, jbid.BlockID(
        bh, jbid.PartSetHeader(total, ph)), sigs_j)
    ct = tcommit.Commit(height, round_, tbid.BlockID(
        bh, tbid.PartSetHeader(total, ph)), sigs_t)
    return cj, ct


@pytest.mark.parametrize("seed", range(6))
def test_commit_sign_bytes_match_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 40))
    flags = rng.choice([jcommit.BLOCK_ID_FLAG_COMMIT] * 3
                       + [jcommit.BLOCK_ID_FLAG_NIL,
                          jcommit.BLOCK_ID_FLAG_ABSENT], n)
    cj, ct = _pair(rng, n, flags)
    chain = f"chain-{seed}" * (1 + seed % 3)
    for i in range(n):
        assert ct.vote_sign_bytes(chain, i) == cj.vote_sign_bytes(chain, i)
    assert ct.sign_bytes_rows(chain) == cj.sign_bytes_rows(chain)
    idxs = sorted(rng.choice(n, n // 2, replace=False).tolist())
    assert ct.sign_bytes_rows(chain, idxs) == cj.sign_bytes_rows(chain, idxs)
    assert ct.hash() == cj.hash()


def test_sign_bytes_at_every_timestamp_width():
    bid_t = tbid.BlockID(b"\x07" * 32, tbid.PartSetHeader(3, b"\x09" * 32))
    bid_j = jbid.BlockID(b"\x07" * 32, jbid.PartSetHeader(3, b"\x09" * 32))
    secs = np.repeat(SECS, len(NANOS))
    nanos = np.tile(NANOS, len(SECS))
    for bt, bj in ((bid_t, bid_j), (None, None)):
        rt = tcanon.VoteRowTemplate("c", 2, 9, 1, bt).patch_rows(secs, nanos)
        rj = jcanon.VoteRowTemplate("c", 2, 9, 1, bj).patch_rows(secs, nanos)
        assert rt.tolist() == rj.tolist()
        for s, n, row in zip(secs.tolist(), nanos.tolist(), rt.tolist()):
            assert row == jcanon.canonical_vote_bytes(
                "c", 2, 9, 1, bj, jts.Timestamp(s, n))


@pytest.mark.parametrize("seed", range(4))
def test_validator_set_power_order_and_hash(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 60))
    pubs = [rng.bytes(32) for _ in range(n)]
    powers = rng.integers(1, 2**40, n).tolist()
    if seed == 0:
        powers = [7] * n  # all ties: address order decides
    vj = jval.ValidatorSet([jval.Validator(jkeys.PubKey(p), w)
                            for p, w in zip(pubs, powers)])
    vt = tval.ValidatorSet([tval.Validator(tkeys.PubKey(p), w)
                            for p, w in zip(pubs, powers)])
    assert vt.total_voting_power() == vj.total_voting_power()
    assert vt.hash() == vj.hash()
    assert [v.address for v in vt.validators] == [
        v.address for v in vj.validators]
    assert vt.get_proposer().address == vj.get_proposer().address
    assert tval.MAX_TOTAL_VOTING_POWER == jval.MAX_TOTAL_VOTING_POWER


def test_total_power_cap_is_enforced_like_the_jax_package():
    big = tval.MAX_TOTAL_VOTING_POWER // 2 + 1
    pubs = [b"\x01" * 32, b"\x02" * 32]
    with pytest.raises(tval.ValidatorSetError):
        tval.ValidatorSet([tval.Validator(tkeys.PubKey(p), big)
                           for p in pubs])
    with pytest.raises(jval.ValidatorSetError):
        jval.ValidatorSet([jval.Validator(jkeys.PubKey(p), big)
                           for p in pubs])
