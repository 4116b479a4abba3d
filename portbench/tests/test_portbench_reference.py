"""The reference: RFC 8032 vectors, OpenSSL, tampered rows, CometBFT's
sign-bytes vectors, and the verdict rules."""
import os

import pytest

from portbench import fixtures
from portbench.reference import canonical, ed25519, verdicts

# RFC 8032 section 7.1, tests 1-3: (secret key, public key, message,
# signature)
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.mark.parametrize("case", range(len(RFC8032)))
def test_rfc8032_vectors(case):
    sk, pk, msg, sig = (bytes.fromhex(x) for x in RFC8032[case])
    assert ed25519.public_key(sk) == pk
    assert ed25519.sign(sk, msg) == sig
    assert ed25519.verify(pk, msg, sig)


def test_openssl_signatures_verify_and_tampered_rows_do_not():
    """The fixtures sign with OpenSSL; every bit flipped in a signature,
    a changed message, a wrong key and S >= L fail."""
    keys = fixtures.Keys(5, 2)
    msg = os.urandom(110)
    sig = keys.priv[0].sign(msg)
    assert sig == ed25519.sign(keys.seeds[0], msg)
    assert ed25519.verify(keys.pubs[0], msg, sig)
    for byte in range(0, 64, 7):
        for bit in (0, 3, 7):
            assert not ed25519.verify(keys.pubs[0], msg,
                                      fixtures.flip(sig, byte, bit))
    assert not ed25519.verify(keys.pubs[0], msg + b"x", sig)
    assert not ed25519.verify(keys.pubs[1], msg, sig)
    s = int.from_bytes(sig[32:], "little") + ed25519.L
    assert not ed25519.verify(keys.pubs[0], msg,
                              sig[:32] + s.to_bytes(32, "little"))
    assert not ed25519.verify(keys.pubs[0], msg, sig[:63])


def test_zip215_small_order_and_non_canonical_encodings():
    """ZIP-215's cofactored equation accepts S = 0 with A and R of small
    order, and a y >= p encoding of them; strict RFC 8032 would not."""
    one = (1).to_bytes(32, "little")                 # the identity, y = 1
    one_p = (1 + ed25519.P).to_bytes(32, "little")   # the same, y + p
    zero_s = bytes(32)
    for pub in (one, one_p):
        for r in (one, one_p):
            assert ed25519.verify(pub, b"any message", r + zero_s)
    # a key that does not decode (y = 2 gives no point) fails
    assert not ed25519.verify((2).to_bytes(32, "little"), b"m",
                              one + zero_s)


ZERO_SECS = -62135596800  # Go's zero time.Time


def bz(*v):
    return bytes(v)


TS0 = bz(0x2A, 0x0B, 0x08, 0x80, 0x92, 0xB8, 0xC3, 0x98, 0xFE, 0xFF, 0xFF,
         0xFF, 0x01)
H1R1 = bz(0x11, 1, 0, 0, 0, 0, 0, 0, 0, 0x19, 1, 0, 0, 0, 0, 0, 0, 0)
# CometBFT types/vote_test.go TestVoteSignBytesTestVectors
VOTE_VECTORS = [
    ("", 0, 0, 0, bz(0x0D) + TS0),
    ("", 2, 1, 1, bz(0x21, 0x08, 0x02) + H1R1 + TS0),
    ("", 1, 1, 1, bz(0x21, 0x08, 0x01) + H1R1 + TS0),
    ("", 0, 1, 1, bz(0x1F) + H1R1 + TS0),
    ("test_chain_id", 0, 1, 1,
     bz(0x2E) + H1R1 + TS0 + bz(0x32, 0x0D) + b"test_chain_id"),
]


@pytest.mark.parametrize("case", range(len(VOTE_VECTORS)))
def test_cometbft_vote_sign_bytes(case):
    chain, vtype, h, r, want = VOTE_VECTORS[case]
    assert canonical.vote_sign_bytes(chain, vtype, h, r, None, ZERO_SECS,
                                     0) == want


def test_precommit_rows_equal_one_by_one():
    bid = (bytes(range(32)), 3, bytes(range(32, 64)))
    secs = [1_700_000_000, 1_700_000_001, 0, 5]
    nanos = [0, 999_999_999, 7, 128]
    rows = canonical.precommit_rows("chain-x", 1_000_001, 2, bid, secs,
                                    nanos)
    assert rows == [canonical.vote_sign_bytes("chain-x", 2, 1_000_001, 2,
                                              bid, s, n)
                    for s, n in zip(secs, nanos)]


def test_valset_order_is_power_then_address():
    pubs = [bytes([i]) * 32 for i in range(6)]
    powers = [5, 9, 5, 1, 9, 5]
    order = verdicts.valset_order(pubs, powers)
    keyed = [(-powers[i], verdicts.address(pubs[i])) for i in order]
    assert keyed == sorted(keyed)


def test_light_rules():
    powers = [10] * 9                        # 2/3 of 90 is 60
    idxs, tallied, needed = verdicts.light_collect(powers, [True] * 9)
    assert (idxs, tallied, needed) == (list(range(7)), 70, 60)
    assert verdicts.light_verdict(idxs, tallied, needed, set()) is None
    assert verdicts.light_verdict(idxs, tallied, needed, {8, 4, 2}) == \
        ("InvalidSignatureError", 2)
    # a bad signature past the point of 2/3 is never examined
    assert verdicts.light_verdict(idxs, tallied, needed, {7}) is None
    present = [False] * 3 + [True] * 6       # 60: not more than 2/3
    got = verdicts.light_collect(powers, present)
    assert verdicts.light_verdict(*got, {3}) == ("NotEnoughPowerError",)


def test_short_commit_misses_quorum_by_the_least():
    powers = [1_000_000 - 997 * i for i in range(1000)]
    absent = fixtures.short_absent(powers)
    present = [i not in absent for i in range(1000)]
    assert verdicts.light_verdict(*verdicts.light_collect(powers, present),
                                  set()) == ("NotEnoughPowerError",)
    present[absent[-1]] = True
    assert verdicts.light_verdict(*verdicts.light_collect(powers, present),
                                  set()) is None


def test_group_tally():
    assert verdicts.group_tally([3, 4, 5], {1}) == 8
