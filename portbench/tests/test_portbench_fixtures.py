"""The inputs are the seed's: the same seed gives the same inputs, and
every seed the same sizes."""
from portbench import fixtures, registry
from portbench.reference import ed25519

CONFIG = registry.config("ed25519-1k-chain")


def _height(seed, n=24, absent=()):
    keys = fixtures.Keys(seed, n)
    powers = fixtures.powers(CONFIG, n)
    r = fixtures.rng(seed, fixtures.HEIGHTS)
    return keys, fixtures.signed_height(keys, powers, "c", 7, r,
                                        CONFIG["timestamp_spread_ns"],
                                        absent)


def test_same_seed_same_inputs():
    big = 2**31 + 12345
    for seed in (0, 3, big):
        ka, a = _height(seed)
        kb, b = _height(seed)
        assert ka.pubs == kb.pubs and a == b
    assert _height(big)[1].sigs != _height(big + 1)[1].sigs
    assert fixtures.sample(big, 100, 10, 3) == fixtures.sample(big, 100, 10, 3)


def test_every_seed_the_same_sizes():
    shapes = set()
    for seed in (1, 2, 2**33):
        _, h = _height(seed, absent=(0, 1))
        shapes.add((len(h.sigs), sum(h.present), len(h.msgs)))
    assert shapes == {(24, 22, 24)}


def test_signatures_are_over_the_reference_sign_bytes():
    keys, h = _height(9)
    for i, k in enumerate(h.order):
        assert ed25519.verify(keys.pubs[k], h.msgs[i], h.sigs[i])
    # set order: power descending, each power distinct here
    assert h.powers == sorted(h.powers, reverse=True)
    assert len(set(h.msgs)) == len(h.msgs)   # each row its own timestamp


def test_absent_rows_are_empty():
    _, h = _height(4, absent=(2,))
    assert not h.present[2] and h.sigs[2] == b"" and h.msgs[2] == b""


def test_tamper_streams_are_independent_of_the_inputs():
    a = fixtures.rng(5, fixtures.TAMPER).integers(1 << 30, size=4)
    b = fixtures.rng(5, fixtures.TAMPER).integers(1 << 30, size=4)
    c = fixtures.rng(5, fixtures.HEIGHTS).integers(1 << 30, size=4)
    assert (a == b).all() and not (a == c).all()
