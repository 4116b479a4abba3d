"""Seeded inputs: keys, validator sets, signed heights, tampering.

Everything is plain data, made from `--seed` in the run's own process:
keys are 32-byte seeds drawn from the seed, signatures are RFC 8032
Ed25519 by OpenSSL (`cryptography`), over the sign-bytes that the
reference encodes. The same seed gives the same inputs; every seed gives
the same sizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from portbench.reference import canonical, verdicts

MASK64 = (1 << 64) - 1
BASE_SECS = 1_700_000_000

# independent random streams of one seed
KEYS, HEIGHTS, TAMPER, SAMPLE, POWERS = range(5)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & MASK64, stream])


class Keys:
    """n ed25519 key pairs from 32-byte seeds drawn from the seed."""

    def __init__(self, seed: int, n: int):
        from cryptography.hazmat.primitives.asymmetric.ed25519 import \
            Ed25519PrivateKey
        from cryptography.hazmat.primitives.serialization import (
            Encoding, PublicFormat,
        )

        raw = rng(seed, KEYS).bytes(32 * n)
        self.seeds = [raw[32 * i:32 * i + 32] for i in range(n)]
        self.priv = [Ed25519PrivateKey.from_private_bytes(s)
                     for s in self.seeds]
        self.pubs = [k.public_key().public_bytes(Encoding.Raw,
                                                 PublicFormat.Raw)
                     for k in self.priv]


def powers(config: dict, n: int) -> List[int]:
    """Each key's power, by the configuration's scheme."""
    p = config["power"]
    if p["scheme"] == "equal":
        return [p["each"]] * n
    if p["scheme"] == "linear":
        return [p["top"] - p["step"] * i for i in range(n)]
    raise ValueError(f"unknown power scheme {p['scheme']!r}")


@dataclass
class Height:
    """One height's commit, in its validator set's order."""

    height: int
    round: int
    block_id: tuple          # (hash, part set total, part set hash)
    order: List[int]         # key index at each set position
    powers: List[int]        # power at each set position
    secs: List[int]
    nanos: List[int]
    present: List[bool]      # signed for the block (else absent)
    msgs: List[bytes]        # the reference's sign-bytes (b"" if absent)
    sigs: List[bytes]


def set_order(keys: Keys, key_powers: Sequence[int]) -> List[int]:
    return verdicts.valset_order(keys.pubs, key_powers)


def signed_height(keys: Keys, key_powers: Sequence[int], chain_id: str,
                  height: int, r: np.random.Generator, spread_ns: int,
                  absent: Sequence[int] = ()) -> Height:
    """A height whose present validators all signed for one seeded block
    id, each at its own timestamp. `absent` lists set positions left out."""
    order = set_order(keys, key_powers)
    n = len(order)
    bid = (r.bytes(32), int(r.integers(1, 100)), r.bytes(32))
    off = r.integers(0, spread_ns, n)
    secs = [BASE_SECS + height + int(o) // 1_000_000_000 for o in off]
    nanos = [int(o) % 1_000_000_000 for o in off]
    present = [True] * n
    for i in absent:
        present[i] = False
    msgs = canonical.precommit_rows(chain_id, height, 0, bid, secs, nanos)
    sigs = [keys.priv[k].sign(m) if here else b""
            for k, m, here in zip(order, msgs, present)]
    msgs = [m if here else b"" for m, here in zip(msgs, present)]
    return Height(height, 0, bid, order, [key_powers[k] for k in order],
                  secs, nanos, present, msgs, sigs)


def short_absent(set_powers: Sequence[int]) -> List[int]:
    """The fewest top positions whose absence leaves the rest with no
    more than 2/3 of the power: a commit that misses quorum."""
    needed = verdicts.two_thirds(set_powers)
    left = sum(set_powers)
    k = 0
    while left > needed:
        left -= set_powers[k]
        k += 1
    return list(range(k))


def flip(sig: bytes, byte: int, bit: int) -> bytes:
    return sig[:byte] + bytes([sig[byte] ^ (1 << bit)]) + sig[byte + 1:]


def sample(seed: int, n: int, k: int, stream_id: int) -> List[int]:
    """k distinct positions of n, drawn from the seed."""
    r = np.random.default_rng([seed & MASK64, SAMPLE, stream_id])
    return sorted(int(i) for i in r.choice(n, size=min(k, n), replace=False))
