"""Keccak-f[1600] permutation (FIPS-202), scalar and numpy-batched.

A copy of the JAX package's crypto/keccak.py (the port imports nothing of
that package); tests/test_torch_sr25519.py holds the two equal.

The sr25519 verifier needs merlin transcripts, which are STROBE-128 over
keccak-f[1600] (crypto/sr25519/batch.go:69 signingCtx.NewTranscriptBytes
in the reference delegates to curve25519-voi's merlin). No keccak
primitive ships in this image (`cryptography` exposes SHA3 digests only),
so the permutation is implemented here from the spec.

Constants are DERIVED (round constants from the rc(t) LFSR, rotation
offsets from the pi-lane walk) rather than transcribed, and the
permutation is validated against hashlib.sha3_256 by running the full
sponge in tests (tests/test_torch_sr25519.py) — an in-image ground truth.

The batched variant runs N independent states in parallel as a numpy
(N, 25) uint64 array: the merlin challenge for every signature in a
commit is computed in one vectorized pass (host-side analog of the
device batch: transcripts differ only in their absorbed bytes).
"""
from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1


def _derive_round_constants(n_rounds: int = 24):
    """FIPS-202 rc(t) LFSR -> per-round RC words."""

    def rc_bit(t: int) -> int:
        if t % 255 == 0:
            return 1
        r = 1
        for _ in range(t % 255):
            r <<= 1
            if r & 0x100:
                r ^= 0x171
        return r & 1

    out = []
    for ir in range(n_rounds):
        rc = 0
        for j in range(7):
            if rc_bit(j + 7 * ir):
                rc |= 1 << ((1 << j) - 1)
        out.append(rc)
    return out


def _derive_rotations():
    """Rotation offsets via the (x,y) -> (y, 2x+3y) pi walk."""
    rot = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        rot[x][y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return rot


_RC = _derive_round_constants()
_ROT = _derive_rotations()
_RC_NP = np.array(_RC, dtype=np.uint64)


def keccak_f1600(lanes):
    """One permutation of a single state: list of 25 ints (x + 5y order)."""
    a = [[lanes[x + 5 * y] for y in range(5)] for x in range(5)]

    def rol(v, n):
        return ((v << n) | (v >> (64 - n))) & MASK64

    for rnd in range(24):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = rol(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y] & MASK64)
                                     & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= _RC[rnd]
    return [a[x][y] for y in range(5) for x in range(5)]


def keccak_f1600_np(states: np.ndarray) -> np.ndarray:
    """Batched permutation: states (N, 25) uint64 (lane order x + 5y)."""
    a = states.reshape(-1, 5, 5).transpose(0, 2, 1).copy()  # (N, x, y)

    def rol(v, n):
        if n == 0:
            return v
        return (v << np.uint64(n)) | (v >> np.uint64(64 - n))

    for rnd in range(24):
        c = a[:, :, 0] ^ a[:, :, 1] ^ a[:, :, 2] ^ a[:, :, 3] ^ a[:, :, 4]
        d = np.empty_like(c)
        for x in range(5):
            d[:, x] = c[:, (x - 1) % 5] ^ rol(c[:, (x + 1) % 5], 1)
        a ^= d[:, :, None]
        b = np.empty_like(a)
        for x in range(5):
            for y in range(5):
                b[:, y, (2 * x + 3 * y) % 5] = rol(a[:, x, y], _ROT[x][y])
        a = b ^ (~b[:, [1, 2, 3, 4, 0], :] & b[:, [2, 3, 4, 0, 1], :])
        a[:, 0, 0] ^= _RC_NP[rnd]
    return a.transpose(0, 2, 1).reshape(-1, 25)


def state_to_bytes(lanes) -> bytearray:
    out = bytearray(200)
    for i, lane in enumerate(lanes):
        out[8 * i:8 * i + 8] = int(lane).to_bytes(8, "little")
    return out


def bytes_to_state(b) -> list:
    return [int.from_bytes(bytes(b[8 * i:8 * i + 8]), "little")
            for i in range(25)]


def sha3_256(data: bytes) -> bytes:
    """SHA3-256 via this permutation — exists ONLY to differential-test
    keccak_f1600 against hashlib (tests/test_torch_sr25519.py)."""
    rate = 136
    st = bytearray(200)
    padded = bytearray(data)
    padded.append(0x06)
    while len(padded) % rate:
        padded.append(0)
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        for i in range(rate):
            st[i] ^= padded[off + i]
        st = state_to_bytes(keccak_f1600(bytes_to_state(st)))
    return bytes(st[:32])
