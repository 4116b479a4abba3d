"""Seeded signature batches with every edge case of the sr25519 and ECDSA
verifiers, shared by the CPU tests, the GPU tests and chip_smoke.py, which
hold the kernels, their plain versions and the oracles to each other on
them. `rng` is a numpy Generator."""
from __future__ import annotations

import hashlib

from cometbft_tpu_torch.crypto import ristretto_ref as rist
from cometbft_tpu_torch.crypto import secp256k1_ref as secp
from cometbft_tpu_torch.crypto import sr25519_ref as sr


def non_decodable_ristretto() -> bytes:
    """The smallest even s < p that ristretto DECODE rejects."""
    for s in range(2, 200, 2):
        b = s.to_bytes(32, "little")
        if rist.decode(b) is None:
            return b
    raise AssertionError("no rejected encoding below 200")


def sr25519_cases(rng, n_valid: int = 16):
    """(pubs, msgs, sigs): n_valid signed rows over several message lengths
    (0 to 201 bytes, so the merlin batching makes several groups), then one
    row of each edge case: tampered message, missing marker bit, s >= L,
    odd, non-canonical (>= p) and non-decodable A and R encodings, short
    key and signature, and a last valid row."""
    pubs, msgs, sigs = [], [], []
    for i in range(n_valid):
        m = rng.bytes([0, 7, 40, 110, 200][i % 5] + int(rng.integers(0, 2)))
        pk, (sig,) = sr.sign_many(rng.bytes(32), [m], rng=rng.bytes(32))
        pubs.append(pk)
        msgs.append(m)
        sigs.append(sig)
    pk, (sig,) = sr.sign_many(rng.bytes(32), [b"edge"], rng=bytes(32))
    bad_s = (int.from_bytes(sig[32:], "little") & ((1 << 255) - 1)) + sr.L
    nd = non_decodable_ristretto()
    odd = (int.from_bytes(pk, "little") | 1).to_bytes(32, "little")
    big = (rist.P + 2).to_bytes(32, "little")
    edge = [
        (pk, b"edge!", sig),                                  # tampered msg
        (pk, b"edge", sig[:63] + bytes([sig[63] & 0x7F])),    # no marker
        (pk, b"edge", sig[:32] + (bad_s | 1 << 255).to_bytes(32, "little")),
        (odd, b"edge", sig), (big, b"edge", sig), (nd, b"edge", sig),
        (pk, b"edge", odd[:1] + sig[1:]),                     # R odd
        (pk, b"edge", big + sig[32:]), (pk, b"edge", nd + sig[32:]),
        (pk[:31], b"edge", sig), (pk, b"edge", sig[:63]),     # lengths
        (pk, b"edge", sig),                                   # valid
    ]
    for p, m, s in edge:
        pubs.append(p)
        msgs.append(m)
        sigs.append(s)
    return pubs, msgs, sigs


def ecdsa_xr2_case(msg: bytes):
    """(pub, sig) of a valid signature whose R has x(R) = r + N < p, so
    only the verifier's second candidate (r + N) matches: pick such an R
    on the curve, fix s, and solve for the key Q = (R - [u1]G) / u2."""
    x = secp.N + 1  # r = x - N must be at least 1
    while True:
        yy = (pow(x, 3, secp.P) + 7) % secp.P
        y = pow(yy, (secp.P + 1) // 4, secp.P)
        if y * y % secp.P == yy:
            break
        x += 1
    r, s = x - secp.N, 12345
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    w = pow(s, secp.N - 2, secp.N)
    u1, u2 = z * w % secp.N, r * w % secp.N
    g1 = secp._base_mul(u1)
    diff = secp.pt_add((x, y), (g1[0], secp.P - g1[1]))
    q = secp._mul(pow(u2, secp.N - 2, secp.N), diff)
    return secp.compress(*q), r.to_bytes(32, "big") + s.to_bytes(32, "big")


def ecdsa_cases(rng, n_valid: int = 12):
    """(pubs, msgs, sigs): n_valid signed rows, then one row of each edge
    case: tampered signature, tampered message, high S, r = 0, r >= N,
    s = 0, bad prefix, x >= p, an x with no curve point (both parities),
    short signature and key, a valid signature that matches only through
    r + N (the xr2 branch), and a last valid row."""
    pubs, msgs, sigs = [], [], []
    for i in range(n_valid):
        d = int(rng.integers(1, 2**62)) * int(rng.integers(1, 2**62)) + i
        m = rng.bytes(int(rng.integers(0, 120)))
        pubs.append(secp.pubkey_from_secret(d))
        msgs.append(m)
        sigs.append(secp.sign(d, m))
    d = 0xC0FFEE
    pub, m = secp.pubkey_from_secret(d), b"edge"
    sig = secp.sign(d, m)
    r, s = sig[:32], int.from_bytes(sig[32:], "big")
    no_point = (5).to_bytes(32, "big")  # 5^3 + 7 is not a square mod p
    xr2_pub, xr2_sig = ecdsa_xr2_case(b"xr2")
    edge = [
        (pub, m, sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:]),
        (pub, m + b"!", sig),
        (pub, m, r + (secp.N - s).to_bytes(32, "big")),       # high S
        (pub, m, bytes(32) + sig[32:]),                       # r = 0
        (pub, m, secp.N.to_bytes(32, "big") + sig[32:]),      # r >= N
        (pub, m, r + bytes(32)),                              # s = 0
        (b"\x05" + pub[1:], m, sig),                          # bad prefix
        (b"\x02" + secp.P.to_bytes(32, "big"), m, sig),       # x >= p
        (b"\x02" + no_point, m, sig), (b"\x03" + no_point, m, sig),
        (pub, m, sig[:63]), (pub[:32], m, sig),               # lengths
        (xr2_pub, b"xr2", xr2_sig),                           # xr2 branch
        (pub, m, sig),                                        # valid
    ]
    for p, mm, ss in edge:
        pubs.append(p)
        msgs.append(mm)
        sigs.append(ss)
    return pubs, msgs, sigs
