"""The ZIP-215 edge cases of the ed25519 verifiers, seeded signature
batches with every edge case of the sr25519 and ECDSA verifiers, and
seeded inputs with every edge case of the two tally kernels, shared by the
CPU tests, the GPU tests and chip_smoke.py, which hold the kernels, their
plain versions and the oracles to each other on them. `rng` is a numpy
Generator."""
from __future__ import annotations

import hashlib
from types import SimpleNamespace

import numpy as np

from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.crypto import ristretto_ref as rist
from cometbft_tpu_torch.crypto import secp256k1_ref as secp
from cometbft_tpu_torch.crypto import sr25519_ref as sr
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import ed25519_fused as kf
from cometbft_tpu_torch.ops import ed25519_kernel as ek


def ed25519_zip215_cases():
    """(pub, msg, sig) rows on ZIP-215's edges: the identity, a
    non-canonical y (>= p) as R and as A, -0, and small-order A and R at
    y = 0 (the matrix of tests/test_ed25519_pallas.py::test_zip215_edges
    and more)."""
    ident = ed.pt_compress(ed.IDENT)
    cases = [(ident, b"m", ident + b"\x00" * 32)]
    for y in range(19):
        u, v = (y * y - 1) % ed.P, (ed.D * y * y + 1) % ed.P
        ok, x = ed._sqrt_ratio(u, v)
        if ok:
            enc_nc = int.to_bytes((y + ed.P) | ((x & 1) << 255), 32, "little")
            break
    pub, (sig,) = ed.sign_many(bytes(32), [b"x"])
    cases.append((pub, b"x", enc_nc + sig[32:]))
    cases.append((enc_nc, b"x", sig))
    neg_zero = int.to_bytes(1 | (1 << 255), 32, "little")
    cases.append((neg_zero, b"m", neg_zero + b"\x00" * 32))
    cases.append((bytes(32), b"s", ident + b"\x00" * 32))
    cases.append((ident, b"s", bytes(32) + b"\x00" * 32))
    return cases


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


# The tally kernels' edge cases: (name, B, C, options) for `tally_case`.
# C = 257 is one above csrc/tally_core.cuh's shared-memory cap of 256
# commits; B = 777 and 4,099 are not multiples of 4 (no 16-byte loads) and
# 1,000 not of the 512 columns a block takes; B = 2^17 with every column
# valid and counted in one commit and every limb 2^13 - 1 is the largest
# per-limb sum the wrappers accept (2^17 (2^13 - 1) < 2^30).
TALLY_CASES = (
    ("one_commit", 1024, 1, {}),
    ("ragged_scalar_loads", 777, 5, {}),
    ("ragged_blocks", 1000, 16, {}),
    ("odd_width", 4099, 64, {"M": 999}),
    ("at_smem_cap", 2048, 256, {}),
    ("above_smem_cap", 2048, 257, {}),
    ("full_limbs", 4096, 12, {"full_limbs": True}),
    ("b_2_17_one_commit", 1 << 17, 3, {"one_commit": 1, "M": 1000}),
)


def tally_case(rng, B: int, C: int, cached: bool = False, M: int = 100,
               one_commit=None, full_limbs: bool = False):
    """A seeded tally input with its edge cases, for both kernels: verdicts
    other than 0 and 1, uncounted columns, commit ids below 0 and at or
    above C, power limbs at 2^13 - 1, and per-commit thresholds at the
    exact sum - 1, the sum and the sum + 1 (by commit id mod 3).

    `one_commit`: every column valid and counted in that commit.
    `full_limbs`: every power limb 2^13 - 1. Returns a namespace of the
    packed (R, B) int32 `rows`, (B,) int32 `valid`, the cached layout's
    (M, 5) int32 `power5` (None for the general one), the tally's inputs
    column by column (`p5` (B, 5), `counted`, `cids`), the (C, 6) `thresh`
    limbs and the exact per-commit `sums` (Python ints)."""
    mask = (1 << 13) - 1
    if one_commit is not None:
        valid = np.ones(B, np.int32)
        counted = np.ones(B, bool)
        cids = np.full(B, one_commit, np.int32)
    else:
        valid = rng.choice(np.array([0, 1, 1, 1, 2, -1, 7, -2**31], np.int32),
                           B)
        counted = rng.random(B) < 0.85
        cids = rng.integers(-3, C + 3, B).astype(np.int32)
    if cached:
        power5 = rng.integers(0, mask + 1, (M, 5)).astype(np.int32)
        power5[rng.random(M) < 0.2] = mask
        if full_limbs or one_commit is not None:
            power5[:] = mask
        p5 = power5[np.arange(B) % M]
    else:
        power5 = None
        p5 = rng.integers(0, mask + 1, (B, 5)).astype(np.int32)
        p5[rng.random(B) < 0.2] = mask
        if full_limbs or one_commit is not None:
            p5[:] = mask
    live = (valid != 0) & counted & (cids >= 0) & (cids < C)
    col_int = ek.tally_to_int(p5)
    sums = [0] * C
    for b in np.flatnonzero(live):
        sums[cids[b]] += int(col_int[b])
    thresh = np.stack([ek.threshold_limbs(max(0, s + c % 3 - 1))[0]
                       for c, s in enumerate(sums)])
    if cached:
        flags = (counted.astype(np.int32) << 2) | (cids << 3) | \
            rng.integers(0, 4, B).astype(np.int32)
        rows = np.zeros(ec.packed_rows_shape(B, C), np.int32)
        rows[ec.V_FLAGS] = flags
        rows[ec.V_THRESH:].reshape(-1)[:C * 6] = thresh.reshape(-1)
    else:
        rows = kf.pack_rows(ek.pack_batch([], [], [], pad_to=B), p5, counted,
                            cids, thresh)
    return SimpleNamespace(rows=rows, valid=valid, power5=power5, p5=p5,
                           counted=counted, cids=cids, thresh=thresh,
                           sums=sums, C=C)


def tally_edge_case(name: str, cached: bool = False):
    """The case of TALLY_CASES called `name`, made from its own seed."""
    names = [c[0] for c in TALLY_CASES]
    i = names.index(name)
    _, B, C, opts = TALLY_CASES[i]
    return tally_case(np.random.default_rng(1000 + 2 * i + int(cached)), B,
                      C, cached=cached, **opts)


# The stamp kernel's cases: a sweep of chain ids of 0 to 80 bytes, one
# template site for each under each block-id form (nil and full), at every
# fuzzed timestamp, so that rows take 1, 2 and 3 SHA-512 blocks and land on
# both sides of each block edge (sign-bytes of 47 / 48 and 175 / 176
# bytes); then its twists: "wrap" (M = 40 keys, column b takes key
# b mod M), "dead" (a third of the lanes dead, with junk in their other
# flag bits), "thresholds" (50 commits: the thresholds fill one row and
# part of a second) and "clamp" (4 sites, template indices up to 255,
# which clamp to the last site as XLA's gather does).
STAMP_CASES = ("sweep", "wrap", "dead", "thresholds", "clamp")
STAMP_CHAIN_LENS = range(81)
# timestamps that cross every varint width boundary, the zero-skipping
# cases and the 10-byte two's-complement negatives
STAMP_FUZZ_SECS = (0, 1, 127, 128, 16383, 16384, 1_700_000_000, 2**31 - 1,
                   2**31, 2**40, 2**62, -1, -2**33)
STAMP_FUZZ_NANOS = (0, 1, 127, 128, 999_999_999, 5, 42, -7)


def stamp_case(name: str, B: int = 256):
    """The stamp case `name` of STAMP_CASES over B columns, made from its
    own seed: the template sites (`site_params`: (chain_id, height, round,
    block id or None), `tmpls`, `sites`), the staged deltas (`dsig`,
    `dts`, `dfl`), the (M, 32) keys `pub_raw`, the (C, 6) thresholds and
    `ref`, the rows pack_rows_cached builds from a host pack of the same
    votes (dead columns zero). `msg_lens` are the live rows' sign-bytes
    lengths."""
    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import sign_bytes_template

    rng = np.random.default_rng(2000 + STAMP_CASES.index(name))
    bid = BlockID(rng.bytes(32), PartSetHeader(7, rng.bytes(32)))
    site_params = [
        (bytes(rng.integers(97, 123, n, dtype=np.uint8)).decode(),
         1000 + 2 * n + k, n % 3, (None, bid)[k])
        for n in STAMP_CHAIN_LENS for k in range(2)]
    if name == "clamp":
        site_params = site_params[:4]
    tmpls = [sign_bytes_template(c, canonical.PRECOMMIT_TYPE, h, r, b)
             for c, h, r, b in site_params]
    n_sites = len(site_params)
    t_pad = 1 << (n_sites - 1).bit_length()
    combos = [(s, ns) for s in STAMP_FUZZ_SECS for ns in STAMP_FUZZ_NANOS]
    M = 40 if name == "wrap" else B
    C = 50 if name == "thresholds" else 3
    live = (rng.random(B) < 0.67 if name == "dead"
            else np.ones(B, bool))
    tidx = (rng.integers(0, 256, B) if name == "clamp"
            else np.arange(B) % n_sites)
    ts = [combos[(7 * b + b // n_sites) % len(combos)] for b in range(B)]
    # the first rows sit on each side of each block edge that the sites
    # can reach
    lens = {}
    for i, t in enumerate(tmpls):
        for c in combos:
            lens.setdefault(len(t.bytes_for(Timestamp(*c))), (i, c))
    edges = [lens[n] for n in (47, 48, 175, 176) if n in lens]
    for b, (i, c) in enumerate(edges[:B]):
        tidx[b], ts[b], live[b] = i, c, True
    site = np.minimum(tidx, t_pad - 1)
    counted = rng.random(B) < 0.75
    cids = rng.integers(0, C, B).astype(np.int32)
    keys = rng.integers(0, 256, (M, 32), dtype=np.uint8)
    sig = rng.integers(0, 256, (B, 64), dtype=np.uint8)
    sig[1::2, 63] &= 0x0f  # S < 2^252 < L on every other row
    for b, s in ((3, ed.L - 1), (5, ed.L), (7, 2**256 - 1)):
        if b < B:
            sig[b, 32:] = np.frombuffer(int.to_bytes(s, 32, "little"),
                                        np.uint8)
    msgs = [canonical.canonical_vote_bytes(
        site_params[site[b]][0], canonical.PRECOMMIT_TYPE,
        site_params[site[b]][1], site_params[site[b]][2],
        site_params[site[b]][3], Timestamp(*ts[b])) for b in range(B)]
    thresh = np.stack([ek.threshold_limbs(int(v))[0]
                       for v in rng.integers(0, 2**40, C)])
    pb = ek.pack_batch([keys[b % M].tobytes() for b in range(B)], msgs,
                       [sig[b].tobytes() for b in range(B)], pad_to=B)
    ref = ec.pack_rows_cached(pb, counted, cids, thresh)
    ref[:ec.V_THRESH, ~live] = 0
    dts = canonical.split_ts_words([t[0] for t in ts], [t[1] for t in ts])
    junk = rng.integers(0, 2**20, B).astype(np.int32) << 1
    dfl = np.where(live, 1 | (counted.astype(np.int32) << 1)
                   | (tidx.astype(np.int32) << 2) | (cids << 10),
                   junk).astype(np.int32)
    return SimpleNamespace(
        B=B, M=M, C=C, site_params=site_params, tmpls=tmpls,
        sites=[t.stamp_site() for t in tmpls], dsig=sig, dts=dts, dfl=dfl,
        pub_raw=keys, thresh=thresh, ref=ref,
        msg_lens=[len(msgs[b]) for b in np.flatnonzero(live)])
