"""Pure-Python sr25519 (schnorrkel): keys and signing for the fixtures,
and verification.

A frozen copy, at commit 27ad187b7944f8030bffd4ac1bbd5429dd7c5740, of
cometbft_tpu_torch/crypto/keccak.py (`keccak_f1600` and the derivation of
its constants), crypto/merlin.py (the scalar `Strobe128` and
`Transcript`), crypto/ristretto_ref.py (RFC 9496 decode, encode and
equality) and crypto/sr25519_ref.py (`expand_ed25519`,
`challenge_scalar`, `verify`, and `sign_many`'s signing, as `Key`),
kept here so that the reference shares no code with the program it
judges. The curve arithmetic is the benchmark's own ed25519 reference
(`reference/ed25519.py`). `verify` uses no native code and no numpy:
one transcript at a time. The fixtures' signer (`sign_batch`) runs the
transcripts of many signatures in lockstep over numpy arrays, and its
[r]B over a radix-256 comb.

The protocol, as curve25519-voi implements it for CometBFT
(crypto/sr25519/pubkey.go, privkey.go with the empty signing context):

  t = merlin.Transcript("SigningContext"); t.append("", b"")
  t.append("sign-bytes", msg); t.append("proto-name", "Schnorr-sig")
  t.append("sign:pk", pk); t.append("sign:R", R)
  k = t.challenge("sign:c", 64 bytes) mod L
  accept iff [s]B - [k]A == R as ristretto points, where the signature
  carries the marker bit (sig[63] & 0x80) and s, the marker cleared, is
  below L, and both A and R decode.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from portbench.reference import ed25519 as ed

P, L, D, SQRT_M1 = ed.P, ed.L, ed.D, ed.SQRT_M1
MASK64 = (1 << 64) - 1

# -- keccak-f[1600] (FIPS 202) -------------------------------------------


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


def state_to_bytes(lanes) -> bytearray:
    out = bytearray(200)
    for i, lane in enumerate(lanes):
        out[8 * i:8 * i + 8] = int(lane).to_bytes(8, "little")
    return out


def bytes_to_state(b) -> list:
    return [int.from_bytes(bytes(b[8 * i:8 * i + 8]), "little")
            for i in range(25)]


def sha3_256(data: bytes) -> bytes:
    """SHA3-256 over this permutation, to hold it to hashlib's."""
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


# -- STROBE-128 and merlin ----------------------------------------------

R = 166  # STROBE-128 rate: 200 - 2*16 - 2
FLAG_I, FLAG_A, FLAG_C, FLAG_T, FLAG_M, FLAG_K = (1 << i for i in range(6))


def _initial_state() -> bytes:
    st = bytearray(200)
    st[0:6] = bytes([1, R + 2, 1, 0, 1, 96])
    st[6:18] = b"STROBEv1.0.2"
    return bytes(state_to_bytes(keccak_f1600(bytes_to_state(st))))


_INIT = _initial_state()


class Strobe128:
    """Single-stream STROBE-128 (the subset merlin uses: AD/meta-AD/PRF)."""

    def __init__(self, protocol_label: bytes):
        self.st = bytearray(_INIT)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self):
        self.st[self.pos] ^= self.pos_begin
        self.st[self.pos + 1] ^= 0x04
        self.st[R + 1] ^= 0x80
        self.st = bytearray(
            state_to_bytes(keccak_f1600(bytes_to_state(self.st))))
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for b in data:
            self.st[self.pos] ^= b
            self.pos += 1
            if self.pos == R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.st[self.pos])
            self.st[self.pos] = 0
            self.pos += 1
            if self.pos == R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            if flags != self.cur_flags:
                raise ValueError("a continued operation changed its flags")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (FLAG_C | FLAG_K)) and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)


class Transcript:
    """merlin::Transcript."""

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n)


# -- ristretto255 (RFC 9496) ----------------------------------------------


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if x & 1 else x


def sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """RFC 9496 SQRT_RATIO_M1: (was_square, sqrt(u/v) or sqrt(i*u/v))."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u = u % P
    correct = check == u
    flipped = check == (P - u) % P
    flipped_i = check == (P - u) * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    return (correct or flipped), _abs(r)


# 1/sqrt(a - d) with a = -1 (ENCODE's rotation branch)
_, INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (-1 - D) % P)


def decode(b: bytes) -> Optional[tuple]:
    """32 bytes -> extended point (X, Y, Z, T), or None: s must be
    canonical (< p) and non-negative, and pass RFC 9496 section 4.3.1."""
    if len(b) != 32:
        return None
    s = int.from_bytes(b, "little")
    if s >= P or s & 1:
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2s = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2s) % P
    was_square, invsqrt = sqrt_ratio_m1(1, v * u2s % P)
    if not was_square:
        return None
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def encode(pt: tuple) -> bytes:
    """Extended point -> canonical 32-byte encoding (RFC 9496 §4.3.2)."""
    X, Y, Z, T = pt
    u1 = (Z + Y) * (Z - Y) % P
    u2 = X * Y % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * T % P
    ix = X * SQRT_M1 % P
    iy = Y * SQRT_M1 % P
    if _is_negative(T * z_inv % P):
        x, y = iy, ix
        den_inv = den1 * INVSQRT_A_MINUS_D % P
    else:
        x, y = X, Y
        den_inv = den2
    if _is_negative(x * z_inv % P):
        y = (P - y) % P
    s = _abs(den_inv * ((Z - y) % P) % P)
    return s.to_bytes(32, "little")


def equals(p: tuple, q: tuple) -> bool:
    """Coset equality: X1Y2 == Y1X2 or Y1Y2 == X1X2 (RFC 9496 §4.5)."""
    X1, Y1, _, _ = p
    X2, Y2, _, _ = q
    return (X1 * Y2 - Y1 * X2) % P == 0 or (Y1 * Y2 - X1 * X2) % P == 0


# -- schnorrkel -----------------------------------------------------------


def _signing_prefix() -> Transcript:
    t = Transcript(b"SigningContext")
    t.append_message(b"", b"")
    return t


def _signing_transcript(msg: bytes) -> Transcript:
    t = _signing_prefix()
    t.append_message(b"sign-bytes", msg)
    return t


def challenge_scalar(msg: bytes, pk: bytes, r_bytes: bytes) -> int:
    t = _signing_transcript(msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pk)
    t.append_message(b"sign:R", r_bytes)
    return int.from_bytes(t.challenge_bytes(b"sign:c", 64), "little") % L


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64 or len(pk) != 32:
        return False
    if not sig[63] & 0x80:
        return False  # no schnorrkel marker
    s = int.from_bytes(sig[32:63] + bytes([sig[63] & 0x7F]), "little")
    if s >= L:
        return False
    A = decode(pk)
    R_pt = decode(sig[:32])
    if A is None or R_pt is None:
        return False
    k = challenge_scalar(msg, pk, sig[:32])
    lhs = ed.pt_add(ed.pt_mul(s, ed.BASE), ed.pt_neg(ed.pt_mul(k, A)))
    return equals(lhs, R_pt)


_COMB: list = []


def _base_mul(k: int):
    """[k]B for 0 <= k < 2^256 by a radix-256 fixed-base comb: 32
    additions (reference/ed25519.py's radix-16 comb takes 64), over a
    table of 32 x 256 points built on first use."""
    if not _COMB:
        step = ed.BASE
        for _ in range(32):
            row = [ed.IDENT]
            for _ in range(255):
                row.append(ed.pt_add(row[-1], step))
            _COMB.append(row)
            for _ in range(8):
                step = ed.pt_double(step)
    q = ed.IDENT
    for w in range(32):
        q = ed.pt_add(q, _COMB[w][(k >> (8 * w)) & 255])
    return q


class Key:
    """One schnorrkel key from a 32-byte mini-secret, expanded once
    (ExpandEd25519: sha512, the ed25519 clamp, the scalar divided by the
    cofactor and multiplied back for the group's arithmetic)."""

    def __init__(self, seed: bytes):
        h = hashlib.sha512(seed).digest()
        key = bytearray(h[:32])
        key[0] &= 248
        key[31] &= 63
        key[31] |= 64
        self.scalar = (int.from_bytes(bytes(key), "little") >> 3) * 8 % L
        self.nonce = h[32:]
        self.pub = encode(_base_mul(self.scalar))

    def witness(self, msg: bytes) -> int:
        """The witness r of msg: drawn from the key's nonce and msg, so
        the same key signs the same msg alike."""
        return int.from_bytes(hashlib.sha512(self.nonce + msg).digest(),
                              "little") % L

    def finish(self, r: int, r_enc: bytes, k: int) -> bytes:
        sig = bytearray(r_enc + ((k * self.scalar + r) % L).to_bytes(
            32, "little"))
        sig[63] |= 0x80  # the schnorrkel marker
        return bytes(sig)

    def sign(self, msg: bytes) -> bytes:
        r = self.witness(msg)
        r_enc = encode(_base_mul(r))
        return self.finish(r, r_enc, challenge_scalar(msg, self.pub, r_enc))


# -- the fixtures' signer: transcripts in lockstep ----------------------
#
# A signature's transcript is two permutations of pure-Python keccak
# (~1 ms here); 20,000 of them a run would take most of a minute. The
# signer runs the transcripts of messages of one length in lockstep over
# numpy arrays instead. `verify` never does: it is the scalar copy above.


def _keccak_lanes(states: np.ndarray) -> np.ndarray:
    """keccak_f1600 of each row of an (N, 25) uint64 array of lanes."""
    a = states.reshape(-1, 5, 5).transpose(0, 2, 1).copy()  # (N, x, y)

    def rol(v, n):
        if n == 0:
            return v
        return (v << np.uint64(n)) | (v >> np.uint64(64 - n))

    for rc in _RC:
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
        a[:, 0, 0] ^= np.uint64(rc)
    return a.transpose(0, 2, 1).reshape(-1, 25)


class _Lockstep(Strobe128):
    """N copies of one Strobe128 that take the same operations on data
    of the same length: the state an (N, 200) uint8 array, the data an
    (N, length) one, or (1, length) for data the same in all N."""

    def __init__(self, strobe: Strobe128, n: int):
        self.n = n
        self.st = np.tile(np.frombuffer(bytes(strobe.st), np.uint8),
                          (n, 1))
        self.pos = strobe.pos
        self.pos_begin = strobe.pos_begin
        self.cur_flags = strobe.cur_flags

    def _run_f(self):
        self.st[:, self.pos] ^= self.pos_begin
        self.st[:, self.pos + 1] ^= 0x04
        self.st[:, R + 1] ^= 0x80
        lanes = _keccak_lanes(self.st.view("<u8").reshape(self.n, 25))
        self.st = lanes.astype("<u8").view(np.uint8).reshape(self.n, 200)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data):
        if isinstance(data, (bytes, bytearray)):   # the STROBE framing
            data = _rows([bytes(data)])
        off = 0
        while off < data.shape[1]:
            take = min(R - self.pos, data.shape[1] - off)
            self.st[:, self.pos:self.pos + take] ^= data[:, off:off + take]
            self.pos += take
            off += take
            if self.pos == R:
                self._run_f()

    def _squeeze(self, n: int) -> np.ndarray:
        out = np.empty((self.n, n), np.uint8)
        off = 0
        while off < n:
            take = min(R - self.pos, n - off)
            out[:, off:off + take] = self.st[:, self.pos:self.pos + take]
            self.st[:, self.pos:self.pos + take] = 0
            self.pos += take
            off += take
            if self.pos == R:
                self._run_f()
        return out


def _rows(items: Sequence[bytes]) -> np.ndarray:
    return np.frombuffer(b"".join(items), np.uint8).reshape(len(items), -1)


def _append(st: _Lockstep, label: bytes, data: np.ndarray) -> None:
    """merlin's append_message on lockstep transcripts: data (N, length),
    or (1, length) for data the same in all N."""
    st.meta_ad(label, False)
    st.meta_ad(data.shape[1].to_bytes(4, "little"), True)
    st.ad(data, False)


def sign_batch(keys: Sequence[Key], msgs: Sequence[bytes]) -> List[bytes]:
    """keys[i].sign(msgs[i]) for each i, byte for byte."""
    prefix = _signing_prefix().strobe
    out: List[bytes] = [b""] * len(msgs)
    by_len: dict = {}
    for i, m in enumerate(msgs):
        by_len.setdefault(len(m), []).append(i)
    for idxs in by_len.values():
        rs = [keys[i].witness(msgs[i]) for i in idxs]
        r_encs = [encode(_base_mul(r)) for r in rs]
        st = _Lockstep(prefix, len(idxs))
        _append(st, b"sign-bytes", _rows([msgs[i] for i in idxs]))
        _append(st, b"proto-name", _rows([b"Schnorr-sig"]))
        _append(st, b"sign:pk", _rows([keys[i].pub for i in idxs]))
        _append(st, b"sign:R", _rows(r_encs))
        st.meta_ad(b"sign:c", False)
        st.meta_ad((64).to_bytes(4, "little"), True)
        chal = st.prf(64)
        for j, i in enumerate(idxs):
            k = int.from_bytes(chal[j].tobytes(), "little") % L
            out[i] = keys[i].finish(rs[j], r_encs[j], k)
    return out
