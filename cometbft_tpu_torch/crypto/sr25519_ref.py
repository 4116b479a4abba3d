"""sr25519 (schnorrkel) host reference: keys, sign, verify.

Protocol per the schnorrkel spec (what curve25519-voi implements and the
reference wires in at crypto/sr25519/batch.go:44-77, pubkey.go:50-62,
privkey.go:17 `signingCtx = NewSigningContext([]byte{})`):

  t = merlin.Transcript("SigningContext"); t.append("", ctx)
  t.append("sign-bytes", msg)
  t.append("proto-name", "Schnorr-sig")
  t.append("sign:pk", pk_ristretto_bytes)
  t.append("sign:R", R_ristretto_bytes)
  k = reduce_mod_L(t.challenge("sign:c", 64 bytes))
  accept iff s*B - k*A == R  (ristretto equality), with the signature's
  s carrying schnorrkel's high-bit marker (sig[63] |= 0x80) and required
  canonical (< L) after clearing it.

The merlin layer underneath is validated byte-exact against the published
merlin conformance vector (tests/test_torch_sr25519.py), so transcript
challenges here match voi's.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.crypto import ristretto_ref as rist
from cometbft_tpu_torch.crypto.merlin import Transcript

L = ed.L

SIGNING_CTX_LABEL = b"SigningContext"
CTX = b""  # the reference uses the empty signing context (privkey.go:17)


def _signing_prefix() -> Transcript:
    t = Transcript(SIGNING_CTX_LABEL)
    t.append_message(b"", CTX)
    return t


def signing_transcript(msg: bytes) -> Transcript:
    t = _signing_prefix()
    t.append_message(b"sign-bytes", msg)
    return t


def challenge_scalar(msg: bytes, pk: bytes, r_bytes: bytes) -> int:
    t = signing_transcript(msg)
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pk)
    t.append_message(b"sign:R", r_bytes)
    return int.from_bytes(t.challenge_bytes(b"sign:c", 64), "little") % L


def expand_ed25519(seed: bytes) -> Tuple[int, bytes]:
    """MiniSecretKey -> (scalar, nonce), schnorrkel ExpandEd25519 mode:
    sha512, ed25519 clamp, then divide the scalar by the cofactor."""
    h = hashlib.sha512(seed).digest()
    key = bytearray(h[:32])
    key[0] &= 248
    key[31] &= 63
    key[31] |= 64
    scalar = int.from_bytes(bytes(key), "little") >> 3  # divide by 8
    return scalar, h[32:]


def pubkey_from_seed(seed: bytes) -> bytes:
    scalar, _ = expand_ed25519(seed)
    return rist.encode(ed.pt_mul(scalar * 8 % L, ed.BASE_EXT))


def sign(seed: bytes, msg: bytes, rng: Optional[bytes] = None) -> bytes:
    scalar, nonce = expand_ed25519(seed)
    scalar = scalar * 8 % L  # undo the storage division for group math
    pk = rist.encode(ed.pt_mul(scalar, ed.BASE_EXT))
    # witness scalar: hash nonce + msg + randomness (spec uses a
    # transcript witness; any high-entropy r is protocol-compatible)
    rnd = rng if rng is not None else os.urandom(32)
    r = int.from_bytes(
        hashlib.sha512(nonce + msg + rnd).digest(), "little"
    ) % L
    R = rist.encode(ed.pt_mul(r, ed.BASE_EXT))
    k = challenge_scalar(msg, pk, R)
    s = (k * scalar + r) % L
    sig = bytearray(R + s.to_bytes(32, "little"))
    sig[63] |= 0x80  # schnorrkel signature marker bit
    return bytes(sig)


def verify(pk_bytes: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64 or len(pk_bytes) != 32:
        return False
    if not sig[63] & 0x80:
        return False  # missing schnorrkel marker
    s_bytes = bytearray(sig[32:])
    s_bytes[63 - 32] &= 0x7F
    s = int.from_bytes(bytes(s_bytes), "little")
    if s >= L:
        return False
    A = rist.decode(pk_bytes)
    R = rist.decode(sig[:32])
    if A is None or R is None:
        return False
    k = challenge_scalar(msg, pk_bytes, sig[:32])
    # s*B - k*A == R  <=>  s*B + k*(-A) - R ~ identity coset
    sB = ed.pt_mul(s, ed.BASE_EXT)
    kA = ed.pt_mul(k, A)
    lhs = ed.pt_add(sB, ed.pt_neg(kA))
    return rist.equals(lhs, R)


def sign_many(seed: bytes, msgs, rng: Optional[bytes] = None):
    """(pubkey, [signature of each msg]) for one mini-secret: the key is
    expanded once and every group multiplication goes through
    ed25519_ref's fixed-base comb. Byte-equal to pubkey_from_seed(seed) and
    [sign(seed, m, rng) for m in msgs] when `rng` is given."""
    scalar, nonce = expand_ed25519(seed)
    scalar = scalar * 8 % L
    pk = rist.encode(ed._base_mul(scalar))
    sigs = []
    for msg in msgs:
        rnd = rng if rng is not None else os.urandom(32)
        r = int.from_bytes(
            hashlib.sha512(nonce + msg + rnd).digest(), "little"
        ) % L
        R = rist.encode(ed._base_mul(r))
        s = (challenge_scalar(msg, pk, R) * scalar + r) % L
        sig = bytearray(R + s.to_bytes(32, "little"))
        sig[63] |= 0x80
        sigs.append(bytes(sig))
    return pk, sigs


def keygen(seed: Optional[bytes] = None) -> Tuple[bytes, bytes]:
    """Returns (seed/mini-secret, pubkey bytes); a random seed when none
    is given."""
    if seed is None:
        seed = os.urandom(32)
    return seed, pubkey_from_seed(seed)
