"""Key types: ed25519, secp256k1 and sr25519 keys, signing, addresses — the
crypto.PubKey / crypto.PrivKey surface.

Reference: crypto/crypto.go:22-42 (interfaces, Address = SumTruncated),
crypto/ed25519/ed25519.go:109 (Sign), :156 (GenPrivKey), :181
(VerifySignature), crypto/secp256k1/secp256k1.go:24-220,
crypto/sr25519/{privkey,pubkey}.go. Counterpart of the JAX package's
crypto/keys.py.

Signing uses OpenSSL (`cryptography` package) when available and the
pure-Python RFC 8032 path (ed25519_ref.sign) otherwise; both give the same
bytes. Single verification always uses the ZIP-215 oracle
(crypto/ed25519_ref.py): OpenSSL's verify is cofactorless and rejects
encodings ZIP-215 accepts (crypto/ed25519/ed25519.go:40-42). secp256k1
and sr25519 keys sign and verify with the pure-Python oracles
(secp256k1_ref, sr25519_ref).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

try:
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        PublicFormat,
    )

    _HAVE_OPENSSL = True
except ImportError:  # pure-Python fallback below
    Ed25519PrivateKey = None
    _HAVE_OPENSSL = False

from cometbft_tpu_torch.crypto import ed25519_ref
from cometbft_tpu_torch.crypto import secp256k1_ref
from cometbft_tpu_torch.crypto import sr25519_ref
from cometbft_tpu_torch.crypto import tmhash

ED25519_KEY_TYPE = "ed25519"
SECP256K1_KEY_TYPE = "secp256k1"
SR25519_KEY_TYPE = "sr25519"


@dataclass(frozen=True)
class PubKey:
    """A public key: ed25519 or sr25519 (32 bytes) or secp256k1 (33
    compressed)."""

    data: bytes
    key_type: str = ED25519_KEY_TYPE

    def address(self) -> bytes:
        """20-byte address: SHA256(pubkey)[:20] for ed25519 and sr25519
        (crypto/crypto.go:18, crypto/sr25519/pubkey.go:27),
        RIPEMD160(SHA256(pubkey)) for secp256k1 (secp256k1.go:131)."""
        if self.key_type == SECP256K1_KEY_TYPE:
            return secp256k1_ref.address(self.data)
        return tmhash.sum_truncated(self.data)

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """Single verify: ZIP-215 for ed25519 (crypto/ed25519/ed25519.go:181),
        low-S-enforcing ECDSA for secp256k1 (secp256k1.go:192-220),
        schnorrkel for sr25519 (crypto/sr25519/pubkey.go:50)."""
        if self.key_type == SECP256K1_KEY_TYPE:
            return secp256k1_ref.verify(self.data, msg, sig)
        if self.key_type == SR25519_KEY_TYPE:
            return sr25519_ref.verify(self.data, msg, sig)
        if self.key_type != ED25519_KEY_TYPE:
            raise ValueError(f"unsupported key type {self.key_type!r}")
        return ed25519_ref.verify(self.data, msg, sig)

    def __bytes__(self) -> bytes:
        return self.data


@dataclass(frozen=True)
class PrivKey:
    """An ed25519 private key: 64 bytes = seed || pubkey (RFC 8032 / Go
    crypto/ed25519 layout)."""

    data: bytes

    @staticmethod
    def generate(seed: Optional[bytes] = None) -> "PrivKey":
        if seed is None:
            import os as _os

            seed = _os.urandom(32)
        assert len(seed) == 32
        if _HAVE_OPENSSL:
            pub = (
                Ed25519PrivateKey.from_private_bytes(seed)
                .public_key()
                .public_bytes(Encoding.Raw, PublicFormat.Raw)
            )
        else:
            pub = ed25519_ref.pubkey_from_seed(seed)
        return PrivKey(seed + pub)

    @property
    def seed(self) -> bytes:
        return self.data[:32]

    def pub_key(self) -> PubKey:
        return PubKey(self.data[32:])

    def sign(self, msg: bytes) -> bytes:
        """RFC 8032 deterministic signature."""
        if _HAVE_OPENSSL:
            return Ed25519PrivateKey.from_private_bytes(self.seed).sign(msg)
        return ed25519_ref.sign(self.seed, msg)


@dataclass(frozen=True)
class Secp256k1PrivKey:
    """A secp256k1 private key (32-byte big-endian scalar).

    Reference: crypto/secp256k1/secp256k1.go:24-129 (GenPrivKey, Sign
    producing 64-byte r||s with low-S normalization)."""

    data: bytes

    @staticmethod
    def generate(seed: Optional[bytes] = None) -> "Secp256k1PrivKey":
        if seed is None:
            import os as _os

            seed = _os.urandom(32)
        # fold the seed onto [1, N) like the reference's rejection loop
        d = int.from_bytes(seed, "big") % (secp256k1_ref.N - 1) + 1
        return Secp256k1PrivKey(d.to_bytes(32, "big"))

    @property
    def secret(self) -> int:
        return int.from_bytes(self.data, "big")

    def pub_key(self) -> PubKey:
        return PubKey(secp256k1_ref.pubkey_from_secret(self.secret),
                      SECP256K1_KEY_TYPE)

    def sign(self, msg: bytes) -> bytes:
        return secp256k1_ref.sign(self.secret, msg)


@dataclass(frozen=True)
class Sr25519PrivKey:
    """An sr25519 (schnorrkel) private key: 32-byte mini-secret.

    Reference: crypto/sr25519/privkey.go:27-60 (MiniSecretKey expanded
    ExpandEd25519-style; signing over the empty-context merlin
    transcript)."""

    data: bytes  # mini-secret seed

    @staticmethod
    def generate(seed: Optional[bytes] = None) -> "Sr25519PrivKey":
        if seed is None:
            import os as _os

            seed = _os.urandom(32)
        assert len(seed) == 32
        return Sr25519PrivKey(seed)

    def pub_key(self) -> PubKey:
        return PubKey(sr25519_ref.pubkey_from_seed(self.data),
                      SR25519_KEY_TYPE)

    def sign(self, msg: bytes) -> bytes:
        return sr25519_ref.sign(self.data, msg)
