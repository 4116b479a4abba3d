"""ed25519 keys: signing, addresses — the crypto.PubKey / crypto.PrivKey
surface for the ed25519 slice of the port.

Reference: crypto/crypto.go:22-42 (interfaces, Address = SumTruncated),
crypto/ed25519/ed25519.go:109 (Sign), :156 (GenPrivKey), :181
(VerifySignature).

Signing uses OpenSSL (`cryptography` package) when available and the
pure-Python RFC 8032 path (ed25519_ref.sign) otherwise; both give the same
bytes. Single verification always uses the ZIP-215 oracle
(crypto/ed25519_ref.py): OpenSSL's verify is cofactorless and rejects
encodings ZIP-215 accepts (crypto/ed25519/ed25519.go:40-42).
secp256k1 and sr25519 keys come with their kernels.
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
from cometbft_tpu_torch.crypto import tmhash

ED25519_KEY_TYPE = "ed25519"


@dataclass(frozen=True)
class PubKey:
    """An ed25519 public key (32 raw bytes)."""

    data: bytes
    key_type: str = ED25519_KEY_TYPE

    def address(self) -> bytes:
        """20-byte address: SHA256(pubkey)[:20] (crypto/crypto.go:18)."""
        return tmhash.sum_truncated(self.data)

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """Single ZIP-215 verify (crypto/ed25519/ed25519.go:181)."""
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
