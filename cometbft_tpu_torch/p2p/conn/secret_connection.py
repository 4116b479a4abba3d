"""SecretConnection: authenticated-encryption channel over any stream.

Reference: p2p/conn/secret_connection.go — STS pattern (:18): ephemeral
X25519 ECDH, key derivation, ChaCha20-Poly1305 framing (1024-byte data
frames, 4-byte length prefix), remote identity authenticated by signing
the handshake challenge with the node's ed25519 key (:55-57).

This build derives keys with HKDF-SHA256 over the ECDH secret and both
ephemeral pubkeys (the reference uses a merlin transcript; the wire
format here is self-defined — nodes of THIS framework interoperate,
Go-node wire compat is a non-goal per the rebuild charter). Nonces are
96-bit little-endian counters, one per direction.
"""
from __future__ import annotations

import os
import struct
from typing import Tuple

try:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import (
        ChaCha20Poly1305,
    )
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        PublicFormat,
    )

    _HAVE_OPENSSL = True
except ImportError:  # pure-Python fallback (crypto/aead_ref.py)
    from cometbft_tpu_torch.crypto.aead_ref import (  # noqa: F401
        ChaCha20Poly1305,
        X25519PrivateKey,
        X25519PublicKey,
        hkdf_sha256,
    )

    _HAVE_OPENSSL = False

from cometbft_tpu_torch.crypto.keys import PrivKey, PubKey

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024          # secret_connection.go dataMaxSize
TOTAL_FRAME_SIZE = DATA_LEN_SIZE + DATA_MAX_SIZE
TAG_SIZE = 16


class HandshakeError(Exception):
    pass


def _kdf(shared: bytes, lo_pub: bytes, hi_pub: bytes) -> Tuple[bytes, bytes, bytes]:
    """Derive (key_lo_to_hi, key_hi_to_lo, challenge) from the ECDH secret
    and the sorted ephemeral pubkeys. Both backends compute the SAME
    RFC 5869 HKDF-SHA256 — an OpenSSL node and a pure-Python node
    handshake with each other."""
    if _HAVE_OPENSSL:
        okm = HKDF(
            algorithm=hashes.SHA256(), length=96,
            salt=b"CBT_TPU_SECRET_CONNECTION", info=lo_pub + hi_pub,
        ).derive(shared)
    else:
        okm = hkdf_sha256(shared, b"CBT_TPU_SECRET_CONNECTION",
                          lo_pub + hi_pub, 96)
    return okm[:32], okm[32:64], okm[64:]


class SecretConnection:
    """Wraps a stream (socket-like object with sendall/recv) after the STS
    handshake. Use SecretConnection.handshake(...) to construct."""

    def __init__(self, stream, send_key: bytes, recv_key: bytes,
                 remote_pub: PubKey):
        self._stream = stream
        self._send = ChaCha20Poly1305(send_key)
        self._recv = ChaCha20Poly1305(recv_key)
        self._send_nonce = 0
        self._recv_nonce = 0
        self._recv_buf = b""
        self.remote_pub = remote_pub

    # -- handshake ---------------------------------------------------------

    @staticmethod
    def handshake(stream, local_priv: PrivKey) -> "SecretConnection":
        """Mutual-auth handshake; returns the wrapped connection.

        1. exchange 32-byte ephemeral X25519 pubkeys
        2. ECDH -> HKDF -> directional keys + 32-byte challenge
        3. exchange (node pubkey, sig over challenge) inside the
           encrypted channel; verify the peer's signature
        """
        eph = X25519PrivateKey.generate()
        if _HAVE_OPENSSL:
            eph_pub = eph.public_key().public_bytes(
                Encoding.Raw, PublicFormat.Raw
            )
        else:
            eph_pub = eph.public_key().public_bytes_raw()
        stream.sendall(eph_pub)
        their_eph = _read_exact(stream, 32)
        shared = eph.exchange(X25519PublicKey.from_public_bytes(their_eph))

        lo, hi = sorted([eph_pub, their_eph])
        k_lo_hi, k_hi_lo, challenge = _kdf(shared, lo, hi)
        if eph_pub == lo:
            send_key, recv_key = k_lo_hi, k_hi_lo
        else:
            send_key, recv_key = k_hi_lo, k_lo_hi

        conn = SecretConnection(stream, send_key, recv_key, None)
        # authenticate: send our identity + signature over the challenge
        sig = local_priv.sign(challenge)
        conn.write_msg(local_priv.pub_key().data + sig)
        auth = conn.read_msg()
        if len(auth) != 32 + 64:
            raise HandshakeError("bad auth message length")
        remote_pub = PubKey(auth[:32])
        if not remote_pub.verify_signature(challenge, auth[32:]):
            raise HandshakeError("challenge signature verification failed")
        conn.remote_pub = remote_pub
        return conn

    # -- framing -----------------------------------------------------------

    def _next_send_nonce(self) -> bytes:
        n = self._send_nonce
        self._send_nonce += 1
        return n.to_bytes(12, "little")

    def _next_recv_nonce(self) -> bytes:
        n = self._recv_nonce
        self._recv_nonce += 1
        return n.to_bytes(12, "little")

    def write_msg(self, data: bytes) -> None:
        """Send data as sealed fixed-size frames; the message always ends
        with a SHORT frame (possibly empty) so the reader knows where it
        stops even when the payload is an exact frame multiple."""
        while len(data) >= DATA_MAX_SIZE:
            self._write_frame(data[:DATA_MAX_SIZE])
            data = data[DATA_MAX_SIZE:]
        self._write_frame(data)

    def _write_frame(self, chunk: bytes) -> None:
        frame = struct.pack("<I", len(chunk)) + chunk
        frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
        sealed = self._send.encrypt(self._next_send_nonce(), frame, None)
        self._stream.sendall(sealed)

    def read_frame(self) -> bytes:
        sealed = _read_exact(self._stream, TOTAL_FRAME_SIZE + TAG_SIZE)
        frame = self._recv.decrypt(self._next_recv_nonce(), sealed, None)
        (ln,) = struct.unpack("<I", frame[:DATA_LEN_SIZE])
        if ln > DATA_MAX_SIZE:
            raise HandshakeError("frame length field too large")
        return frame[DATA_LEN_SIZE:DATA_LEN_SIZE + ln]

    def read_msg(self) -> bytes:
        """Read one full-or-short frame sequence: messages end at the
        first non-full frame (a full-frame message is followed by an
        empty frame only if it ended exactly at the boundary — handled by
        write_msg sending the final short chunk, possibly empty)."""
        out = b""
        while True:
            chunk = self.read_frame()
            out += chunk
            if len(chunk) < DATA_MAX_SIZE:
                return out


def _read_exact(stream, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = stream.recv(n - len(buf))
        if not part:
            raise ConnectionError("stream closed")
        buf += part
    return buf
