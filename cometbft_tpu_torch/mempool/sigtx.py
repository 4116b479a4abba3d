"""Signed-tx envelope: the node-side CheckTx signature pre-check.

The reference mempool leaves tx authentication entirely to the app,
which means every CheckTx signature verification runs wherever the app
runs — serially, per tx. This build adds an OPTIONAL envelope the node
itself understands, so tx signature checks can ride the verify plane's
BULK lane and coalesce with everything else the device verifies
(PAPERS.md "Performance of EdDSA and BLS Signatures in Committee-Based
Consensus": batch verification pays off exactly when a sustained tx
stream keeps batches full).

Wire shape (all fixed offsets, no parsing ambiguity):

    b"SGTX" | pubkey (32, ed25519) | signature (64) | payload (...)

The signature covers ``SIGN_CONTEXT + payload``. A tx without the magic
prefix is NOT an envelope and flows through CheckTx untouched — apps
that do their own auth keep working. A tx WITH the magic but malformed
(short, bad key length) is rejected by the mempool with
CODE_TYPE_BAD_SIGNATURE before the app ever sees it.

The envelope is deliberately NOT stripped: the payload's meaning stays
an app concern, and blocks commit the exact bytes gossiped (stripping
would fork the tx hash between mempool and block).

The port's copy of the JAX package's mempool/sigtx.py (the same wire
shape and sign context, so one envelope checks in both packages).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

MAGIC = b"SGTX"
PUB_LEN = 32
SIG_LEN = 64
HEADER_LEN = len(MAGIC) + PUB_LEN + SIG_LEN
# domain separation: an envelope signature must never be replayable as
# a vote / proposal / p2p handshake signature
SIGN_CONTEXT = b"cometbft-tpu/sigtx/v1\x00"


class SignedTx(NamedTuple):
    pub: bytes       # raw ed25519 key bytes
    signature: bytes
    payload: bytes


class SigTxError(ValueError):
    """Magic present but the envelope is malformed."""


def is_signed(tx: bytes) -> bool:
    return tx.startswith(MAGIC)


def sign_bytes(payload: bytes) -> bytes:
    return SIGN_CONTEXT + payload


def wrap(priv, payload: bytes) -> bytes:
    """Build an envelope over `payload` with a crypto.keys.PrivKey."""
    sig = priv.sign(sign_bytes(payload))
    return MAGIC + priv.pub_key().data + sig + payload


def parse(tx: bytes) -> Optional[SignedTx]:
    """Split an envelope; None when `tx` is not one (no magic), raises
    SigTxError when the magic is present but the frame is short."""
    if not tx.startswith(MAGIC):
        return None
    if len(tx) < HEADER_LEN:
        raise SigTxError(
            f"sigtx envelope short: {len(tx)} < {HEADER_LEN} bytes"
        )
    pub = tx[len(MAGIC):len(MAGIC) + PUB_LEN]
    sig = tx[len(MAGIC) + PUB_LEN:HEADER_LEN]
    return SignedTx(pub, sig, tx[HEADER_LEN:])
