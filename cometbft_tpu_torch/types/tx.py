"""Tx hashing + merkle inclusion proofs.

Reference: types/tx.go — Tx.Hash (:33, tmhash of the raw bytes),
Txs.Proof (:41, RFC-6962 inclusion proof of tx i in the block's Data
merkle root) and TxProof.Validate. The block's Data hash here is the
merkle root over the RAW tx byte slices (types/block.py Data.hash), so
a TxProof's leaf is the transaction itself and verifying it against a
(light-client-verified) header's data_hash proves the tx was committed
in that block — the `tx(prove=true)` / light-proxy path.

The port's copy of the JAX package's types/tx.py (host code).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from cometbft_tpu_torch.crypto import merkle


def tx_hash(tx: bytes) -> bytes:
    """Tx.Hash (types/tx.go:33) — the key the tx indexer stores under."""
    return hashlib.sha256(tx).digest()


@dataclass
class TxProof:
    """types/tx.go TxProof: root_hash + the tx + its merkle proof."""

    root_hash: bytes
    data: bytes
    proof: merkle.Proof

    def validate(self, data_hash: bytes) -> bool:
        """TxProof.Validate: proof ties self.data to data_hash."""
        if self.root_hash != data_hash:
            return False
        if not 0 <= self.proof.index < self.proof.total:
            return False
        return self.proof.verify(self.root_hash, self.data)

    def to_j(self) -> dict:
        return {
            "root_hash": self.root_hash.hex(),
            "data": self.data.hex(),
            "proof": {
                "total": self.proof.total,
                "index": self.proof.index,
                "leaf_hash": self.proof.leaf_hash.hex(),
                "aunts": [a.hex() for a in self.proof.aunts],
            },
        }

    @classmethod
    def from_j(cls, j: dict) -> "TxProof":
        p = j["proof"]
        return cls(
            bytes.fromhex(j["root_hash"]),
            bytes.fromhex(j["data"]),
            merkle.Proof(
                int(p["total"]), int(p["index"]),
                bytes.fromhex(p["leaf_hash"]),
                [bytes.fromhex(a) for a in p["aunts"]],
            ),
        )


def tx_proof(txs, index: int) -> TxProof:
    """Txs.Proof (types/tx.go:41): inclusion proof for txs[index]."""
    root, proofs = merkle.proofs_from_byte_slices(txs)
    return TxProof(root, txs[index], proofs[index])
