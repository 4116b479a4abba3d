"""ProofOps: chained verifiable proofs from a leaf to a trusted root.

Reference: crypto/merkle/proof_op.go — ProofOp {type, key, data},
ProofOperator (Run one step: value(s) -> next value), ProofRuntime
(registry of decoders + VerifyValue/VerifyAbsence walking the op chain
against a key path). An ABCI app answers `query(prove=true)` with a
ProofOps list; the light proxy verifies it against the app_hash of a
light-client-verified header, making query results trustless.

Op wire form is JSON (this framework's charter wire format); the only
built-in operator is the kv merkle op the in-tree kvstore emits
(`cbt:kv`): an RFC-6962 inclusion proof of the canonical k/v leaf
encoding in the sorted-state merkle root. Apps register their own
operator types on a ProofRuntime exactly like the reference's
DefaultProofRuntime + custom registrations.

The port's copy of the JAX package's crypto/proof_ops.py (host code).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List

from cometbft_tpu_torch.crypto import merkle

OP_KV = "cbt:kv"


class ProofError(Exception):
    pass


@dataclass
class ProofOp:
    """One verification step (crypto/merkle/proof_op.go ProofOp)."""

    type: str
    key: bytes = b""
    data: bytes = b""  # operator-specific payload (JSON here)

    def to_j(self) -> dict:
        return {"type": self.type, "key": self.key.hex(),
                "data": self.data.hex()}

    @classmethod
    def from_j(cls, j: dict) -> "ProofOp":
        return cls(j["type"], bytes.fromhex(j.get("key", "")),
                   bytes.fromhex(j.get("data", "")))


def kv_leaf(key: bytes, value: bytes) -> bytes:
    """Canonical injective k/v leaf encoding the kv op proves."""
    return len(key).to_bytes(4, "big") + key + value


def make_kv_op(key: bytes, proof: merkle.Proof) -> ProofOp:
    data = json.dumps({
        "total": proof.total, "index": proof.index,
        "leaf_hash": proof.leaf_hash.hex(),
        "aunts": [a.hex() for a in proof.aunts],
    }).encode()
    return ProofOp(OP_KV, key, data)


def _run_kv_op(op: ProofOp, values: List[bytes]) -> List[bytes]:
    """value -> merkle root; the chain's next (usually last) input."""
    if len(values) != 1:
        raise ProofError("kv op takes exactly one value")
    try:
        j = json.loads(op.data.decode())
        proof = merkle.Proof(
            int(j["total"]), int(j["index"]),
            bytes.fromhex(j["leaf_hash"]),
            [bytes.fromhex(a) for a in j["aunts"]],
        )
    except (ValueError, KeyError, TypeError) as e:
        raise ProofError(f"malformed kv proof op: {e}")
    leaf = kv_leaf(op.key, values[0])
    if merkle.leaf_hash(leaf) != proof.leaf_hash:
        raise ProofError("kv op: value does not match proof leaf")
    root = proof.compute_root()
    if not proof.verify(root, leaf):
        raise ProofError("kv op: inconsistent proof")
    return [root]


class ProofRuntime:
    """Registry + chain walker (proof_op.go ProofRuntime)."""

    def __init__(self):
        self._ops: Dict[str, Callable[[ProofOp, List[bytes]],
                                      List[bytes]]] = {}

    def register(self, op_type: str, run) -> None:
        self._ops[op_type] = run

    def verify_value(self, ops: List[ProofOp], root: bytes,
                     key: bytes, value: bytes) -> None:
        """Walk the chain: value at key must hash up to root
        (proof_op.go VerifyValue). Raises ProofError on any mismatch."""
        if not ops:
            raise ProofError("empty proof op chain")
        if ops[0].key != key:
            raise ProofError(
                f"proof is for key {ops[0].key!r}, want {key!r}"
            )
        values = [value]
        for op in ops:
            run = self._ops.get(op.type)
            if run is None:
                raise ProofError(f"unregistered proof op {op.type!r}")
            values = run(op, values)
        if len(values) != 1 or values[0] != root:
            raise ProofError(
                "proof chain does not land on the trusted root"
            )


def default_runtime() -> ProofRuntime:
    rt = ProofRuntime()
    rt.register(OP_KV, _run_kv_op)
    return rt
