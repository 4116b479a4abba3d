"""kvstore: the canonical test application.

Reference: abci/example/kvstore/kvstore.go — key=value txs, deterministic
app hash over state, validator-update txs of the form
"val:base64pubkey!power" (kvstore.go:46 ValidatorSetChangePrefix).

The port's copy of the JAX package's abci/kvstore.py, over the port's
crypto/merkle.py and crypto/proof_ops.py; the snapshot methods are kept
as they are for statesync.
"""
from __future__ import annotations

import base64
import hashlib
import json
from typing import Dict, List

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.crypto.proof_ops import kv_leaf, make_kv_op

VALIDATOR_PREFIX = b"val:"


class KVStoreApplication(abci.Application):
    """In-memory kvstore with deterministic app hash and validator updates."""

    def __init__(self):
        self.state: Dict[bytes, bytes] = {}
        self.height = 0
        self.app_hash = b""
        self.staged: Dict[bytes, bytes] = {}
        self.val_updates: List[abci.ValidatorUpdate] = []

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _state_leaves(state: Dict[bytes, bytes], height: int):
        """Merkle leaves: one height leaf + one canonical leaf per k/v.

        The height leaf's 0xffffffff prefix can never collide with a
        kv leaf (whose prefix is the 4-byte key length)."""
        leaves = [b"\xff\xff\xff\xff" + height.to_bytes(8, "big")]
        leaves += [kv_leaf(k, v) for k, v in sorted(state.items())]
        return leaves

    def _compute_app_hash(self, height: int) -> bytes:
        """Merkle root over the sorted state (PROVABLE: query with
        prove=True returns an inclusion proof chaining a k/v to this
        root, which the light proxy verifies against a trusted
        header's app_hash — light/rpc/client.go:117)."""
        return merkle.hash_from_byte_slices(
            self._state_leaves(self.state, height)
        )

    @staticmethod
    def _parse_val_tx(tx: bytes):
        """val:base64pubkey!power[!nonce] -> (pubkey bytes, power).

        The optional trailing nonce is ignored by the app but makes
        repeat rotations of the SAME validator (out at epoch e, back
        in at e+2, out again at e+5 — routine under committee
        re-election) produce distinct tx bytes, so the mempool's
        replay-protection cache can never swallow a later epoch's
        change as a duplicate of an earlier one."""
        if not tx.startswith(VALIDATOR_PREFIX):
            return None
        try:
            body = tx[len(VALIDATOR_PREFIX):].decode()
            parts = body.split("!")
            if len(parts) < 2:
                raise ValueError("missing power")
            power = int(parts[1])
            if power < 0:
                # update_with_change_set rejects negative power — a
                # cheap tx must not reach apply_block as a chain-
                # halting update; reject it at CheckTx/ProcessProposal
                # like any other malformed val tx
                raise ValueError("negative power")
            return base64.b64decode(parts[0]), power
        except Exception:
            raise ValueError(f"malformed validator tx: {tx!r}")

    # -- ABCI ----------------------------------------------------------------

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        return abci.ResponseInfo(
            data=json.dumps({"size": len(self.state)}),
            version="kvstore-tpu-0.1",
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        return abci.ResponseInitChain(app_hash=self._compute_app_hash(0))

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        tx = req.tx
        if tx.startswith(VALIDATOR_PREFIX):
            try:
                self._parse_val_tx(tx)
            except ValueError as e:
                return abci.ResponseCheckTx(code=1, log=str(e))
            return abci.ResponseCheckTx()
        # key=value or bare bytes (key == value), kvstore.go:116
        return abci.ResponseCheckTx()

    def process_proposal(
        self, req: abci.RequestProcessProposal
    ) -> abci.ResponseProcessProposal:
        """Reject blocks carrying malformed validator txs (the reference
        kvstore validates in ProcessProposal so byzantine proposals never
        reach FinalizeBlock)."""
        for tx in req.txs:
            if tx.startswith(VALIDATOR_PREFIX):
                try:
                    self._parse_val_tx(tx)
                except ValueError:
                    return abci.ResponseProcessProposal(
                        status=abci.PROCESS_PROPOSAL_REJECT
                    )
        return abci.ResponseProcessProposal()

    def finalize_block(
        self, req: abci.RequestFinalizeBlock
    ) -> abci.ResponseFinalizeBlock:
        self.staged = dict(self.state)
        # keyed by pubkey, LAST tx wins (the reference kvstore
        # accumulates ValUpdates in a map too): two rotations of the
        # same validator landing in one block — out in epoch k, back
        # in at k+1 — must collapse to ONE update, because
        # update_with_change_set rejects duplicate addresses and that
        # rejection would halt the chain on every honest node
        val_updates: dict = {}
        results = []
        for tx in req.txs:
            if tx.startswith(VALIDATOR_PREFIX):
                # malformed val txs get a non-OK result; raising here would
                # abort apply_block on every honest node and halt the chain
                try:
                    pub, power = self._parse_val_tx(tx)
                except ValueError as e:
                    results.append(abci.ExecTxResult(code=1, log=str(e)))
                    continue
                val_updates[pub] = abci.ValidatorUpdate(pub, power)
                results.append(abci.ExecTxResult())
                continue
            if b"=" in tx:
                k, v = tx.split(b"=", 1)
            else:
                k = v = tx
            self.staged[k] = v
            results.append(abci.ExecTxResult(data=v))
        self.val_updates = list(val_updates.values())
        self._pending_height = req.height
        self._pending_hash = self._computed_staged_hash(req.height)
        return abci.ResponseFinalizeBlock(
            tx_results=results,
            validator_updates=list(self.val_updates),
            app_hash=self._pending_hash,
        )

    def _computed_staged_hash(self, height: int) -> bytes:
        saved, self.state = self.state, self.staged
        try:
            return self._compute_app_hash(height)
        finally:
            self.state = saved

    def commit(self) -> abci.ResponseCommit:
        self.state = self.staged
        self.height = self._pending_height
        self.app_hash = self._pending_hash
        self._committed = (dict(self.state), self.height)
        self._maybe_snapshot()
        return abci.ResponseCommit()

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        # one atomic read: commit() swaps in a new tuple, so (state,
        # height) can never be torn across a concurrent commit — a torn
        # pair would make the returned proof unverifiable
        state, height = self._snapshot()
        v = state.get(req.data, b"")
        resp = abci.ResponseQuery(
            key=req.data, value=v, height=height,
            log="exists" if v else "does not exist",
        )
        if req.prove and v:
            leaves = self._state_leaves(state, height)
            idx = 1 + sorted(state).index(req.data)
            _, proofs = merkle.proofs_from_byte_slices(leaves)
            resp.proof_ops = [make_kv_op(req.data, proofs[idx])]
        return resp

    def _snapshot(self):
        snap = getattr(self, "_committed", None)
        if snap is None:
            return dict(self.state), self.height
        return snap

    # -- state-sync snapshots (kvstore.go snapshot support) -----------------

    SNAPSHOT_CHUNK_SIZE = 64 * 1024

    def enable_snapshots(self, interval: int) -> None:
        """Take a snapshot every `interval` heights (config
        [statesync] snapshot-interval analog)."""
        self._snapshot_interval = interval
        self._snapshots = {}

    def _maybe_snapshot(self) -> None:
        interval = getattr(self, "_snapshot_interval", 0)
        if not interval or self.height == 0 or self.height % interval:
            return
        doc = json.dumps({
            "height": self.height,
            "app_hash": self.app_hash.hex(),
            "state": {k.hex(): v.hex() for k, v in self.state.items()},
        }).encode()
        chunks = [doc[i:i + self.SNAPSHOT_CHUNK_SIZE]
                  for i in range(0, max(len(doc), 1),
                                 self.SNAPSHOT_CHUNK_SIZE)]
        self._snapshots[self.height] = chunks
        # keep the most recent few (kvstore keeps a bounded set)
        for h in sorted(self._snapshots)[:-3]:
            del self._snapshots[h]

    def list_snapshots(self):
        out = []
        for h, chunks in sorted(getattr(self, "_snapshots", {}).items()):
            out.append(abci.Snapshot(
                height=h, format=1, chunks=len(chunks),
                hash=hashlib.sha256(b"".join(chunks)).digest(),
            ))
        return out

    def offer_snapshot(self, snapshot: abci.Snapshot) -> bool:
        if snapshot.format != 1 or snapshot.chunks < 1:
            return False
        self._restore = {"snapshot": snapshot, "chunks": [None] * snapshot.chunks}
        return True

    def load_snapshot_chunk(self, height, fmt, chunk) -> bytes:
        chunks = getattr(self, "_snapshots", {}).get(height)
        if chunks is None or fmt != 1 or not 0 <= chunk < len(chunks):
            return b""
        return chunks[chunk]

    def apply_snapshot_chunk(self, index, chunk, sender):
        r = getattr(self, "_restore", None)
        if r is None or not 0 <= index < len(r["chunks"]):
            return False
        r["chunks"][index] = chunk
        if any(c is None for c in r["chunks"]):
            return True
        blob = b"".join(r["chunks"])
        if hashlib.sha256(blob).digest() != r["snapshot"].hash:
            # the hash covers the WHOLE snapshot, so the bad chunk can't
            # be identified — ask the engine to refetch everything and
            # keep the restore session open (RETRY_SNAPSHOT semantics)
            n = len(r["chunks"])
            r["chunks"] = [None] * n
            return abci.ResponseApplySnapshotChunk(
                result=abci.APPLY_CHUNK_RETRY_SNAPSHOT,
                refetch_chunks=list(range(n)),
            )
        doc = json.loads(blob.decode())
        self.state = {bytes.fromhex(k): bytes.fromhex(v)
                      for k, v in doc["state"].items()}
        self.height = doc["height"]
        self.app_hash = bytes.fromhex(doc["app_hash"])
        self.staged = dict(self.state)
        self._committed = (dict(self.state), self.height)
        self._restore = None
        return True
