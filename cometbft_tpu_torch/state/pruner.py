"""Pruner: background retention service over block store + indexers.

Reference: state/pruner.go — a service that advances block/state/index
retain heights (driven by the app's ResponseCommit.retain_height or an
operator RPC) and deletes below them in the background.

The port's copy of the JAX package's state/pruner.py.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from cometbft_tpu_torch.libs.service import BaseService


class Pruner(BaseService):
    def __init__(self, block_store, state_store=None, tx_indexer=None,
                 block_indexer=None, interval: float = 10.0,
                 evidence_safe_height=None):
        """evidence_safe_height: callable returning the lowest height
        whose validator set must remain loadable for evidence
        verification (tip - evidence max-age); validator history is
        never pruned past it (the reference caps state pruning
        the same way)."""
        super().__init__("Pruner")
        self.block_store = block_store
        self.state_store = state_store
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.interval = interval
        self.evidence_safe_height = evidence_safe_height
        self._retain_height = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()

    def set_retain_height(self, height: int) -> None:
        """SetApplicationRetainHeight (pruner.go): only advances."""
        with self._lock:
            if height > self._retain_height:
                self._retain_height = height
                self._wake.set()

    def retain_height(self) -> int:
        with self._lock:
            return self._retain_height

    def on_start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="pruner"
        )
        self._thread.start()

    def on_stop(self) -> None:
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=5)

    def prune_once(self) -> int:
        """One pruning pass; returns blocks removed (tests/ops)."""
        rh = self.retain_height()
        if rh <= 0:
            return 0
        removed = self.block_store.prune_blocks(rh)
        if self.tx_indexer is not None:
            self.tx_indexer.prune(rh)
        if self.block_indexer is not None:
            self.block_indexer.prune(rh)
        if self.state_store is not None and \
                hasattr(self.state_store, "prune_validators"):
            vr = rh
            if self.evidence_safe_height is not None:
                vr = min(vr, max(1, self.evidence_safe_height()))
            self.state_store.prune_validators(vr)
        if self.state_store is not None and \
                hasattr(self.state_store, "prune_abci_responses"):
            self.state_store.prune_abci_responses(rh)
        return removed

    def _run(self) -> None:
        while self.is_running():
            self._wake.wait(timeout=self.interval)
            self._wake.clear()
            if not self.is_running():
                return
            try:
                self.prune_once()
            except Exception:  # noqa: BLE001 - stores may close at stop
                if self.is_running():
                    import traceback

                    traceback.print_exc()
