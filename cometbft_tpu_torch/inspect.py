"""Inspect: a read-only RPC server over the data directories of a
stopped (possibly crashed) node.

Reference: inspect/inspect.go — serves the RPC route subset that only
needs the stores (status, block*, blockchain, commit, validators,
tx/tx_search, block_search) so an operator can examine a dead node's
chain state without starting consensus.

The port's copy of the JAX package's inspect.py.
"""
from __future__ import annotations

import os
from typing import Optional

from cometbft_tpu_torch.rpc.server import RPCError, RPCServer
from cometbft_tpu_torch.state.indexer import BlockIndexer, TxIndexer
from cometbft_tpu_torch.state.state import StateStore
from cometbft_tpu_torch.store.blockstore import BlockStore
from cometbft_tpu_torch.types.event_bus import EventBus


class _ConsensusShim:
    def __init__(self, state):
        self.state = state
        self.privval = None

    def is_running(self):
        return False


class _InspectNode:
    """Just enough of the Node surface for rpc.server.Routes, backed by
    the on-disk stores; every mutating route is refused."""

    def __init__(self, data_dir: str):
        self.block_store = BlockStore(
            os.path.join(data_dir, "blockstore.db"))
        self.state_store = StateStore(os.path.join(data_dir, "state.db"))
        self.tx_indexer = TxIndexer(os.path.join(data_dir, "tx_index.db"))
        self.block_indexer = BlockIndexer(
            os.path.join(data_dir, "block_index.db"))
        state = self.state_store.load()
        if state is None:
            raise RuntimeError(f"no persisted state under {data_dir}")
        self.consensus = _ConsensusShim(state)
        self.event_bus = EventBus()
        self.switch = None
        self.blocksync_engine = None
        self.mempool = None
        self.app_conns = None
        self.metrics = None
        self.controller = None

    def broadcast_tx(self, tx: bytes):
        raise RPCError(-32601, "inspect server is read-only")

    def close(self) -> None:
        for s in (self.block_store, self.state_store, self.tx_indexer,
                  self.block_indexer):
            close = getattr(s, "close", None)
            if close:
                close()


class InspectServer:
    """inspect.New: RPC server over the stores, nothing else running."""

    def __init__(self, data_dir: str, host: str = "127.0.0.1",
                 port: int = 0):
        self.node = _InspectNode(data_dir)
        self.rpc = RPCServer(self.node, host=host, port=port)

    @property
    def address(self) -> str:
        return self.rpc.address

    def start(self) -> None:
        self.rpc.start()

    def stop(self) -> None:
        self.rpc.stop()
        self.node.close()
