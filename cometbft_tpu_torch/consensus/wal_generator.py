"""WAL generator: produce a real consensus WAL for tests/tools.

Reference: consensus/wal_generator.go:226 (WALGenerateNBlocks — boots a
real node against a kvstore app and copies out the WAL once N blocks
are committed; used by replay and wal2json tooling).

The port's copy of the JAX package's consensus/wal_generator.py. Its
single-validator node runs on `device` ("cpu" for the plain kernels;
None is the card) with no verify plane, or over `verify_plane` when one
is given.
"""
from __future__ import annotations

import os
import shutil
import tempfile


def generate_wal(n_blocks: int, dest_path: str,
                 chain_id: str = "wal-gen-chain",
                 timeout: float = 120.0, device=None,
                 verify_plane=None) -> str:
    """Run a single-validator net for n_blocks; copy its WAL to
    dest_path. Returns dest_path."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.consensus.ticker import TimeoutParams
    from cometbft_tpu_torch.crypto.keys import PrivKey
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.privval.file_pv import FilePV
    from cometbft_tpu_torch.state.state import State
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

    fast = TimeoutParams(propose=0.4, propose_delta=0.1, prevote=0.2,
                         prevote_delta=0.1, precommit=0.2,
                         precommit_delta=0.1, commit=0.01)
    priv = PrivKey.generate(b"\x5a" * 32)
    vals = ValidatorSet([Validator(priv.pub_key(), 10)])
    state = State.make_genesis(chain_id, vals)
    home = tempfile.mkdtemp(prefix="walgen-")
    try:
        node = Node(KVStoreApplication(), state, privval=FilePV(priv),
                    home=home, timeouts=fast, device=device,
                    verify_plane=verify_plane)
        node.start()
        try:
            if not node.consensus.wait_for_height(n_blocks,
                                                  timeout=timeout):
                raise RuntimeError(
                    f"wal generator stalled at {node.height()}"
                )
        finally:
            node.stop()
        os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
        shutil.copyfile(os.path.join(home, "cs.wal"), dest_path)
        return dest_path
    finally:
        shutil.rmtree(home, ignore_errors=True)


def wal_to_json(wal_path: str):
    """wal2json (scripts/wal2json): decode a WAL into dicts."""
    import json

    from cometbft_tpu_torch.consensus import wal as walmod

    out = []
    for rec in walmod.WAL.iter_records(wal_path):
        if rec.kind == walmod.MSG_INFO:
            try:
                out.append({"kind": "msg",
                            "msg": json.loads(rec.data.decode())})
            except Exception:  # noqa: BLE001 - undecodable record
                out.append({"kind": "msg", "raw": rec.data.hex()})
        elif rec.kind == walmod.END_HEIGHT:
            out.append({"kind": "end_height",
                        "height": int.from_bytes(rec.data[:8], "big")})
        else:
            out.append({"kind": str(rec.kind), "raw": rec.data.hex()})
    return out
