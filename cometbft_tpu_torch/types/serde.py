"""JSON serde for stored consensus objects (blocks, commits, votes, state).

Storage-internal format (hex-encoded bytes, explicit type tags) — the
cross-node wire format is the proto encoding in types/block.py; these
helpers serve the block/state stores and the WAL, where the reference
uses its own proto envelopes (store/store.go, consensus/wal.go). JSON
keeps crash forensics trivial (`sqlite3 ... | python -m json.tool`).

The port's copy of the JAX package's types/serde.py.
"""
from __future__ import annotations

import json
from typing import Optional

from cometbft_tpu_torch.types.block import Block, Data, Header
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.commit import Commit, CommitSig
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.vote import Vote


def ts_to_j(t: Timestamp):
    return [t.seconds, t.nanos]


def ts_from_j(j) -> Timestamp:
    return Timestamp(j[0], j[1])


def bid_to_j(b: BlockID):
    return {
        "hash": b.hash.hex(),
        "total": b.part_set_header.total,
        "psh": b.part_set_header.hash.hex(),
    }


def bid_from_j(j) -> BlockID:
    return BlockID(
        bytes.fromhex(j["hash"]),
        PartSetHeader(j["total"], bytes.fromhex(j["psh"])),
    )


def commit_sig_to_j(cs: CommitSig):
    return {
        "flag": cs.flag,
        "addr": cs.validator_address.hex(),
        "ts": ts_to_j(cs.timestamp),
        "sig": cs.signature.hex(),
    }


def commit_sig_from_j(j) -> CommitSig:
    return CommitSig(
        j["flag"], bytes.fromhex(j["addr"]), ts_from_j(j["ts"]),
        bytes.fromhex(j["sig"]),
    )


def commit_to_j(c: Optional[Commit]):
    if c is None:
        return None
    return {
        "height": c.height,
        "round": c.round,
        "block_id": bid_to_j(c.block_id),
        "sigs": [commit_sig_to_j(s) for s in c.signatures],
    }


def commit_from_j(j) -> Optional[Commit]:
    if j is None:
        return None
    return Commit(
        j["height"], j["round"], bid_from_j(j["block_id"]),
        [commit_sig_from_j(s) for s in j["sigs"]],
    )


def extcommit_to_j(c):
    """ExtendedCommit wire/storage form (store.go:254 persistence)."""
    if c is None:
        return None
    return {
        "height": c.height,
        "round": c.round,
        "block_id": bid_to_j(c.block_id),
        "sigs": [
            {
                "cs": commit_sig_to_j(e.commit_sig),
                "ext": e.extension.hex(),
                "ext_sig": e.extension_signature.hex(),
            }
            for e in c.extended_signatures
        ],
    }


def extcommit_from_j(j):
    from cometbft_tpu_torch.types.commit import (
        ExtendedCommit,
        ExtendedCommitSig,
    )

    if j is None:
        return None
    return ExtendedCommit(
        j["height"], j["round"], bid_from_j(j["block_id"]),
        [
            ExtendedCommitSig(
                commit_sig_from_j(e["cs"]),
                bytes.fromhex(e["ext"]),
                bytes.fromhex(e["ext_sig"]),
            )
            for e in j["sigs"]
        ],
    )


def header_to_j(h: Header):
    return {
        "chain_id": h.chain_id,
        "height": h.height,
        "time": ts_to_j(h.time),
        "last_block_id": bid_to_j(h.last_block_id),
        "last_commit_hash": h.last_commit_hash.hex(),
        "data_hash": h.data_hash.hex(),
        "validators_hash": h.validators_hash.hex(),
        "next_validators_hash": h.next_validators_hash.hex(),
        "consensus_hash": h.consensus_hash.hex(),
        "app_hash": h.app_hash.hex(),
        "last_results_hash": h.last_results_hash.hex(),
        "evidence_hash": h.evidence_hash.hex(),
        "proposer_address": h.proposer_address.hex(),
        "vb": h.version_block,
        "va": h.version_app,
    }


def header_from_j(j) -> Header:
    return Header(
        chain_id=j["chain_id"],
        height=j["height"],
        time=ts_from_j(j["time"]),
        last_block_id=bid_from_j(j["last_block_id"]),
        last_commit_hash=bytes.fromhex(j["last_commit_hash"]),
        data_hash=bytes.fromhex(j["data_hash"]),
        validators_hash=bytes.fromhex(j["validators_hash"]),
        next_validators_hash=bytes.fromhex(j["next_validators_hash"]),
        consensus_hash=bytes.fromhex(j["consensus_hash"]),
        app_hash=bytes.fromhex(j["app_hash"]),
        last_results_hash=bytes.fromhex(j["last_results_hash"]),
        evidence_hash=bytes.fromhex(j["evidence_hash"]),
        proposer_address=bytes.fromhex(j["proposer_address"]),
        version_block=j["vb"],
        version_app=j["va"],
    )


def block_to_json(b: Block) -> str:
    from cometbft_tpu_torch.types.evidence import evidence_to_j

    return json.dumps({
        "header": header_to_j(b.header),
        "txs": [t.hex() for t in b.data.txs],
        "last_commit": commit_to_j(b.last_commit),
        "evidence": [evidence_to_j(ev) for ev in b.evidence],
    })


def block_from_json(s: str) -> Block:
    from cometbft_tpu_torch.types.evidence import evidence_from_j

    j = json.loads(s)
    return Block(
        header=header_from_j(j["header"]),
        data=Data([bytes.fromhex(t) for t in j["txs"]]),
        last_commit=commit_from_j(j["last_commit"]),
        evidence=[evidence_from_j(e) for e in j.get("evidence", [])],
    )


def vote_to_j(v: Vote):
    return {
        "type": v.vote_type,
        "height": v.height,
        "round": v.round,
        "block_id": bid_to_j(v.block_id),
        "ts": ts_to_j(v.timestamp),
        "addr": v.validator_address.hex(),
        "idx": v.validator_index,
        "sig": v.signature.hex(),
        "ext": v.extension.hex(),
        "ext_sig": v.extension_signature.hex(),
    }


def vote_from_j(j) -> Vote:
    return Vote(
        vote_type=j["type"], height=j["height"], round=j["round"],
        block_id=bid_from_j(j["block_id"]), timestamp=ts_from_j(j["ts"]),
        validator_address=bytes.fromhex(j["addr"]),
        validator_index=j["idx"], signature=bytes.fromhex(j["sig"]),
        extension=bytes.fromhex(j["ext"]),
        extension_signature=bytes.fromhex(j["ext_sig"]),
    )
