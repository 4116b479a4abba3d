"""CometBFT's canonical vote sign-bytes: the bytes a validator signs.

A frozen copy of the encoding in cometbft_tpu_torch/types/canonical.py
(`canonical_vote_bytes`) and cometbft_tpu_torch/libs/protoenc.py at commit
11dbd9c1db08fa78cfd421f2794b4ad265f950b7, after CometBFT's
types/canonical.go and proto/tendermint/types/canonical.proto:

    CanonicalVote { type 1 varint, height 2 sfixed64, round 3 sfixed64,
                    block_id 4 CanonicalBlockID, timestamp 5 Timestamp,
                    chain_id 6 string }

proto3 rules (zero scalars and empty bytes left out, the timestamp always
present), framed with a varint length (libs/protoio MarshalDelimited).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

PRECOMMIT_TYPE = 2


def uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return uvarint((field << 3) | wire)


def _f_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + uvarint(v & 0xFFFFFFFFFFFFFFFF) if v else b""


def _f_sfixed64(field: int, v: int) -> bytes:
    if not v:
        return b""
    return _tag(field, 1) + (v & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")


def _f_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + uvarint(len(v)) + v if v else b""


def _f_msg(field: int, body: bytes) -> bytes:
    return _tag(field, 2) + uvarint(len(body)) + body


def block_id_body(block_hash: bytes, psh_total: int,
                  psh_hash: bytes) -> bytes:
    """CanonicalBlockID { hash 1, part_set_header 2 {total 1, hash 2} }."""
    psh = _f_varint(1, psh_total) + _f_bytes(2, psh_hash)
    return _f_bytes(1, block_hash) + _f_msg(2, psh)


def vote_sign_bytes(chain_id: str, vote_type: int, height: int, round_: int,
                    block_id: Optional[tuple], secs: int,
                    nanos: int) -> bytes:
    """The length-prefixed CanonicalVote. `block_id` is (hash, part set
    total, part set hash), or None for a vote for nil."""
    body = _f_varint(1, vote_type) + _f_sfixed64(2, height)
    body += _f_sfixed64(3, round_)
    if block_id is not None:
        body += _f_msg(4, block_id_body(*block_id))
    body += _f_msg(5, _f_varint(1, secs) + _f_varint(2, nanos))
    body += _f_bytes(6, chain_id.encode())
    return uvarint(len(body)) + body


def precommit_rows(chain_id: str, height: int, round_: int,
                   block_id: tuple, secs: Sequence[int],
                   nanos: Sequence[int]) -> List[bytes]:
    """Sign-bytes of many for-block precommits of one height that differ
    only in their timestamps: the invariant fields are encoded once.
    Equal, row for row, to `vote_sign_bytes`."""
    pre = _f_varint(1, PRECOMMIT_TYPE) + _f_sfixed64(2, height)
    pre += _f_sfixed64(3, round_) + _f_msg(4, block_id_body(*block_id))
    suf = _f_bytes(6, chain_id.encode())
    out = []
    for s, n in zip(secs, nanos):
        body = pre + _f_msg(5, _f_varint(1, s) + _f_varint(2, n)) + suf
        out.append(uvarint(len(body)) + body)
    return out
