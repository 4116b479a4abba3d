"""Minimal deterministic protobuf wire encoder.

The consensus-critical encodings (CanonicalVote sign-bytes, SimpleValidator
hash input, Timestamp) must be byte-identical to the reference's gogoproto
output (reference: proto/tendermint/types/canonical.pb.go
MarshalToSizedBuffer, libs/protoio MarshalDelimited). This module provides
just the wire primitives those encodings need — proto3 rules, fields in
ascending tag order, zero-default scalars omitted.

A hand-rolled encoder instead of a protobuf dependency on purpose: the
byte layout IS the consensus rule; hiding it behind a codegen layer makes
divergence (map ordering, unknown-field retention, nullability quirks)
harder to audit. ~40 lines cover everything CometBFT signs.
"""
from __future__ import annotations

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_BYTES = 2


def uvarint(v: int) -> bytes:
    """Unsigned LEB128 varint."""
    assert v >= 0
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def varint(v: int) -> bytes:
    """proto int64/int32/enum varint: negatives as 64-bit two's complement
    (10 bytes) — gogoproto encodeVarint(uint64(v)) semantics."""
    return uvarint(v & 0xFFFFFFFFFFFFFFFF)


def tag(field: int, wire: int) -> bytes:
    return uvarint((field << 3) | wire)


def f_varint(field: int, v: int, omit_zero: bool = True) -> bytes:
    if v == 0 and omit_zero:
        return b""
    return tag(field, WIRE_VARINT) + varint(v)


def f_sfixed64(field: int, v: int, omit_zero: bool = True) -> bytes:
    if v == 0 and omit_zero:
        return b""
    return tag(field, WIRE_FIXED64) + (v & 0xFFFFFFFFFFFFFFFF).to_bytes(
        8, "little"
    )


def f_bytes(field: int, v: bytes, omit_empty: bool = True) -> bytes:
    if not v and omit_empty:
        return b""
    return tag(field, WIRE_BYTES) + uvarint(len(v)) + v


def f_msg(field: int, body: bytes, omit_empty: bool = False) -> bytes:
    """Embedded message. proto3 emits present-but-empty messages as len-0;
    gogoproto non-nullable fields are always present (omit_empty=False)."""
    if not body and omit_empty:
        return b""
    return tag(field, WIRE_BYTES) + uvarint(len(body)) + body


def delimited(body: bytes) -> bytes:
    """varint length-prefix framing (libs/protoio MarshalDelimited)."""
    return uvarint(len(body)) + body


def timestamp(seconds: int, nanos: int) -> bytes:
    """google.protobuf.Timestamp body (seconds field 1, nanos field 2)."""
    return f_varint(1, seconds) + f_varint(2, nanos)
