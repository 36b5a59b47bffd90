"""Proto3-style field encoding helpers for canonical (signed/hashed) bytes.

These build the deterministic byte layouts used for sign-bytes and merkle
leaves, mirroring the wire shapes amino produced for the reference's
CanonicalVote / SimpleProof leaves (reference: types/canonical.go,
crypto/merkle/simple_tree.go) without pulling in a codegen toolchain.

Wire types: 0=varint, 1=fixed64, 2=length-delimited.
Proto3 semantics: zero values are omitted by the canonical encoders.
"""

from __future__ import annotations

import struct

from .varint import encode_uvarint


def _tag(field_num: int, wire_type: int) -> bytes:
    return encode_uvarint((field_num << 3) | wire_type)


def field_varint(field_num: int, value: int, *, emit_zero: bool = False) -> bytes:
    if value == 0 and not emit_zero:
        return b""
    if value < 0:
        # proto3 int64: two's-complement 10-byte varint
        value &= (1 << 64) - 1
    return _tag(field_num, 0) + encode_uvarint(value)


def field_fixed64(field_num: int, value: int, *, emit_zero: bool = False) -> bytes:
    if value == 0 and not emit_zero:
        return b""
    return _tag(field_num, 1) + struct.pack("<Q", value & ((1 << 64) - 1))


def field_bytes(field_num: int, value: bytes | str, *, emit_zero: bool = False) -> bytes:
    if isinstance(value, str):
        value = value.encode()
    if not value and not emit_zero:
        return b""
    return _tag(field_num, 2) + encode_uvarint(len(value)) + value


def field_time(field_num: int, unix_ns: int) -> bytes:
    """Embedded google.protobuf.Timestamp-style message {1: seconds, 2: nanos}."""
    secs, nanos = divmod(unix_ns, 1_000_000_000)
    inner = field_varint(1, secs) + field_varint(2, nanos)
    return _tag(field_num, 2) + encode_uvarint(len(inner)) + inner


def length_prefixed(payload: bytes) -> bytes:
    """Varint length prefix — the framing amino used for sign-bytes
    (reference types/vote.go:87 SignBytes via MarshalBinaryLengthPrefixed)."""
    return encode_uvarint(len(payload)) + payload
