"""Protobuf-style varints (LEB128) + zigzag signed variant."""

from __future__ import annotations


def encode_uvarint(n: int) -> bytes:
    if n < 0:
        raise ValueError("uvarint cannot encode negative")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_uvarint(data: bytes, offset: int = 0) -> tuple[int, int]:
    """Returns (value, new_offset)."""
    result = 0
    shift = 0
    pos = offset
    while True:
        if pos >= len(data):
            raise ValueError("truncated uvarint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("uvarint too long")


async def decode_uvarint_stream(reader) -> int:
    """Read one uvarint from an asyncio.StreamReader (socket framing)."""
    result = 0
    shift = 0
    while True:
        b = (await reader.readexactly(1))[0]
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result
        shift += 7
        if shift > 70:
            raise ValueError("uvarint too long")


def encode_svarint(n: int) -> bytes:
    # zigzag
    return encode_uvarint((n << 1) ^ (n >> 63) if n < 0 else n << 1)


def decode_svarint(data: bytes, offset: int = 0) -> tuple[int, int]:
    u, pos = decode_uvarint(data, offset)
    return (u >> 1) ^ -(u & 1), pos
