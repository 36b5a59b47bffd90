"""A standard-library subset of msgpack: the formats the codec writes.

`packb(obj, default)` writes exactly the bytes
`msgpack.packb(obj, default=default, use_bin_type=True)` writes, and
`unpackb(data, object_hook)` reads them back as
`msgpack.unpackb(data, object_hook=..., raw=False, strict_map_key=False)`
does, with lists for arrays.  Covered: nil, bool, ints in their smallest
form (positive and negative fixint, u/int 8-64), float64 (float32 is read),
bin 8/16/32, str fix/8/16/32, array fix/16/32 (tuples too) and map
fix/16/32.  Ext types are not.

Both sides work on one buffer: the packer appends to a single bytearray,
the unpacker reads by offset from the input with struct.unpack_from.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Optional

_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")
_BH = struct.Struct(">BH")
_BI = struct.Struct(">BI")
_BQ = struct.Struct(">BQ")
_Bb = struct.Struct(">Bb")
_Bh = struct.Struct(">Bh")
_Bi = struct.Struct(">Bi")
_Bq = struct.Struct(">Bq")
_Bd = struct.Struct(">Bd")

_MAX_LEN = 0xFFFFFFFF


class ExtraData(ValueError):
    """Bytes left over after one complete object."""


def _pack_int(n: int, buf: bytearray) -> None:
    if n >= 0:
        if n < 0x80:
            buf.append(n)
        elif n <= 0xFF:
            buf += b"\xcc" + bytes((n,))
        elif n <= 0xFFFF:
            buf += _BH.pack(0xCD, n)
        elif n <= 0xFFFFFFFF:
            buf += _BI.pack(0xCE, n)
        elif n <= 0xFFFFFFFFFFFFFFFF:
            buf += _BQ.pack(0xCF, n)
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -32:
        buf.append(n & 0xFF)
    elif n >= -0x80:
        buf += _Bb.pack(0xD0, n)
    elif n >= -0x8000:
        buf += _Bh.pack(0xD1, n)
    elif n >= -0x80000000:
        buf += _Bi.pack(0xD2, n)
    elif n >= -0x8000000000000000:
        buf += _Bq.pack(0xD3, n)
    else:
        raise OverflowError("Integer value out of range")


def _pack_bin(b, buf: bytearray) -> None:
    n = len(b)
    if n <= 0xFF:
        buf += b"\xc4" + bytes((n,))
    elif n <= 0xFFFF:
        buf += _BH.pack(0xC5, n)
    elif n <= _MAX_LEN:
        buf += _BI.pack(0xC6, n)
    else:
        raise ValueError("Bytes is too large")
    buf += b


def _pack_str(s: str, buf: bytearray) -> None:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        buf.append(0xA0 | n)
    elif n <= 0xFF:
        buf += b"\xd9" + bytes((n,))
    elif n <= 0xFFFF:
        buf += _BH.pack(0xDA, n)
    elif n <= _MAX_LEN:
        buf += _BI.pack(0xDB, n)
    else:
        raise ValueError("String is too large")
    buf += b


def _pack_header(n: int, fix: int, c16: int, c32: int, buf: bytearray) -> None:
    if n < 16:
        buf.append(fix | n)
    elif n <= 0xFFFF:
        buf += _BH.pack(c16, n)
    elif n <= _MAX_LEN:
        buf += _BI.pack(c32, n)
    else:
        raise ValueError("list is too large" if fix == 0x90 else "dict is too large")


def _pack(obj: Any, buf: bytearray, default: Optional[Callable]) -> None:
    """msgpack's Packer._pack order: exact types first (the common case),
    then the isinstance chain it uses for subclasses, then `default` once."""
    default_used = False
    while True:
        t = type(obj)
        if t is str:
            return _pack_str(obj, buf)
        if t is bytes:
            return _pack_bin(obj, buf)
        if t is int:
            return _pack_int(obj, buf)
        if t is dict:
            _pack_header(len(obj), 0x80, 0xDE, 0xDF, buf)
            for k, v in obj.items():
                if type(k) is str:
                    _pack_str(k, buf)
                else:
                    _pack(k, buf, default)
                _pack(v, buf, default)
            return
        if t is list or t is tuple:
            _pack_header(len(obj), 0x90, 0xDC, 0xDD, buf)
            for v in obj:
                _pack(v, buf, default)
            return
        if obj is None:
            buf.append(0xC0)
            return
        if isinstance(obj, bool):
            buf.append(0xC3 if obj else 0xC2)
            return
        if isinstance(obj, int):
            return _pack_int(int(obj), buf)
        if isinstance(obj, (bytes, bytearray)):
            return _pack_bin(obj, buf)
        if isinstance(obj, str):
            return _pack_str(str(obj), buf)
        if isinstance(obj, memoryview):
            return _pack_bin(obj.tobytes(), buf)
        if isinstance(obj, float):
            buf += _Bd.pack(0xCB, obj)
            return
        if isinstance(obj, (list, tuple)):
            _pack_header(len(obj), 0x90, 0xDC, 0xDD, buf)
            for v in obj:
                _pack(v, buf, default)
            return
        if isinstance(obj, dict):
            _pack_header(len(obj), 0x80, 0xDE, 0xDF, buf)
            for k, v in obj.items():
                _pack(k, buf, default)
                _pack(v, buf, default)
            return
        if not default_used and default is not None:
            obj = default(obj)
            default_used = True
            continue
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any, default: Optional[Callable] = None) -> bytes:
    buf = bytearray()
    _pack(obj, buf, default)
    return bytes(buf)


def _truncated() -> ValueError:
    return ValueError("msgpack: truncated data")


def _unpack(data: bytes, pos: int, hook: Optional[Callable]):
    """-> (object, next offset)."""
    try:
        c = data[pos]
    except IndexError:
        raise _truncated() from None
    pos += 1
    if c <= 0x7F:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c <= 0xBF:
        n = c & 0x1F
        return _str(data, pos, n)
    if 0x90 <= c <= 0x9F:
        return _array(data, pos, c & 0x0F, hook)
    if 0x80 <= c <= 0x8F:
        return _map(data, pos, c & 0x0F, hook)
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    try:
        if c == 0xC4:
            return _bin(data, pos + 1, data[pos])
        if c == 0xC5:
            return _bin(data, pos + 2, _H.unpack_from(data, pos)[0])
        if c == 0xC6:
            return _bin(data, pos + 4, _I.unpack_from(data, pos)[0])
        if c == 0xCC:
            return data[pos], pos + 1
        if c == 0xCD:
            return _H.unpack_from(data, pos)[0], pos + 2
        if c == 0xCE:
            return _I.unpack_from(data, pos)[0], pos + 4
        if c == 0xCF:
            return _Q.unpack_from(data, pos)[0], pos + 8
        if c == 0xD0:
            return _b.unpack_from(data, pos)[0], pos + 1
        if c == 0xD1:
            return _h.unpack_from(data, pos)[0], pos + 2
        if c == 0xD2:
            return _i.unpack_from(data, pos)[0], pos + 4
        if c == 0xD3:
            return _q.unpack_from(data, pos)[0], pos + 8
        if c == 0xCB:
            return _d.unpack_from(data, pos)[0], pos + 8
        if c == 0xCA:
            return _f.unpack_from(data, pos)[0], pos + 4
        if c == 0xD9:
            return _str(data, pos + 1, data[pos])
        if c == 0xDA:
            return _str(data, pos + 2, _H.unpack_from(data, pos)[0])
        if c == 0xDB:
            return _str(data, pos + 4, _I.unpack_from(data, pos)[0])
        if c == 0xDC:
            return _array(data, pos + 2, _H.unpack_from(data, pos)[0], hook)
        if c == 0xDD:
            return _array(data, pos + 4, _I.unpack_from(data, pos)[0], hook)
        if c == 0xDE:
            return _map(data, pos + 2, _H.unpack_from(data, pos)[0], hook)
        if c == 0xDF:
            return _map(data, pos + 4, _I.unpack_from(data, pos)[0], hook)
    except (struct.error, IndexError):
        raise _truncated() from None
    raise ValueError(f"msgpack: unsupported type byte 0x{c:02x}")


def _bin(data: bytes, pos: int, n: int):
    end = pos + n
    if end > len(data):
        raise _truncated()
    return bytes(data[pos:end]), end


def _str(data: bytes, pos: int, n: int):
    end = pos + n
    if end > len(data):
        raise _truncated()
    return str(data[pos:end], "utf-8"), end


def _array(data: bytes, pos: int, n: int, hook):
    out = []
    append = out.append
    for _ in range(n):
        v, pos = _unpack(data, pos, hook)
        append(v)
    return out, pos


def _map(data: bytes, pos: int, n: int, hook):
    d = {}
    for _ in range(n):
        k, pos = _unpack(data, pos, hook)
        d[k], pos = _unpack(data, pos, hook)
    return (hook(d) if hook is not None else d), pos


def unpackb(data, object_hook: Optional[Callable] = None) -> Any:
    if not isinstance(data, bytes):
        data = bytes(data)
    obj, pos = _unpack(data, 0, object_hook)
    if pos != len(data):
        raise ExtraData(f"msgpack: {len(data) - pos} bytes of extra data")
    return obj
