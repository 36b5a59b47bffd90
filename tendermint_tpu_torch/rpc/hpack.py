"""HPACK (RFC 7541): the header compression of HTTP/2, under rpc/http2.py.
The JAX package's gRPC runs on grpcio, whose C core carries its own; the
card's machine is not promised grpcio, so the port keeps this copy.

The decoder reads all of RFC 7541: the static table, the dynamic table with
its size updates and evictions, integers of any prefix, string literals
raw or Huffman-coded (Appendix B), and the four field representations.
grpcio's C core sends Huffman-coded, incrementally indexed fields, and a
second call on one connection mostly indexes the first call's entries.

The encoder indexes: a field the static or dynamic table holds whole is
sent as its index, any other as a literal with incremental indexing (its
name indexed where a table holds the name), which is how the examples of
Appendix C encode.  `huffman=True` codes every string with Appendix B's
code.  A field given as a 3-tuple `(name, value, "no")` or `(..., "never")`
is sent as a literal without indexing or never indexed.

Names and values are str; their bytes are UTF-8 with surrogateescape, so
any byte string a peer sends decodes and re-encodes to the same bytes.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Sequence, Tuple

Header = Tuple[str, str]

STATIC_TABLE: Tuple[Header, ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"),
    (":status", "200"), (":status", "204"), (":status", "206"), (":status", "304"),
    (":status", "400"), (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""), ("cookie", ""),
    ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""), ("location", ""),
    ("max-forwards", ""), ("proxy-authenticate", ""), ("proxy-authorization", ""),
    ("range", ""), ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""),
)
STATIC_LEN = len(STATIC_TABLE)  # 61
ENTRY_OVERHEAD = 32  # RFC 7541 4.1
DEFAULT_TABLE_SIZE = 4096

# Appendix B: the code length of each of the 256 octets and EOS (256).  The
# codes are the canonical Huffman code of these lengths (symbols ordered by
# length, then value), which is what Appendix B lists.
HUFFMAN_LENGTHS: Tuple[int, ...] = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    30,
)
EOS = 256


class HPACKError(ValueError):
    """A malformed header block: the connection's COMPRESSION_ERROR."""


def _canonical_codes(lengths: Sequence[int]) -> List[int]:
    codes = [0] * len(lengths)
    code, prev = 0, 0
    for sym in sorted(range(len(lengths)), key=lambda s: (lengths[s], s)):
        code <<= lengths[sym] - prev
        prev = lengths[sym]
        codes[sym] = code
        code += 1
    return codes


HUFFMAN_CODES: Tuple[int, ...] = tuple(_canonical_codes(HUFFMAN_LENGTHS))


def _decoding_tables():
    """Per code length L: (L, first code, one past the last code, offset of
    its symbols in `order`), for the lengths in use, ascending; and the
    symbols ordered by (length, value)."""
    order = sorted(range(len(HUFFMAN_LENGTHS)), key=lambda s: (HUFFMAN_LENGTHS[s], s))
    rows, i = [], 0
    for length in sorted(set(HUFFMAN_LENGTHS)):
        n = HUFFMAN_LENGTHS.count(length)
        first = HUFFMAN_CODES[order[i]]
        rows.append((length, first, first + n, i))
        i += n
    return tuple(rows), tuple(order)


_ROWS, _ORDER = _decoding_tables()


def huffman_encode(data: bytes) -> bytes:
    acc, nbits = 0, 0
    for b in data:
        acc = (acc << HUFFMAN_LENGTHS[b]) | HUFFMAN_CODES[b]
        nbits += HUFFMAN_LENGTHS[b]
    pad = -nbits % 8  # the most significant bits of EOS: all ones
    acc = (acc << pad) | ((1 << pad) - 1)
    return acc.to_bytes((nbits + pad) // 8, "big")


def huffman_decode(data: bytes) -> bytes:
    """Appendix B's code, canonical decoding: at each position the shortest
    length L whose top-L-bit value lies below that length's last code.
    Padding must be fewer than 8 bits, all ones (RFC 7541 5.2); an EOS in
    the string is an error."""
    left = len(data) * 8
    value = int.from_bytes(data, "big")
    out = bytearray()
    while left:
        sym = None
        for length, first, end, offset in _ROWS:
            if length > left:
                break
            code = (value >> (left - length)) & ((1 << length) - 1)
            if code < end:
                sym = _ORDER[offset + code - first]
                break
        if sym is None:  # no code fits what is left: it must be padding
            if left > 7 or value & ((1 << left) - 1) != (1 << left) - 1:
                raise HPACKError("invalid Huffman padding")
            break
        if sym == EOS:
            raise HPACKError("EOS in a Huffman-coded string")
        out.append(sym)
        left -= length
    return bytes(out)


def encode_int(value: int, prefix_bits: int, first: int = 0) -> bytes:
    """RFC 7541 5.1: `value` on an N-bit prefix, `first` the bits above it."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    """(value, the position after it)."""
    if pos >= len(data):
        raise HPACKError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HPACKError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 63:
            raise HPACKError("integer overflow")


def _bytes(s: str) -> bytes:
    return s.encode("utf-8", "surrogateescape")


def _str(b: bytes) -> str:
    return b.decode("utf-8", "surrogateescape")


def entry_size(name: str, value: str) -> int:
    return len(_bytes(name)) + len(_bytes(value)) + ENTRY_OVERHEAD


class _DynamicTable:
    """Newest entry first (index STATIC_LEN + 1), evicted from the oldest."""

    def __init__(self, max_size: int):
        self.entries: deque = deque()
        self.size = 0
        self.max_size = max_size

    def add(self, name: str, value: str) -> None:
        size = entry_size(name, value)
        if size > self.max_size:  # RFC 7541 4.4: empties the table
            self.entries.clear()
            self.size = 0
            return
        self.entries.appendleft((name, value, size))
        self.size += size
        self._evict()

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        self._evict()

    def _evict(self) -> None:
        while self.size > self.max_size:
            self.size -= self.entries.pop()[2]

    def get(self, index: int) -> Header:
        """A 1-based index over the static then the dynamic table."""
        if 1 <= index <= STATIC_LEN:
            return STATIC_TABLE[index - 1]
        i = index - STATIC_LEN - 1
        if index < 1 or i >= len(self.entries):
            raise HPACKError(f"header index {index} out of range")
        name, value, _ = self.entries[i]
        return name, value


class Decoder:
    """One connection's decoder of header blocks from the peer.
    `max_table_size` is what our SETTINGS_HEADER_TABLE_SIZE allows."""

    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE):
        self.table = _DynamicTable(max_table_size)
        self.max_allowed = max_table_size

    def _string(self, data: bytes, pos: int) -> Tuple[str, int]:
        if pos >= len(data):
            raise HPACKError("truncated string")
        huffman = data[pos] & 0x80
        length, pos = decode_int(data, pos, 7)
        end = pos + length
        if end > len(data):
            raise HPACKError("truncated string")
        raw = data[pos:end]
        return _str(huffman_decode(raw) if huffman else raw), end

    def decode(self, data: bytes) -> List[Header]:
        headers: List[Header] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # 6.1 indexed field
                index, pos = decode_int(data, pos, 7)
                if index == 0:
                    raise HPACKError("header index 0")
                headers.append(self.table.get(index))
                continue
            if b & 0xE0 == 0x20:  # 6.3 dynamic table size update
                if headers:
                    raise HPACKError("table size update after the first field")
                size, pos = decode_int(data, pos, 5)
                if size > self.max_allowed:
                    raise HPACKError(f"table size {size} over the allowed {self.max_allowed}")
                self.table.resize(size)
                continue
            if b & 0x40:  # 6.2.1 literal with incremental indexing
                index, pos = decode_int(data, pos, 6)
                indexing = True
            else:  # 6.2.2 without indexing, 6.2.3 never indexed
                index, pos = decode_int(data, pos, 4)
                indexing = False
            if index:
                name = self.table.get(index)[0]
            else:
                name, pos = self._string(data, pos)
            value, pos = self._string(data, pos)
            headers.append((name, value))
            if indexing:
                self.table.add(name, value)
        return headers


class Encoder:
    """One connection's encoder of header blocks to the peer (see the
    module doc).  `set_max_table_size` follows the peer's
    SETTINGS_HEADER_TABLE_SIZE: the change is signalled at the start of the
    next block (RFC 7541 4.2)."""

    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE, huffman: bool = False):
        self.table = _DynamicTable(max_table_size)
        self.huffman = huffman
        self._pending: List[int] = []
        self._static_full: Dict[Header, int] = {}
        self._static_name: Dict[str, int] = {}
        for i, (name, value) in enumerate(STATIC_TABLE, 1):
            self._static_full.setdefault((name, value), i)
            self._static_name.setdefault(name, i)

    def set_max_table_size(self, size: int) -> None:
        if size != self.table.max_size or self._pending:
            self._pending.append(size)
            self.table.resize(size)

    def _string(self, s: str) -> bytes:
        raw = _bytes(s)
        if self.huffman:
            coded = huffman_encode(raw)
            return encode_int(len(coded), 7, 0x80) + coded
        return encode_int(len(raw), 7) + raw

    def _find(self, name: str, value: str) -> Tuple[int, int]:
        """(index of the whole field or 0, index of its name or 0)."""
        full = self._static_full.get((name, value), 0)
        if full:
            return full, full
        name_index = self._static_name.get(name, 0)
        for i, (n, v, _) in enumerate(self.table.entries, STATIC_LEN + 1):
            if n == name:
                if v == value:
                    return i, i
                name_index = name_index or i
        return 0, name_index

    def encode(self, headers: Iterable) -> bytes:
        out = bytearray()
        if self._pending:  # the smallest size, then the last (RFC 7541 4.2)
            low, last = min(self._pending), self._pending[-1]
            for size in ((low, last) if low < last else (last,)):
                out += encode_int(size, 5, 0x20)
            self._pending.clear()
        for field in headers:
            name, value = field[0], field[1]
            mode = field[2] if len(field) > 2 else "index"
            full, name_index = self._find(name, value)
            if full and mode == "index":
                out += encode_int(full, 7, 0x80)
                continue
            if mode == "index":
                out += encode_int(name_index, 6, 0x40)
            else:
                out += encode_int(name_index, 4, 0x10 if mode == "never" else 0x00)
            if not name_index:
                out += self._string(name)
            out += self._string(value)
            if mode == "index":
                self.table.add(name, value)
        return bytes(out)

