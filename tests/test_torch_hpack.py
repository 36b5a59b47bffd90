"""The port's HPACK (tendermint_tpu_torch/rpc/hpack.py) against RFC 7541,
tolerance exact.

- Appendix C's examples: C.2 (each field representation), C.3 and C.4
  (three requests on one connection, without and with Huffman), C.5 and
  C.6 (three responses with a 256-byte table, so entries are evicted):
  each block decodes to the RFC's header list and dynamic table, and the
  encoder writes the RFC's bytes again.
- Appendix B's Huffman code: spot codes, round trips of every octet, and
  the padding and EOS errors of 5.2.
- A hypothesis round trip: sequences of header lists through one encoder
  and one decoder that share their dynamic table, with and without Huffman
  and with literals that are not indexed, under table sizes down to 0.
- A dynamic table size update: signalled at the next block's start (the
  smallest size, then the last), applied by the decoder; one over the
  allowed size, or after a field, is a COMPRESSION_ERROR (HPACKError).
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tendermint_tpu_torch.rpc import hpack


def hx(s: str) -> bytes:
    return bytes.fromhex(s.replace(" ", ""))


REQUESTS = [
    [(":method", "GET"), (":scheme", "http"), (":path", "/"), (":authority", "www.example.com")],
    [(":method", "GET"), (":scheme", "http"), (":path", "/"), (":authority", "www.example.com"),
     ("cache-control", "no-cache")],
    [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
     (":authority", "www.example.com"), ("custom-key", "custom-value")],
]
REQUEST_TABLES = [
    [(":authority", "www.example.com")],
    [("cache-control", "no-cache"), (":authority", "www.example.com")],
    [("custom-key", "custom-value"), ("cache-control", "no-cache"),
     (":authority", "www.example.com")],
]
REQUEST_SIZES = [57, 110, 164]
RESPONSES = [
    [(":status", "302"), ("cache-control", "private"), ("date", "Mon, 21 Oct 2013 20:13:21 GMT"),
     ("location", "https://www.example.com")],
    [(":status", "307"), ("cache-control", "private"), ("date", "Mon, 21 Oct 2013 20:13:21 GMT"),
     ("location", "https://www.example.com")],
    [(":status", "200"), ("cache-control", "private"), ("date", "Mon, 21 Oct 2013 20:13:22 GMT"),
     ("location", "https://www.example.com"), ("content-encoding", "gzip"),
     ("set-cookie", "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1")],
]
RESPONSE_TABLES = [
    [("location", "https://www.example.com"), ("date", "Mon, 21 Oct 2013 20:13:21 GMT"),
     ("cache-control", "private"), (":status", "302")],
    [(":status", "307"), ("location", "https://www.example.com"),
     ("date", "Mon, 21 Oct 2013 20:13:21 GMT"), ("cache-control", "private")],
    [("set-cookie", "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"),
     ("content-encoding", "gzip"), ("date", "Mon, 21 Oct 2013 20:13:22 GMT")],
]
RESPONSE_SIZES = [222, 222, 215]

APPENDIX_C = {
    # C.3: requests without Huffman
    "C.3": (4096, False, REQUESTS, REQUEST_TABLES, REQUEST_SIZES, [
        "8286 8441 0f77 7777 2e65 7861 6d70 6c65 2e63 6f6d",
        "8286 84be 5808 6e6f 2d63 6163 6865",
        "8287 85bf 400a 6375 7374 6f6d 2d6b 6579 0c63 7573 746f 6d2d 7661 6c75 65",
    ]),
    # C.4: the same requests, Huffman-coded
    "C.4": (4096, True, REQUESTS, REQUEST_TABLES, REQUEST_SIZES, [
        "8286 8441 8cf1 e3c2 e5f2 3a6b a0ab 90f4 ff",
        "8286 84be 5886 a8eb 1064 9cbf",
        "8287 85bf 4088 25a8 49e9 5ba9 7d7f 8925 a849 e95b b8e8 b4bf",
    ]),
    # C.5: responses without Huffman, a 256-byte table (evictions)
    "C.5": (256, False, RESPONSES, RESPONSE_TABLES, RESPONSE_SIZES, [
        "4803 3330 3258 0770 7269 7661 7465 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032"
        " 303a 3133 3a32 3120 474d 546e 1768 7474 7073 3a2f 2f77 7777 2e65 7861 6d70 6c65 2e63"
        " 6f6d",
        "4803 3330 37c1 c0bf",
        "88c1 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032 303a 3133 3a32 3220 474d 54c0"
        " 5a04 677a 6970 7738 666f 6f3d 4153 444a 4b48 514b 425a 584f 5157 454f 5049 5541 5851"
        " 5745 4f49 553b 206d 6178 2d61 6765 3d33 3630 303b 2076 6572 7369 6f6e 3d31",
    ]),
    # C.6: the same responses, Huffman-coded
    "C.6": (256, True, RESPONSES, RESPONSE_TABLES, RESPONSE_SIZES, [
        "4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 9504 0b81 66e0 82a6 2d1b"
        " ff6e 919d 29ad 1718 63c7 8f0b 97c8 e9ae 82ae 43d3",
        "4883 640e ffc1 c0bf",
        "88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d 1bff c05a 839b d9ab 77ad"
        " 94e7 821d d7f2 e6c7 b335 dfdf cd5b 3960 d5af 2708 7f36 72c1 ab27 0fb5 291f 9587 3160"
        " 65c0 03ed 4ee5 b106 3d50 07",
    ]),
}


@pytest.mark.parametrize("example", sorted(APPENDIX_C))
def test_appendix_c_sequences_decode_and_reencode(example):
    size, huffman, lists, tables, sizes, blocks = APPENDIX_C[example]
    dec = hpack.Decoder(size)
    enc = hpack.Encoder(size, huffman=huffman)
    for headers, table, table_size, block in zip(lists, tables, sizes, blocks):
        assert dec.decode(hx(block)) == headers
        assert [(n, v) for n, v, _ in dec.table.entries] == table
        assert dec.table.size == table_size
        assert enc.encode(headers) == hx(block)
        assert enc.table.size == table_size


C2 = {
    # C.2.1 literal with indexing, new name; C.2.2 without indexing, indexed
    # name; C.2.3 never indexed, new name; C.2.4 indexed
    "C.2.1": ("400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572",
              ("custom-key", "custom-header"), "index", 55),
    "C.2.2": ("040c 2f73 616d 706c 652f 7061 7468", (":path", "/sample/path"), "no", 0),
    "C.2.3": ("1008 7061 7373 776f 7264 0673 6563 7265 74", ("password", "secret"), "never", 0),
    "C.2.4": ("82", (":method", "GET"), "index", 0),
}


@pytest.mark.parametrize("example", sorted(C2))
def test_appendix_c2_field_representations(example):
    block, field, mode, table_size = C2[example]
    dec = hpack.Decoder()
    assert dec.decode(hx(block)) == [field]
    assert dec.table.size == table_size
    assert hpack.Encoder().encode([field + (mode,)]) == hx(block)


def test_huffman_code_is_appendix_b():
    codes, lengths = hpack.HUFFMAN_CODES, hpack.HUFFMAN_LENGTHS
    # spot codes of Appendix B: '0' 00000, 'a' 00011, ' ' 010100, '{' 11111111 1111110,
    # 0x00 1111111111000, EOS 30 ones
    assert (codes[ord("0")], lengths[ord("0")]) == (0x0, 5)
    assert (codes[ord("a")], lengths[ord("a")]) == (0x3, 5)
    assert (codes[ord(" ")], lengths[ord(" ")]) == (0x14, 6)
    assert (codes[ord("{")], lengths[ord("{")]) == (0x7ffe, 15)
    assert (codes[0], lengths[0]) == (0x1ff8, 13)
    assert (codes[hpack.EOS], lengths[hpack.EOS]) == ((1 << 30) - 1, 30)
    # a complete prefix code: Kraft's sum is exactly 1
    assert sum(2 ** (30 - n) for n in lengths) == 2 ** 30
    every = bytes(range(256)) * 2
    assert hpack.huffman_decode(hpack.huffman_encode(every)) == every
    assert hpack.huffman_encode(b"www.example.com") == hx("f1e3 c2e5 f23a 6ba0 ab90 f4ff")


@pytest.mark.parametrize("data", [
    hx("f1e3 c2e5 f23a 6ba0 ab90 f400"),  # padding of zeros, not EOS's ones
    hx("f1e3 c2e5 f23a 6ba0 ab90 f4ff ff"),  # 8 bits of padding
    hx("ffff fffc"),  # EOS itself
], ids=["zero-padding", "long-padding", "eos"])
def test_huffman_errors(data):
    with pytest.raises(hpack.HPACKError):
        hpack.huffman_decode(data)


def test_table_size_update():
    enc, dec = hpack.Encoder(), hpack.Decoder()
    first = [("grpc-status", "0"), ("x-a", "1")]
    assert dec.decode(enc.encode(first)) == first
    assert dec.table.size == enc.table.size == 2 * 32 + 11 + 1 + 3 + 1
    # the peer's SETTINGS_HEADER_TABLE_SIZE goes to 0 and back to 100 between
    # blocks: the next block starts with both updates, the smallest first
    enc.set_max_table_size(0)
    enc.set_max_table_size(100)
    block = enc.encode(first)
    assert block[:2] == bytes([0x20, 0x3F]) and block[2] == 100 - 31
    assert dec.decode(block) == first
    assert dec.table.max_size == 100 and [(n, v) for n, v, _ in dec.table.entries] == first[::-1]
    # an update over what our SETTINGS allow, or after a field, is refused
    with pytest.raises(hpack.HPACKError):
        hpack.Decoder(4096).decode(hpack.encode_int(4097, 5, 0x20))
    with pytest.raises(hpack.HPACKError):
        hpack.Decoder().decode(bytes([0x82]) + hpack.encode_int(10, 5, 0x20))
    # an index past both tables, and index 0
    with pytest.raises(hpack.HPACKError):
        hpack.Decoder().decode(bytes([0x80 | 62]))
    with pytest.raises(hpack.HPACKError):
        hpack.Decoder().decode(bytes([0x80]))


def test_integer_representation_of_rfc_c1():
    # C.1.1: 10 on a 5-bit prefix; C.1.2: 1337 on 5 bits; C.1.3: 42 on 8 bits
    assert hpack.encode_int(10, 5) == bytes([0x0A])
    assert hpack.encode_int(1337, 5) == bytes([0x1F, 0x9A, 0x0A])
    assert hpack.encode_int(42, 8) == bytes([0x2A])
    assert hpack.decode_int(bytes([0x1F, 0x9A, 0x0A]), 0, 5) == (1337, 3)


_names = st.sampled_from([":path", "content-type", "grpc-status", "grpc-message", "te",
                          "x-custom", "user-agent", ":authority"])
_values = st.text(alphabet=st.characters(min_codepoint=32, max_codepoint=0x2FF), max_size=40)
_fields = st.tuples(_names, _values, st.sampled_from(["index", "index", "no", "never"]))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.lists(_fields, max_size=8), min_size=1, max_size=6),
       st.sampled_from([0, 64, 256, 4096]), st.booleans())
def test_header_lists_round_trip_through_a_shared_table(lists, size, huffman):
    enc, dec = hpack.Encoder(size, huffman=huffman), hpack.Decoder(size)
    for fields in lists:
        block = enc.encode(fields)
        assert dec.decode(block) == [(n, v) for n, v, _ in fields]
        assert [(n, v) for n, v, _ in dec.table.entries] == [
            (n, v) for n, v, _ in enc.table.entries]
        assert dec.table.size == enc.table.size <= size
