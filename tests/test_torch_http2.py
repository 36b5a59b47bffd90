"""The port's HTTP/2 (tendermint_tpu_torch/rpc/http2.py, RFC 9113 over
cleartext with prior knowledge), both ends, tolerance exact.

- The frame codec: every frame type's 9-byte header and payload round trip;
  a frame over the receiver's MAX_FRAME_SIZE, a SETTINGS payload not a
  multiple of 6 and padding longer than its frame are errors.
- A 1 MB body each way on one stream through flow control at the default
  65,535-byte windows: no DATA frame exceeds 16,384 bytes, both ends send
  WINDOW_UPDATEs as the data is read, and the bytes come back intact.
- PING is answered by an ACK with its 8 bytes; each SETTINGS by its ACK.
- A header block over MAX_FRAME_SIZE goes out as HEADERS + CONTINUATION
  and decodes whole.
- A mid-stream INITIAL_WINDOW_SIZE change moves an open stream's send
  window by the difference (RFC 9113 6.9.2): a sender blocked on a spent
  window goes on when the receiver raises it, and one whose window went
  negative waits for WINDOW_UPDATEs.
- GOAWAY: a server's stop refuses new streams and closes the connection.
"""

import asyncio
import struct

import pytest

from tendermint_tpu_torch.rpc import http2


def _frames(data: bytes):
    out, pos = [], 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 3], "big")
        out.append((data[pos + 3], data[pos + 4],
                    int.from_bytes(data[pos + 5:pos + 9], "big"), data[pos + 9:pos + 9 + n]))
        pos += 9 + n
    return out


@pytest.mark.parametrize("ftype", range(10), ids=http2.FRAME_NAMES)
def test_frame_codec_round_trip(ftype):
    payload = bytes(range(256)) * 3
    raw = http2.pack_frame(ftype, 0x25, 7, payload)
    assert raw[:9] == struct.pack(">I", len(payload))[1:] + bytes([ftype, 0x25]) + (7).to_bytes(
        4, "big")
    assert asyncio.run(_read(raw, 16_384)) == (ftype, 0x25, 7, payload)


async def _read(raw, max_size):
    reader = asyncio.StreamReader()
    reader.feed_data(raw)
    reader.feed_eof()
    return await http2.read_frame(reader, max_size)


def test_frame_codec_errors():
    with pytest.raises(http2.H2Error) as e:
        asyncio.run(_read(http2.pack_frame(http2.DATA, 0, 1, b"x" * 16_385), 16_384))
    assert e.value.code == http2.FRAME_SIZE_ERROR
    settings = {http2.INITIAL_WINDOW_SIZE: 1 << 20, http2.MAX_FRAME_SIZE: 32_768}
    assert http2.parse_settings(http2.pack_settings(settings)) == list(settings.items())
    with pytest.raises(http2.H2Error):
        http2.parse_settings(b"\x00\x04\x00")
    assert http2._strip_padding(http2.PADDED, b"\x02abc\x00\x00") == b"abc"
    with pytest.raises(http2.H2Error):
        http2._strip_padding(http2.PADDED, b"\x05ab")


class Echo:
    """An H2Server whose streams answer their request body (and its
    headers' x-echo value) once told to read, so a test can hold a body
    in flight."""

    def __init__(self, hold=False):
        self.go = asyncio.Event()
        if not hold:
            self.go.set()
        self.server = http2.H2Server(self.serve)
        self.streams = []

    async def serve(self, conn, stream):
        self.streams.append((conn, stream))
        await self.go.wait()
        body = bytearray()
        while True:
            chunk = await stream.read()
            if not chunk:
                break
            body += chunk
        echo = dict(stream.headers).get("x-echo", "")
        conn.send_headers(stream, [(":status", "200"), ("x-echo", echo)])
        await conn.send_data(stream, bytes(body))
        conn.send_headers(stream, [("x-done", str(len(body)))], end_stream=True)


async def _exchange(conn, body, headers=()):
    stream = await conn.open_stream([(":method", "POST"), (":path", "/e"), (":scheme", "http"),
                                     (":authority", "x"), *headers])
    await conn.send_data(stream, body, end_stream=True)
    got = bytearray()
    while True:
        chunk = await stream.read()
        if not chunk:
            break
        got += chunk
    return stream, bytes(got)


async def test_a_megabyte_each_way_through_flow_control():
    echo = Echo()
    host, port = http2.parse_laddr(await echo.server.start("tcp://127.0.0.1:0"))
    conn = await http2.connect(host, port)
    sent_frames = []
    write = conn.writer.write
    conn.writer.write = lambda data: (sent_frames.extend(_frames(data)), write(data))
    try:
        body = bytes(range(256)) * 4096  # 1 MiB
        stream, got = await _exchange(conn, body)
        assert got == body
        assert dict(stream.trailers) == {"x-done": str(len(body))}
        data = [f for f in sent_frames if f[0] == http2.DATA]
        assert max(len(f[3]) for f in data) == 16_384 and sum(len(f[3]) for f in data) == len(body)
        (sconn, _), = echo.streams
        for side in (conn, sconn):  # each end returned what it read, connection and stream
            assert side.frames_in["WINDOW_UPDATE"] >= 1 and side.frames_out["WINDOW_UPDATE"] >= 1
            assert side.frames_in["SETTINGS"] == side.frames_out["SETTINGS"] == 2  # theirs + ACK
        assert conn.send_window >= 0 and sconn.send_window >= 0
        assert sconn.stats()["bytes_in"] > len(body) and conn.stats()["bytes_in"] > len(body)
    finally:
        await conn.close()
        await echo.server.stop()


async def test_ping_ack_and_continuation():
    echo = Echo()
    host, port = http2.parse_laddr(await echo.server.start("tcp://127.0.0.1:0"))
    conn = await http2.connect(host, port)
    try:
        await asyncio.wait_for(conn.ping(b"12345678"), 10)
        (sconn,) = echo.server.connections
        assert sconn.frames_in["PING"] == 1 and sconn.frames_out["PING"] == 1  # the ACK
        big = "v" * 40_000  # a header block over 16,384 bytes
        stream, got = await _exchange(conn, b"abc", [("x-echo", big)])
        assert got == b"abc" and dict(stream.headers)["x-echo"] == big
        assert conn.frames_out["CONTINUATION"] >= 2 and conn.frames_in["CONTINUATION"] >= 2
    finally:
        await conn.close()
        await echo.server.stop()


@pytest.mark.parametrize("new_window", [65_535 + 50_000, 30_000])
async def test_initial_window_size_change_mid_stream(new_window):
    echo = Echo(hold=True)
    host, port = http2.parse_laddr(await echo.server.start("tcp://127.0.0.1:0"))
    conn = await http2.connect(host, port)
    try:
        body = b"w" * 200_000
        task = asyncio.ensure_future(_exchange(conn, body))
        # the server holds the body unread: the client spends the stream's
        # 65,535 bytes and waits
        while not (echo.streams and echo.streams[0][1].recv_window == 0):
            await asyncio.sleep(0.01)
        sconn, sstream = echo.streams[0]
        (cstream,) = conn.streams.values()
        assert cstream.send_window == 0 and not task.done()
        # room on the connection, so the stream's window alone holds the client
        sconn._write(http2.WINDOW_UPDATE, 0, 0, struct.pack(">I", 1 << 20))
        sconn.recv_window += 1 << 20
        sconn._flush()
        sconn.update_settings({http2.INITIAL_WINDOW_SIZE: new_window})
        while conn.remote[http2.INITIAL_WINDOW_SIZE] != new_window:
            await asyncio.sleep(0.01)
        if new_window > 65_535:
            # the difference went to the open stream, and the client sent it
            while sstream.recv_window != 0:
                await asyncio.sleep(0.01)
            assert len(sstream.data) == new_window
        else:
            # the window went negative: nothing more goes out until the
            # server has read enough
            await asyncio.sleep(0.1)
            assert cstream.send_window == new_window - 65_535 < 0
            assert len(sstream.data) == 65_535
        echo.go.set()
        stream, got = await asyncio.wait_for(task, 30)
        assert got == body
    finally:
        await conn.close()
        await echo.server.stop()


async def test_goaway_on_stop_refuses_new_streams():
    echo = Echo()
    host, port = http2.parse_laddr(await echo.server.start("tcp://127.0.0.1:0"))
    conn = await http2.connect(host, port)
    _, got = await _exchange(conn, b"before")
    assert got == b"before"
    await echo.server.stop()
    await asyncio.wait_for(conn.closed.wait(), 10)
    assert conn.goaway_received and not conn.usable
    with pytest.raises(http2.StreamReset):
        await conn.open_stream([(":method", "POST"), (":path", "/e")])
    await conn.close()
