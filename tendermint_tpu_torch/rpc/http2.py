"""HTTP/2 (RFC 9113) over cleartext with prior knowledge ("h2c"), both
ends, on asyncio streams: what grpcio's `insecure_port` and
`insecure_channel` speak, under rpc/grpc.py.  The JAX package's gRPC runs
on grpcio; the card's machine is not promised it.

One `H2Connection` per TCP connection, client or server side, with one
reader task.  It handles the client preface; SETTINGS (each answered by its
ACK; a new INITIAL_WINDOW_SIZE moves every open stream's send window by the
difference, RFC 9113 6.9.2; HEADER_TABLE_SIZE bounds the HPACK encoder);
HEADERS with CONTINUATION (decoded by rpc/hpack.py, in order, so the
dynamic table stays in step); DATA under stream and connection flow
control both ways (sends wait for window and are cut at the peer's
MAX_FRAME_SIZE; a consumer's `Stream.read` returns the window it frees in
WINDOW_UPDATEs once half a window is due); PING (each answered by an ACK
carrying its 8 bytes); RST_STREAM; GOAWAY (streams the peer will not
process are reset, no new stream opens) and a clean close.  PRIORITY is
read and ignored; PUSH_PROMISE is a protocol error (push is never
enabled).  A connection error sends GOAWAY with its code and closes.

The reader yields to the event loop after each frame, as rpc/http.py
does after each request, so one busy connection cannot hold a node's loop.
Each connection counts its frames by type and its bytes both ways
(`stats()`).

`H2Server` accepts connections and hands each new stream, once its
header block is complete, to its `on_stream(conn, stream)` coroutine in
a task of its own; `connect` opens a client connection.
"""

from __future__ import annotations

import asyncio
import struct
from collections import Counter
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

from ..libs.log import get_logger
from .hpack import DEFAULT_TABLE_SIZE, Decoder, Encoder, Header, HPACKError
from .http import parse_laddr

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, \
    CONTINUATION = range(10)
FRAME_NAMES = ("DATA", "HEADERS", "PRIORITY", "RST_STREAM", "SETTINGS", "PUSH_PROMISE", "PING",
               "GOAWAY", "WINDOW_UPDATE", "CONTINUATION")

END_STREAM = ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20

HEADER_TABLE_SIZE, ENABLE_PUSH, MAX_CONCURRENT_STREAMS, INITIAL_WINDOW_SIZE, MAX_FRAME_SIZE, \
    MAX_HEADER_LIST_SIZE = range(1, 7)

NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR, SETTINGS_TIMEOUT, STREAM_CLOSED, \
    FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = range(10)
CONNECTION_LOST = -1  # a stream's `reset` when its connection went away

DEFAULT_WINDOW = 65_535
DEFAULT_MAX_FRAME = 16_384
MAX_FRAME_LIMIT = (1 << 24) - 1
MAX_WINDOW = (1 << 31) - 1


class H2Error(Exception):
    """A connection error: GOAWAY with `code`, then the connection closes."""

    def __init__(self, code: int, text: str):
        super().__init__(text)
        self.code = code


class StreamReset(ConnectionError):
    """The stream was reset (RST_STREAM's `code`) or its connection lost
    (CONNECTION_LOST)."""

    def __init__(self, code: int):
        super().__init__(f"stream reset with code {code}" if code != CONNECTION_LOST
                         else "connection lost")
        self.code = code


def pack_frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    n = len(payload)
    return struct.pack(">BHBBI", n >> 16, n & 0xFFFF, ftype, flags, stream_id & MAX_WINDOW) + payload


async def read_frame(reader: asyncio.StreamReader, max_size: int) -> Tuple[int, int, int, bytes]:
    """One frame: (type, flags, stream id, payload)."""
    head = await reader.readexactly(9)
    hi, lo, ftype, flags, sid = struct.unpack(">BHBBI", head)
    length = (hi << 16) | lo
    if length > max_size:
        raise H2Error(FRAME_SIZE_ERROR, f"frame of {length} bytes over {max_size}")
    return ftype, flags, sid & MAX_WINDOW, await reader.readexactly(length) if length else b""


def pack_settings(settings: Dict[int, int]) -> bytes:
    return b"".join(struct.pack(">HI", k, v) for k, v in settings.items())


def parse_settings(payload: bytes) -> List[Tuple[int, int]]:
    if len(payload) % 6:
        raise H2Error(FRAME_SIZE_ERROR, "SETTINGS payload not a multiple of 6")
    return [struct.unpack_from(">HI", payload, i) for i in range(0, len(payload), 6)]


def _strip_padding(flags: int, payload: bytes) -> bytes:
    if not flags & PADDED:
        return payload
    if not payload or payload[0] >= len(payload):
        raise H2Error(PROTOCOL_ERROR, "padding longer than the frame")
    return payload[1:len(payload) - payload[0]]


class _Signal:
    """Wakes every waiter at once; a waiter tests its condition, then waits
    on the current event (no wake-up is lost between the two)."""

    def __init__(self):
        self._ev = asyncio.Event()

    def fire(self) -> None:
        self._ev.set()
        self._ev = asyncio.Event()

    async def wait(self) -> None:
        await self._ev.wait()


class Stream:
    """One stream: its first header block (`headers`), its trailers, the
    data received and not yet read, and its windows."""

    def __init__(self, conn: "H2Connection", sid: int):
        self.conn = conn
        self.id = sid
        self.headers: Optional[List[Header]] = None
        self.trailers: Optional[List[Header]] = None
        self.data = bytearray()
        self.ended = False  # the peer sent END_STREAM
        self.closed_local = False  # we sent END_STREAM
        self.reset: Optional[int] = None
        self.send_window = conn.remote[INITIAL_WINDOW_SIZE]
        self.recv_window = conn.local[INITIAL_WINDOW_SIZE]
        self.unread_flow = 0  # flow-controlled bytes received, not yet read
        self.due = 0  # read, not yet returned in a WINDOW_UPDATE
        self.changed = _Signal()

    async def wait_for(self, cond: Callable[[], bool]) -> None:
        while not cond():
            if self.reset is not None:
                raise StreamReset(self.reset)
            await self.changed.wait()

    async def read(self) -> bytes:
        """The data received since the last read (waiting for some); b""
        once the peer ended the stream and everything was read."""
        await self.wait_for(lambda: bool(self.data) or self.ended)
        chunk = bytes(self.data)
        self.data.clear()
        self.conn._consumed(self)
        return chunk


class H2Connection:
    """One HTTP/2 connection (see the module doc).  This side grants the
    RFC's default windows and frame size until `update_settings`."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, client: bool,
                 on_stream: Optional[Callable[["H2Connection", Stream], Awaitable[None]]] = None,
                 logger: str = "http2"):
        self.reader, self.writer = reader, writer
        self.client = client
        self.on_stream = on_stream
        self.log = get_logger(logger)
        self.local = {HEADER_TABLE_SIZE: DEFAULT_TABLE_SIZE, INITIAL_WINDOW_SIZE: DEFAULT_WINDOW,
                      MAX_FRAME_SIZE: DEFAULT_MAX_FRAME}
        if client:
            self.local[ENABLE_PUSH] = 0
        self.remote = {HEADER_TABLE_SIZE: DEFAULT_TABLE_SIZE,
                       INITIAL_WINDOW_SIZE: DEFAULT_WINDOW, MAX_FRAME_SIZE: DEFAULT_MAX_FRAME,
                       MAX_CONCURRENT_STREAMS: MAX_WINDOW}
        self.encoder = Encoder()
        self.decoder = Decoder()
        self.streams: Dict[int, Stream] = {}
        self.next_id = 1 if client else 2
        self.last_peer_id = 0
        self.send_window = DEFAULT_WINDOW
        self.recv_window = DEFAULT_WINDOW
        self.due = 0  # connection window read, not yet returned
        self.window_open = _Signal()
        self.goaway_sent = self.goaway_received = False
        self.closed = asyncio.Event()
        self.frames_in: Counter = Counter()
        self.frames_out: Counter = Counter()
        self.bytes_in = self.bytes_out = 0
        self._headers_of: Optional[Tuple[int, int, bytearray]] = None  # a block's CONTINUATIONs
        self._pings: Dict[bytes, asyncio.Future] = {}
        self._handlers: set = set()
        self._task: Optional[asyncio.Task] = None
        self._out = bytearray()  # frames queued for this loop iteration's write

    # -- lifetime --------------------------------------------------------------

    def start(self) -> None:
        """Send the preface (a client's magic, then SETTINGS) and start
        reading."""
        if self.client:
            self.writer.write(PREFACE)
            self.bytes_out += len(PREFACE)
        self._write(SETTINGS, 0, 0, pack_settings(self.local))
        self._task = asyncio.ensure_future(self._read_loop())

    async def close(self, code: int = NO_ERROR) -> None:
        """GOAWAY, then the socket; open streams are reset (CONNECTION_LOST)."""
        if not self.closed.is_set() and not self.goaway_sent:
            self._goaway(code, "")
            try:
                await self._drain()
            except ConnectionError:
                pass
        if self._task is not None and not self._task.done():
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        await self._closed()

    async def wait_handlers(self) -> None:
        """Wait for the stream handlers (server side) that are running."""
        while self._handlers:
            await asyncio.wait(set(self._handlers))

    def stats(self) -> dict:
        return {"frames_in": dict(self.frames_in), "frames_out": dict(self.frames_out),
                "bytes_in": self.bytes_in, "bytes_out": self.bytes_out}

    @property
    def usable(self) -> bool:
        return not self.closed.is_set() and not self.goaway_received and not self.goaway_sent

    # -- writing ---------------------------------------------------------------

    def _write(self, ftype: int, flags: int, sid: int, payload: bytes = b"") -> None:
        """Queue a frame; the frames of one loop iteration go out in one
        write (`_flush`, scheduled at the first)."""
        if self.closed.is_set():
            raise StreamReset(CONNECTION_LOST)
        if not self._out:
            asyncio.get_event_loop().call_soon(self._flush)
        self._out += pack_frame(ftype, flags, sid, payload)
        self.frames_out[FRAME_NAMES[ftype]] += 1
        self.bytes_out += 9 + len(payload)

    def _flush(self) -> None:
        if self._out and not self.writer.is_closing():
            self.writer.write(bytes(self._out))
        self._out.clear()

    async def _drain(self) -> None:
        self._flush()
        await self.writer.drain()

    def _goaway(self, code: int, text: str) -> None:
        self.goaway_sent = True
        self._write(GOAWAY, 0, 0, struct.pack(">II", self.last_peer_id, code) + text.encode())

    async def open_stream(self, headers, end_stream: bool = False) -> Stream:
        """A new stream of ours (client side), its header block sent; waits
        while the peer's MAX_CONCURRENT_STREAMS are in use."""
        while True:
            if not self.usable:
                raise StreamReset(CONNECTION_LOST if self.closed.is_set() else REFUSED_STREAM)
            if len(self.streams) < self.remote[MAX_CONCURRENT_STREAMS]:
                break
            await self.window_open.wait()
        stream = Stream(self, self.next_id)
        self.next_id += 2
        self.streams[stream.id] = stream
        self.send_headers(stream, headers, end_stream)
        return stream

    def send_headers(self, stream: Stream, headers, end_stream: bool = False) -> None:
        """A header block: HEADERS, then CONTINUATIONs at the peer's
        MAX_FRAME_SIZE, written together."""
        block = self.encoder.encode(headers)
        size = self.remote[MAX_FRAME_SIZE]
        first, rest = block[:size], block[size:]
        flags = (END_STREAM if end_stream else 0) | (0 if rest else END_HEADERS)
        self._write(HEADERS, flags, stream.id, first)
        while rest:
            chunk, rest = rest[:size], rest[size:]
            self._write(CONTINUATION, 0 if rest else END_HEADERS, stream.id, chunk)
        if end_stream:
            self._end_local(stream)

    async def send_data(self, stream: Stream, data: bytes, end_stream: bool = False) -> None:
        """DATA frames within the stream's and the connection's send windows,
        each at most the peer's MAX_FRAME_SIZE, waiting for WINDOW_UPDATEs."""
        view = memoryview(data)
        while True:
            if stream.reset is not None:
                raise StreamReset(stream.reset)
            n = min(len(view), self.send_window, stream.send_window, self.remote[MAX_FRAME_SIZE])
            if n <= 0 and view:
                await self.window_open.wait()
                continue
            chunk, view = view[:n], view[n:]
            last = end_stream and not view
            self._write(DATA, END_STREAM if last else 0, stream.id, bytes(chunk))
            self.send_window -= n
            stream.send_window -= n
            await self._drain()
            if not view:
                break
        if end_stream:
            self._end_local(stream)

    def update_settings(self, settings: Dict[int, int]) -> None:
        """Send new SETTINGS of ours; a new INITIAL_WINDOW_SIZE moves every
        open stream's receive window by the difference."""
        delta = settings.get(INITIAL_WINDOW_SIZE, self.local[INITIAL_WINDOW_SIZE]) \
            - self.local[INITIAL_WINDOW_SIZE]
        for stream in self.streams.values():
            stream.recv_window += delta
        self.local.update(settings)
        self._write(SETTINGS, 0, 0, pack_settings(settings))

    def reset_stream(self, stream: Stream, code: int) -> None:
        if stream.reset is None and self.streams.pop(stream.id, None) is not None:
            stream.reset = code
            self._write(RST_STREAM, 0, stream.id, struct.pack(">I", code))
            self._drop(stream)

    async def ping(self, data: bytes = b"\0" * 8) -> None:
        """Send a PING and wait for its ACK."""
        fut = asyncio.get_event_loop().create_future()
        self._pings[data] = fut
        self._write(PING, 0, 0, data)
        await self._drain()
        await fut

    def _end_local(self, stream: Stream) -> None:
        stream.closed_local = True
        if stream.ended:
            self._forget(stream)

    def _forget(self, stream: Stream) -> None:
        if self.streams.pop(stream.id, None) is not None:
            self.window_open.fire()  # a concurrency slot is free

    def _drop(self, stream: Stream) -> None:
        """A reset stream: what it holds unread goes back to the connection."""
        self.due += stream.unread_flow
        stream.unread_flow = 0
        stream.data.clear()
        stream.changed.fire()
        self.window_open.fire()
        self._return_window(None)

    # -- flow control of what we receive ---------------------------------------

    def _consumed(self, stream: Stream) -> None:
        n, stream.unread_flow = stream.unread_flow, 0
        self.due += n
        stream.due += n
        self._return_window(stream)

    def _return_window(self, stream: Optional[Stream]) -> None:
        if self.closed.is_set():
            return
        half = self.local[INITIAL_WINDOW_SIZE] // 2
        if self.due >= half:
            self._write(WINDOW_UPDATE, 0, 0, struct.pack(">I", self.due))
            self.recv_window += self.due
            self.due = 0
        if stream is not None and not stream.ended and stream.reset is None and stream.due >= half:
            self._write(WINDOW_UPDATE, 0, stream.id, struct.pack(">I", stream.due))
            stream.recv_window += stream.due
            stream.due = 0

    # -- reading ---------------------------------------------------------------

    async def _read_loop(self) -> None:
        try:
            if not self.client:
                preface = await self.reader.readexactly(len(PREFACE))
                self.bytes_in += len(preface)
                if preface != PREFACE:
                    raise H2Error(PROTOCOL_ERROR, "not an HTTP/2 client preface")
            while True:
                ftype, flags, sid, payload = await read_frame(self.reader,
                                                              self.local[MAX_FRAME_SIZE])
                self.bytes_in += 9 + len(payload)
                if ftype < len(FRAME_NAMES):
                    self.frames_in[FRAME_NAMES[ftype]] += 1
                self._handle(ftype, flags, sid, payload)
                self._flush()
                await asyncio.sleep(0)
        except H2Error as e:
            self.log.info("http2 connection error", code=e.code, err=str(e))
            try:
                self._goaway(e.code, str(e))
                self._flush()
            except ConnectionError:
                pass
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            await self._closed()

    async def _closed(self) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        for stream in list(self.streams.values()):
            if stream.reset is None:
                stream.reset = CONNECTION_LOST
            stream.changed.fire()
        self.streams.clear()
        self.window_open.fire()
        self._flush()
        for fut in self._pings.values():
            if not fut.done():
                fut.set_exception(StreamReset(CONNECTION_LOST))
        self.writer.close()
        try:
            await self.writer.wait_closed()
        except (ConnectionError, asyncio.CancelledError):
            pass

    def _handle(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if self._headers_of is not None:
            hsid, hflags, block = self._headers_of
            if ftype != CONTINUATION or sid != hsid:
                raise H2Error(PROTOCOL_ERROR, "a header block interrupted")
            block += payload
            if flags & END_HEADERS:
                self._headers_of = None
                self._on_headers(hsid, hflags, bytes(block))
            return
        if ftype == DATA:
            self._on_data(sid, flags, payload)
        elif ftype == HEADERS:
            if sid == 0:
                raise H2Error(PROTOCOL_ERROR, "HEADERS on stream 0")
            block = _strip_padding(flags, payload)
            if flags & PRIORITY_FLAG:
                block = block[5:]
            if flags & END_HEADERS:
                self._on_headers(sid, flags, block)
            else:
                self._headers_of = (sid, flags, bytearray(block))
        elif ftype == SETTINGS:
            self._on_settings(flags, sid, payload)
        elif ftype == WINDOW_UPDATE:
            self._on_window_update(sid, payload)
        elif ftype == PING:
            if sid != 0 or len(payload) != 8:
                raise H2Error(PROTOCOL_ERROR if sid else FRAME_SIZE_ERROR, "bad PING")
            if flags & ACK:
                fut = self._pings.pop(payload, None)
                if fut is not None and not fut.done():
                    fut.set_result(None)
            else:
                self._write(PING, ACK, 0, payload)
        elif ftype == RST_STREAM:
            if sid == 0 or len(payload) != 4:
                raise H2Error(PROTOCOL_ERROR, "bad RST_STREAM")
            stream = self.streams.pop(sid, None)
            if stream is not None:
                stream.reset = struct.unpack(">I", payload)[0]
                self._drop(stream)
        elif ftype == GOAWAY:
            last, code = struct.unpack_from(">II", payload)
            self.goaway_received = True
            if code != NO_ERROR:
                self.log.info("http2 goaway", code=code, text=payload[8:].decode(errors="replace"))
            for stream in [s for s in self.streams.values() if s.id > last and self._ours(s.id)]:
                del self.streams[stream.id]
                stream.reset = REFUSED_STREAM
                self._drop(stream)
            self.window_open.fire()
        elif ftype == CONTINUATION:
            raise H2Error(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
        elif ftype == PUSH_PROMISE:
            raise H2Error(PROTOCOL_ERROR, "PUSH_PROMISE: push is not enabled")
        # PRIORITY and unknown types are ignored

    def _ours(self, sid: int) -> bool:
        return (sid % 2 == 1) == self.client

    def _on_headers(self, sid: int, flags: int, block: bytes) -> None:
        try:
            headers = self.decoder.decode(block)  # always, to keep the table in step
        except HPACKError as e:
            raise H2Error(COMPRESSION_ERROR, str(e))
        stream = self.streams.get(sid)
        if stream is None:
            if self._ours(sid) or sid <= self.last_peer_id:
                return  # a stream already closed
            self.last_peer_id = sid
            if self.goaway_sent or self.on_stream is None:
                self._write(RST_STREAM, 0, sid, struct.pack(">I", REFUSED_STREAM))
                return
            stream = self.streams[sid] = Stream(self, sid)
            stream.headers = headers
            stream.ended = bool(flags & END_STREAM)
            task = asyncio.ensure_future(self.on_stream(self, stream))
            self._handlers.add(task)
            task.add_done_callback(self._handler_done)
            return
        if stream.headers is None:
            stream.headers = headers
        else:
            stream.trailers = headers
        if flags & END_STREAM:
            self._end_remote(stream)
        stream.changed.fire()

    def _handler_done(self, task: asyncio.Task) -> None:
        self._handlers.discard(task)
        if not task.cancelled() and task.exception() is not None:
            self.log.error("http2 stream handler failed", err=repr(task.exception()))

    def _end_remote(self, stream: Stream) -> None:
        stream.ended = True
        if stream.closed_local:
            self._forget(stream)

    def _on_data(self, sid: int, flags: int, payload: bytes) -> None:
        n = len(payload)
        self.recv_window -= n
        if self.recv_window < 0:
            raise H2Error(FLOW_CONTROL_ERROR, "DATA over the connection window")
        stream = self.streams.get(sid)
        if stream is None or stream.ended:
            self.due += n  # a closed stream's data still used the connection's window
            self._return_window(None)
            return
        stream.recv_window -= n
        if stream.recv_window < 0:
            self.due += n
            self.reset_stream(stream, FLOW_CONTROL_ERROR)
            return
        stream.data += _strip_padding(flags, payload)
        stream.unread_flow += n
        if flags & END_STREAM:
            self._end_remote(stream)
        stream.changed.fire()

    def _on_settings(self, flags: int, sid: int, payload: bytes) -> None:
        if sid != 0:
            raise H2Error(PROTOCOL_ERROR, "SETTINGS on a stream")
        if flags & ACK:
            if payload:
                raise H2Error(FRAME_SIZE_ERROR, "SETTINGS ACK with a payload")
            return
        for key, value in parse_settings(payload):
            if key == INITIAL_WINDOW_SIZE:
                if value > MAX_WINDOW:
                    raise H2Error(FLOW_CONTROL_ERROR, "INITIAL_WINDOW_SIZE over 2^31-1")
                delta = value - self.remote[INITIAL_WINDOW_SIZE]
                for stream in self.streams.values():
                    stream.send_window += delta
                    if stream.send_window > MAX_WINDOW:
                        raise H2Error(FLOW_CONTROL_ERROR, "a stream window over 2^31-1")
            elif key == MAX_FRAME_SIZE and not DEFAULT_MAX_FRAME <= value <= MAX_FRAME_LIMIT:
                raise H2Error(PROTOCOL_ERROR, f"MAX_FRAME_SIZE {value}")
            elif key == HEADER_TABLE_SIZE:
                self.encoder.set_max_table_size(min(value, DEFAULT_TABLE_SIZE))
            self.remote[key] = value
        self._write(SETTINGS, ACK, 0)
        self.window_open.fire()

    def _on_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise H2Error(FRAME_SIZE_ERROR, "WINDOW_UPDATE of other than 4 bytes")
        inc = struct.unpack(">I", payload)[0] & MAX_WINDOW
        if sid == 0:
            if inc == 0:
                raise H2Error(PROTOCOL_ERROR, "WINDOW_UPDATE of 0")
            self.send_window += inc
            if self.send_window > MAX_WINDOW:
                raise H2Error(FLOW_CONTROL_ERROR, "connection window over 2^31-1")
        else:
            stream = self.streams.get(sid)
            if stream is None:
                return
            if inc == 0:
                self.reset_stream(stream, PROTOCOL_ERROR)
                return
            stream.send_window += inc
            if stream.send_window > MAX_WINDOW:
                self.reset_stream(stream, FLOW_CONTROL_ERROR)
                return
        self.window_open.fire()


async def connect(host: str, port: int) -> H2Connection:
    """A started client connection to host:port."""
    reader, writer = await asyncio.open_connection(host, port)
    conn = H2Connection(reader, writer, client=True)
    conn.start()
    return conn


class H2Server:
    """Accepts h2c connections at a listen address; each new stream goes
    to `on_stream(conn, stream)` in its own task."""

    def __init__(self, on_stream: Callable[[H2Connection, Stream], Awaitable[None]],
                 logger: str = "http2"):
        self.on_stream = on_stream
        self.logger = logger
        self.connections: List[H2Connection] = []
        self._server: Optional[asyncio.base_events.Server] = None
        self.listen_addr = ""

    async def start(self, laddr: str) -> str:
        host, port = parse_laddr(laddr)
        self._server = await asyncio.start_server(self._serve_conn, host, port)
        self.listen_addr = "%s:%d" % self._server.sockets[0].getsockname()[:2]
        return self.listen_addr

    async def _serve_conn(self, reader, writer) -> None:
        conn = H2Connection(reader, writer, client=False, on_stream=self.on_stream,
                            logger=self.logger)
        self.connections.append(conn)
        try:
            conn.start()
            await conn.closed.wait()
            await conn.wait_handlers()
        finally:
            self.connections.remove(conn)

    async def stop(self, grace: float = 1.0) -> None:
        """Stop listening; GOAWAY on every connection; give the streams in
        flight `grace` seconds, then close."""
        if self._server is not None:
            self._server.close()
        conns = list(self.connections)
        for conn in conns:
            if conn.usable:
                conn._goaway(NO_ERROR, "")
        if conns:
            await asyncio.wait([asyncio.ensure_future(c.wait_handlers()) for c in conns],
                               timeout=grace)
        for conn in conns:
            for task in list(conn._handlers):
                task.cancel()
            await conn.close()
        if self._server is not None:
            await self._server.wait_closed()
