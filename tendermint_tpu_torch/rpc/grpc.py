"""gRPC unary calls on rpc/http2.py: the transport under abci/grpc.py and
rpc/grpc_api.py.  The JAX package's run on grpcio (`grpc.aio`); the card's
machine is not promised grpcio, and either package's client calls the
other's server (tests/test_torch_grpc.py).

Server: `Server.add_service(service, {"Method": UnaryMethod(handler,
request_deserializer, response_serializer)})`, as grpcio's
`method_handlers_generic_handler` registers them, each handler an
`async def handler(request) -> response`.  A request is `:method POST`
to `:path /<service>/<Method>` with `content-type: application/grpc`; its
one message is framed as a compressed flag (always 0: nothing here, nor
grpcio by default, compresses) and a 4-byte big-endian length.  The answer
is HEADERS (`:status 200`), the framed message and trailers with
`grpc-status` and a percent-encoded `grpc-message`; an error is a single
trailers-only HEADERS.  Status codes follow grpcio: an unknown method 12
UNIMPLEMENTED ("Method not found!"), a handler that raises 2 UNKNOWN
("Unexpected <class ...>: ..."), a request over the 4 MiB receive limit 8
RESOURCE_EXHAUSTED ("SERVER: Received message larger than max (...)"); a
request that does not deserialize 13 INTERNAL.

Client: `Channel(target)` connects at its first call (and again after its
connection closes or is told to go away); `channel.unary_unary(path,
request_serializer, response_deserializer)` returns an awaitable stub.  A
failed call raises `RpcError` with `.code()` (a `StatusCode`) and
`.details()`, as grpcio's `AioRpcError` does: a response over the receive
limit 8, a connection that fails or is lost 14 UNAVAILABLE.
"""

from __future__ import annotations

import asyncio
import enum
from typing import Any, Callable, Dict, NamedTuple, Optional
from urllib.parse import quote, unquote

from . import http2
from .http import parse_laddr

MAX_RECEIVE_MESSAGE = 4 * 1024 * 1024  # grpcio's default receive limit
CONTENT_TYPE = "application/grpc"
USER_AGENT = "grpc-python-tendermint_tpu_torch"


class StatusCode(enum.IntEnum):
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


# gRPC's HTTP-to-status mapping for an answer that is not :status 200
_HTTP_STATUS = {400: StatusCode.INTERNAL, 401: StatusCode.UNAUTHENTICATED,
                403: StatusCode.PERMISSION_DENIED, 404: StatusCode.UNIMPLEMENTED,
                429: StatusCode.UNAVAILABLE, 502: StatusCode.UNAVAILABLE,
                503: StatusCode.UNAVAILABLE, 504: StatusCode.UNAVAILABLE}


class RpcError(Exception):
    """A failed call: its status code and details."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class UnaryMethod(NamedTuple):
    handler: Callable[[Any], Any]  # async (request) -> response
    request_deserializer: Callable[[bytes], Any]
    response_serializer: Callable[[Any], bytes]


def frame_message(data: bytes) -> bytes:
    return b"\x00" + len(data).to_bytes(4, "big") + data


async def read_message(stream: http2.Stream, limit: int, side: str) -> bytes:
    """The one message of a unary request or answer, read as it arrives:
    over `limit` raises RESOURCE_EXHAUSTED as soon as its length is known,
    its details grpcio's, `side` (SERVER or CLIENT) first."""
    buf = bytearray()
    while True:
        chunk = await stream.read()
        if not chunk:
            break
        buf += chunk
        if len(buf) >= 5 and int.from_bytes(buf[1:5], "big") > limit:
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED, f"{side}: Received message larger "
                           f"than max ({int.from_bytes(buf[1:5], 'big')} vs. {limit})")
    if len(buf) < 5:
        raise RpcError(StatusCode.INTERNAL, "no message in the stream")
    if buf[0] != 0:
        raise RpcError(StatusCode.INTERNAL, "a compressed message without grpc-encoding")
    length = int.from_bytes(buf[1:5], "big")
    if len(buf) != 5 + length:
        raise RpcError(StatusCode.INTERNAL, "not exactly one message in the stream")
    return bytes(buf[5:])


def _status_headers(code: int, details: str):
    out = [("grpc-status", str(int(code)))]
    if details:
        out.append(("grpc-message", quote(details, safe=" !\"#$&'()*+,-./:;<=>?@[\\]^_`{|}~")))
    return out


class Server:
    """gRPC unary methods served over h2c (see the module doc)."""

    def __init__(self, logger: str = "grpc"):
        self._methods: Dict[str, UnaryMethod] = {}
        self._h2 = http2.H2Server(self._serve_stream, logger=logger)

    def add_service(self, service: str, methods: Dict[str, UnaryMethod]) -> None:
        for name, method in methods.items():
            self._methods[f"/{service}/{name}"] = method

    @property
    def connections(self):
        return self._h2.connections

    async def start(self, laddr: str) -> str:
        """Listen at laddr; returns the bound host:port."""
        return await self._h2.start(laddr)

    async def stop(self, grace: float = 1.0) -> None:
        await self._h2.stop(grace)

    async def _serve_stream(self, conn: http2.H2Connection, stream: http2.Stream) -> None:
        try:
            try:
                await self._answer(conn, stream)
            except RpcError as e:
                if stream.reset is None and not stream.closed_local:
                    conn.send_headers(stream, [(":status", "200"), ("content-type", CONTENT_TYPE)]
                                      + _status_headers(e.code(), e.details()), end_stream=True)
            if not stream.ended and stream.reset is None:
                conn.reset_stream(stream, http2.NO_ERROR)  # the answer is complete: stop sending
            await conn._drain()
        except ConnectionError:
            pass  # the client went away (a reset stream or a lost connection)

    async def _answer(self, conn: http2.H2Connection, stream: http2.Stream) -> None:
        method = self._methods.get(dict(stream.headers).get(":path", ""))
        if method is None:
            raise RpcError(StatusCode.UNIMPLEMENTED, "Method not found!")
        data = await read_message(stream, MAX_RECEIVE_MESSAGE, "SERVER")
        try:
            request = method.request_deserializer(data)
        except Exception:  # noqa: BLE001 - the peer's bytes
            raise RpcError(StatusCode.INTERNAL, "Exception deserializing request!")
        try:
            response = await method.handler(request)
        except Exception as e:  # noqa: BLE001 - the handler's fault goes to the caller
            raise RpcError(StatusCode.UNKNOWN, f"Unexpected {type(e)}: {e}")
        payload = frame_message(method.response_serializer(response))
        conn.send_headers(stream, [(":status", "200"), ("content-type", CONTENT_TYPE)])
        await conn.send_data(stream, payload)
        conn.send_headers(stream, _status_headers(StatusCode.OK, ""), end_stream=True)


class Channel:
    """A client channel to one target (host:port): one h2c connection,
    opened at the first call (see the module doc)."""

    def __init__(self, target: str):
        self.target = target.split("://", 1)[-1]
        self.host, self.port = parse_laddr(self.target)
        self.conn: Optional[http2.H2Connection] = None
        self._lock: Optional[asyncio.Lock] = None

    async def _connection(self) -> http2.H2Connection:
        if self.conn is not None and self.conn.usable:
            return self.conn
        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            if self.conn is None or not self.conn.usable:
                if self.conn is not None:
                    await self.conn.close()
                    self.conn = None
                try:
                    self.conn = await http2.connect(self.host, self.port)
                except OSError as e:
                    raise RpcError(StatusCode.UNAVAILABLE,
                                   f"failed to connect to {self.target}: {e}")
        return self.conn

    def unary_unary(self, path: str, request_serializer: Callable[[Any], bytes],
                    response_deserializer: Callable[[bytes], Any]):
        async def call(request):
            return response_deserializer(await self.call(path, request_serializer(request)))

        return call

    async def call(self, path: str, payload: bytes) -> bytes:
        """One unary call of raw message bytes; the answer's message."""
        conn = await self._connection()
        headers = [(":method", "POST"), (":scheme", "http"), (":path", path),
                   (":authority", self.target), ("content-type", CONTENT_TYPE),
                   ("te", "trailers"), ("user-agent", USER_AGENT)]
        stream = None
        message, trailers = None, {}
        try:
            stream = await conn.open_stream(headers)
            await conn.send_data(stream, frame_message(payload), end_stream=True)
            await stream.wait_for(lambda: stream.headers is not None)
            head = dict(stream.headers)
            status = head.get(":status", "")
            if status != "200":
                code = _HTTP_STATUS.get(int(status) if status.isdigit() else 0,
                                        StatusCode.UNKNOWN)
                raise RpcError(code, f"Received http2 header with status: {status}")
            if "grpc-status" in head:  # trailers-only
                trailers = head
            else:
                message = await read_message(stream, MAX_RECEIVE_MESSAGE, "CLIENT")
                trailers = dict(stream.trailers or ())
        except RpcError:
            if stream is not None and not stream.ended:
                conn.reset_stream(stream, http2.CANCEL)
            raise
        except http2.StreamReset as e:
            # a server that answered early (an error) resets the rest of the request
            trailers = dict(stream.trailers or stream.headers or ()) if stream else {}
            if "grpc-status" not in trailers or trailers["grpc-status"] == "0":
                raise RpcError(*{
                    http2.CANCEL: (StatusCode.CANCELLED, "Received RST_STREAM"),
                    http2.REFUSED_STREAM: (StatusCode.UNAVAILABLE, "Stream refused"),
                    http2.CONNECTION_LOST: (StatusCode.UNAVAILABLE, "Connection lost"),
                }.get(e.code, (StatusCode.INTERNAL, f"Received RST_STREAM {e.code}")))
        code = trailers.get("grpc-status")
        if code is None or not code.isdigit():
            raise RpcError(StatusCode.UNKNOWN, "no grpc-status in the trailers")
        if int(code) != StatusCode.OK:
            try:
                status_code = StatusCode(int(code))
            except ValueError:
                status_code = StatusCode.UNKNOWN
            raise RpcError(status_code, unquote(trailers.get("grpc-message", "")))
        if message is None:
            raise RpcError(StatusCode.INTERNAL, "status OK without a message")
        return message

    def stats(self) -> list:
        """Frames by type and bytes each way of the channel's connection
        (none before the first call)."""
        return [self.conn.stats()] if self.conn is not None else []

    async def close(self) -> None:
        if self.conn is not None:
            await self.conn.close()
            self.conn = None
