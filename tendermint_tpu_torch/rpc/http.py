"""HTTP/1.1 on asyncio streams: the one reader and writer of HTTP in the
port, under the RPC server (rpc/server.py), the liteserve gateway
(liteserve/service.py) and the RPC client (rpc/client.py).  The JAX package
runs these on aiohttp; the card's machine has no aiohttp.

Server side: `HTTPServer` accepts connections, reads each request head
(capped at `max_header_bytes`, 431 beyond it), hands a `Request` (its body
a stream read on demand, by Content-Length or chunked) to the owner's
handler and writes the answer.  Keep-alive follows HTTP/1.1 (HTTP/1.0 only
with `Connection: keep-alive`); a body the handler left unread is drained
if small, else the connection closes; at most `max_open_connections`
connections are served at once (the rest wait for a slot, as Go's
LimitListener makes them wait).  A handler that returns `HIJACKED` has
taken the connection over (a WebSocket upgrade): the server writes nothing
more on it and closes it when the handler returns.

Client side: `read_response` reads one response.
"""

from __future__ import annotations

import asyncio
import email.utils
import json
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple, Union
from urllib.parse import unquote, urlsplit

from ..libs.log import get_logger

REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 431: "Request Header Fields Too Large",
    503: "Service Unavailable",
}
TEXT = "text/plain; charset=utf-8"
JSON = "application/json; charset=utf-8"
NOT_FOUND = (404, b"404: Not Found", TEXT)
NOT_ALLOWED = (405, b"405: Method Not Allowed", TEXT)

# what a handler answers: (status, body, content type), or HIJACKED
Answer = Tuple[int, bytes, str]
HIJACKED = object()


def parse_laddr(laddr: str) -> Tuple[str, int]:
    """tcp://host:port (or host:port) -> (host, port)."""
    addr = laddr.split("://", 1)[-1]
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def json_answer(data: Any) -> Answer:
    """aiohttp's web.json_response: json.dumps of the value."""
    return 200, json.dumps(data).encode(), JSON


class BadRequest(Exception):
    """A refused request: its text answer is sent and the connection closes."""

    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status
        self.text = text


class Body:
    """The request body as a stream with `read(n)`: Content-Length bytes,
    or a chunked transfer decoded as it is read."""

    def __init__(self, reader: asyncio.StreamReader, length: int, chunked: bool):
        self.reader = reader
        self.left = length
        self.chunked = chunked
        self.done = not chunked and length == 0

    async def read(self, n: int) -> bytes:
        if self.done or n <= 0:
            return b""
        if self.chunked and self.left == 0:
            line = await self.reader.readline()
            try:
                size = int(line.split(b";", 1)[0].strip() or b"x", 16)
            except ValueError:
                raise BadRequest(400, "400: Bad Request")
            if size == 0:
                while (await self.reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                self.done = True
                return b""
            self.left = size
        data = await self.reader.read(min(n, self.left))
        if not data:
            raise ConnectionError("connection closed inside the request body")
        self.left -= len(data)
        if self.left == 0:
            if self.chunked:
                await self.reader.readline()  # the chunk's CRLF
            else:
                self.done = True
        return data

    async def drain(self, limit: int) -> bool:
        """Read and drop what is left, up to `limit` bytes: True when the
        whole body was consumed (the connection can serve another request)."""
        seen = 0
        while not self.done and seen <= limit:
            chunk = await self.read(65536)
            if not chunk:
                break
            seen += len(chunk)
        return self.done


class Request:
    """One parsed request: method (upper case), path (unquoted), query
    string, version, lower-cased headers, body, the client's address and
    the connection's streams (for a handler that takes it over)."""

    def __init__(self, method, target, version, headers, body, source, reader, writer):
        url = urlsplit(target)
        self.method = method
        self.path = unquote(url.path or "/")
        self.query = url.query
        self.version = version
        self.headers = headers
        self.body = body
        self.source = source
        self.reader = reader
        self.writer = writer


Handler = Callable[[Request], Awaitable[Union[Answer, object]]]


class HTTPServer:
    """Serves `handler` at a listen address (see the module doc)."""

    def __init__(self, handler: Handler, max_header_bytes: int = 1 << 20,
                 max_body_bytes: int = 1_000_000, max_open_connections: int = 0,
                 logger: str = "rpc.server"):
        self.handler = handler
        self.max_header_bytes = max_header_bytes
        self.max_body_bytes = max_body_bytes
        self.max_open_connections = max_open_connections
        self.log = get_logger(logger)
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()
        self._slots: Optional[asyncio.Semaphore] = None
        self.listen_addr = ""

    async def start(self, laddr: str) -> str:
        host, port = parse_laddr(laddr)
        if self.max_open_connections > 0:
            self._slots = asyncio.Semaphore(self.max_open_connections)
        self._server = await asyncio.start_server(
            self._serve_conn, host, port, limit=max(self.max_header_bytes, 1 << 16) + 1
        )
        # resolve the ephemeral port (laddr ...:0)
        self.listen_addr = "%s:%d" % self._server.sockets[0].getsockname()[:2]
        return self.listen_addr

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        for task in list(self._conns):
            task.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()

    # -- connections -------------------------------------------------------

    async def _serve_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        self._conns.add(task)
        peer = writer.get_extra_info("peername")
        source = peer[0] if isinstance(peer, tuple) and peer else ""
        try:
            if self._slots is not None:
                async with self._slots:
                    await self._requests(reader, writer, source)
            else:
                await self._requests(reader, writer, source)
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            pass
        except Exception as e:  # noqa: BLE001 — one connection, not the server
            self.log.error("rpc connection failed", err=repr(e))
        finally:
            self._conns.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, asyncio.CancelledError):
                pass

    async def _read_head(self, reader: asyncio.StreamReader) -> Optional[bytes]:
        """The request line and headers, without the blank line; None at a
        clean end of the connection."""
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if not e.partial.strip():
                return None
            raise
        except asyncio.LimitOverrunError:
            raise BadRequest(431, "431: Request Header Fields Too Large")
        if len(head) > self.max_header_bytes + 4:
            raise BadRequest(431, "431: Request Header Fields Too Large")
        return head[:-4]

    async def _requests(self, reader, writer, source: str) -> None:
        while True:
            try:
                head = await self._read_head(reader)
                if head is None:
                    return
                method, target, version, headers = parse_head(head)
            except BadRequest as e:
                await self.send_text(writer, e.status, e.text)
                return
            conn_hdr = headers.get("connection", "").lower()
            keep = (version == "HTTP/1.1" and conn_hdr != "close") or (
                version == "HTTP/1.0" and conn_hdr == "keep-alive"
            )
            try:
                length = int(headers.get("content-length", "0") or 0)
            except ValueError:
                length = -1
            if length < 0:
                await self.send_text(writer, 400, "400: Bad Request")
                return
            chunked = "chunked" in headers.get("transfer-encoding", "").lower()
            body = Body(reader, length, chunked)
            if headers.get("expect", "").lower() == "100-continue":
                writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            req = Request(method, target, version, headers, body, source, reader, writer)
            try:
                answer = await self.handler(req)
            except BadRequest as e:
                await self.send_text(writer, e.status, e.text)
                return
            if answer is HIJACKED:
                return
            status, payload, ctype = answer
            # a body the handler left unread (an over-cap POST, a GET with
            # a body) is drained if small, else the connection closes
            if not body.done and not await body.drain(self.max_body_bytes):
                keep = False
            await self.send(writer, status, payload, ctype, keep, version,
                            head_only=method == "HEAD")
            if not keep:
                return

    async def send(self, writer, status: int, payload: bytes, ctype: str, keep: bool,
                   version: str, head_only: bool = False) -> None:
        lines = [
            f"HTTP/1.1 {status} {REASONS.get(status, 'Error')}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(payload)}",
            f"Date: {email.utils.formatdate(usegmt=True)}",
            "Server: tendermint_tpu_torch",
        ]
        if not keep:
            lines.append("Connection: close")
        elif version == "HTTP/1.0":
            lines.append("Connection: keep-alive")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                     + (b"" if head_only else payload))
        await writer.drain()

    async def send_text(self, writer, status: int, text: str) -> None:
        """A refused request's text answer; the connection then closes."""
        await self.send(writer, status, text.encode(), TEXT, False, "HTTP/1.1")


def parse_head(head: bytes) -> Tuple[str, str, str, Dict[str, str]]:
    """Request line and headers -> (METHOD, target, version, headers)."""
    try:
        text = head.decode("latin-1")
        line, *rest = text.split("\r\n")
        method, target, version = line.split(" ")
    except ValueError:
        raise BadRequest(400, "400: Bad Request")
    if not version.startswith("HTTP/1."):
        raise BadRequest(400, "400: Bad Request")
    return method.upper(), target, version, parse_headers(rest, BadRequest(400, "400: Bad Request"))


def parse_headers(lines, error: Exception) -> Dict[str, str]:
    headers: Dict[str, str] = {}
    for h in lines:
        k, sep, v = h.partition(":")
        if not sep:
            raise error
        headers[k.strip().lower()] = v.strip()
    return headers


# -- client side ---------------------------------------------------------------


async def read_response_head(reader: asyncio.StreamReader) -> Tuple[int, Dict[str, str]]:
    """Status and lower-cased headers of one response (an interim 100 is
    skipped)."""
    while True:
        try:
            raw = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            raise ConnectionError("response head too large")
        line, *rest = raw[:-4].decode("latin-1").split("\r\n")
        parts = line.split(" ", 2)
        if len(parts) < 2 or not parts[0].startswith("HTTP/"):
            raise ConnectionError(f"malformed status line {line!r}")
        status = int(parts[1])
        headers: Dict[str, str] = {}
        for h in rest:
            k, _, v = h.partition(":")
            headers[k.strip().lower()] = v.strip()
        if status != 100:
            return status, headers


async def read_response(reader: asyncio.StreamReader) -> Tuple[int, Dict[str, str], bytes]:
    """One HTTP/1.1 response: status, lower-cased headers, body (by
    Content-Length, or to the end of the connection; the servers of both
    packages send Content-Length)."""
    status, headers = await read_response_head(reader)
    if "content-length" in headers:
        return status, headers, await reader.readexactly(int(headers["content-length"]))
    headers["connection"] = "close"
    return status, headers, await reader.read()
