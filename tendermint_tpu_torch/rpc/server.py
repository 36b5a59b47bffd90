"""HTTP JSON-RPC server on asyncio streams (the port's copy of
tendermint_tpu/rpc/server.py, which runs on aiohttp; the card's machine has
no aiohttp, so this one speaks HTTP/1.1 itself).

Reference parity: rpc/lib/server/http_server.go (listener, body and header
limits, max open connections), http_json_handler.go (POST JSON-RPC incl.
batches), http_uri_handler.go (GET with URI params).

For the same request the answers equal the JAX server's: status, and the
JSON body byte for byte (`json.dumps` of the same envelope).  Requests that
match no route get aiohttp's 404/405 text answers.  Keep-alive follows
HTTP/1.1 (HTTP/1.0 only with `Connection: keep-alive`); a body is read
through `read_bounded_body` up to `max_body_bytes` + 1 bytes, a request
head is capped at `max_header_bytes` (431), and at most
`max_open_connections` connections are served at once (the rest wait for
a slot, as Go's LimitListener makes them wait).

Deviation (ROADMAP 1.7.3): `/websocket` answers HTTP 501 with a JSON-RPC
error naming that item.  The JAX server serves the whole route table and
event subscriptions there.
"""

from __future__ import annotations

import asyncio
import email.utils
import json
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

from ..libs.log import get_logger
from ..libs.service import Service
from .core import RPCCore
from .jsonrpc import (
    INVALID_PARAMS,
    INVALID_REQUEST,
    METHOD_NOT_FOUND,
    PARSE_ERROR,
    RPCError,
    from_jsonable,
    make_response,
    read_bounded_body,
)

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 431: "Request Header Fields Too Large",
    501: "Not Implemented",
}
WEBSOCKET_DEVIATION = (
    "the /websocket endpoint is not ported yet (ROADMAP 1.7.3); "
    "use HTTP GET or POST"
)


def _parse_laddr(laddr: str) -> tuple[str, int]:
    """tcp://host:port (or host:port) -> (host, port)."""
    addr = laddr.split("://", 1)[-1]
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _coerce_uri_param(v: str) -> Any:
    """GET query params arrive as strings; strip quoting and decode 0x-hex
    to bytes here, but leave everything else a string — RPCCore._coerce
    converts by the handler's annotation (the reference likewise binds URI
    strings by reflected arg type, http_uri_handler.go).  Eagerly guessing
    int here would mistype e.g. tx=1234 for a bytes param."""
    if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
        return v[1:-1]
    if v.startswith("0x"):
        try:
            return bytes.fromhex(v[2:])
        except ValueError:
            return v
    return v


class _BadRequest(Exception):
    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status
        self.text = text


class _Body:
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
                raise _BadRequest(400, "400: Bad Request")
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


class RPCServer(Service):
    """One per node; serves cfg.rpc.laddr."""

    def __init__(self, node, rpc_cfg):
        super().__init__("rpc-server")
        self.node = node
        self.cfg = rpc_cfg
        self.core = RPCCore(
            node,
            unsafe=rpc_cfg.unsafe,
            timeout_broadcast_tx_commit=rpc_cfg.timeout_broadcast_tx_commit,
            broadcast_rate=rpc_cfg.broadcast_rate,
            broadcast_rate_burst=rpc_cfg.broadcast_rate_burst,
            max_broadcast_inflight=rpc_cfg.max_broadcast_inflight,
            max_commit_waiters=rpc_cfg.max_commit_waiters,
        )
        self.log = get_logger("rpc.server")
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set = set()
        self._slots: Optional[asyncio.Semaphore] = None
        self.listen_addr: str = ""

    async def on_start(self) -> None:
        host, port = _parse_laddr(self.cfg.laddr)
        if self.cfg.max_open_connections > 0:
            self._slots = asyncio.Semaphore(self.cfg.max_open_connections)
        self._server = await asyncio.start_server(
            self._serve_conn, host, port, limit=max(self.cfg.max_header_bytes, 1 << 16) + 1
        )
        sock = self._server.sockets[0]
        # resolve the ephemeral port for tests (laddr ...:0)
        self.listen_addr = "%s:%d" % sock.getsockname()[:2]

    async def on_stop(self) -> None:
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
        limit = self.cfg.max_header_bytes
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if not e.partial.strip():
                return None
            raise
        except asyncio.LimitOverrunError:
            raise _BadRequest(431, "431: Request Header Fields Too Large")
        if len(head) > limit + 4:
            raise _BadRequest(431, "431: Request Header Fields Too Large")
        return head[:-4]

    async def _requests(self, reader, writer, source: str) -> None:
        while True:
            try:
                head = await self._read_head(reader)
            except _BadRequest as e:
                await self._send_text(writer, e.status, e.text)
                return
            if head is None:
                return
            try:
                method, target, version, headers = self._parse_head(head)
            except _BadRequest as e:
                await self._send_text(writer, e.status, e.text)
                return
            conn_hdr = headers.get("connection", "").lower()
            keep = (version == "HTTP/1.1" and conn_hdr != "close") or (
                version == "HTTP/1.0" and conn_hdr == "keep-alive"
            )
            try:
                length = int(headers.get("content-length", "0") or 0)
            except ValueError:
                await self._send_text(writer, 400, "400: Bad Request")
                return
            chunked = "chunked" in headers.get("transfer-encoding", "").lower()
            if length < 0:
                await self._send_text(writer, 400, "400: Bad Request")
                return
            body = _Body(reader, length, chunked)
            if headers.get("expect", "").lower() == "100-continue":
                writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            try:
                status, payload, ctype = await self._route(method, target, body, source)
            except _BadRequest as e:
                await self._send_text(writer, e.status, e.text)
                return
            # a body the handler left unread (an over-cap POST, a GET with
            # a body) is drained if small, else the connection closes
            if not body.done and not await body.drain(self.cfg.max_body_bytes):
                keep = False
            await self._send(writer, status, payload, ctype, keep, version,
                             head_only=method == "HEAD")
            if not keep:
                return

    @staticmethod
    def _parse_head(head: bytes) -> Tuple[str, str, str, Dict[str, str]]:
        try:
            text = head.decode("latin-1")
            line, *rest = text.split("\r\n")
            method, target, version = line.split(" ")
        except ValueError:
            raise _BadRequest(400, "400: Bad Request")
        if not version.startswith("HTTP/1."):
            raise _BadRequest(400, "400: Bad Request")
        headers: Dict[str, str] = {}
        for h in rest:
            k, sep, v = h.partition(":")
            if not sep:
                raise _BadRequest(400, "400: Bad Request")
            headers[k.strip().lower()] = v.strip()
        return method.upper(), target, version, headers

    async def _send(self, writer, status: int, payload: bytes, ctype: str, keep: bool,
                    version: str, head_only: bool = False) -> None:
        lines = [
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}",
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

    async def _send_text(self, writer, status: int, text: str) -> None:
        """A refused request's text answer; the connection then closes."""
        await self._send(writer, status, text.encode(), "text/plain; charset=utf-8",
                         False, "HTTP/1.1")

    # -- routing (the JAX server's aiohttp routes) --------------------------

    async def _route(self, method: str, target: str, body: _Body, source: str):
        url = urlsplit(target)
        path = unquote(url.path or "/")
        get = method in ("GET", "HEAD")
        if path == "/":
            if method != "POST":
                return 405, b"405: Method Not Allowed", "text/plain; charset=utf-8"
            return 200, *self._json(await self._handle_post(body, source))
        segment = path[1:]
        if "/" in segment or not segment:
            return 404, b"404: Not Found", "text/plain; charset=utf-8"
        if not get:
            return 405, b"405: Method Not Allowed", "text/plain; charset=utf-8"
        if segment == "websocket":
            return 501, *self._json(
                make_response(None, error=RPCError(METHOD_NOT_FOUND, WEBSOCKET_DEVIATION))
            )
        if segment == "openapi.json":
            return 200, *self._json(self._openapi())
        params = {k: _coerce_uri_param(v)
                  for k, v in parse_qsl(url.query, keep_blank_values=True)}
        return 200, *self._json(await self._handle_get(segment, params, source))

    @staticmethod
    def _json(data: Any) -> Tuple[bytes, str]:
        return json.dumps(data).encode(), "application/json; charset=utf-8"

    # -- HTTP POST: JSON-RPC (single or batch) ----------------------------

    async def _handle_post(self, body: _Body, source: str) -> Any:
        try:
            raw = await read_bounded_body(body, self.cfg.max_body_bytes)
        except RPCError as e:
            return make_response(None, error=e)
        try:
            payload = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            return make_response(None, error=RPCError(PARSE_ERROR, "invalid JSON"))
        if isinstance(payload, list):  # batch (http_json_handler.go:66)
            if len(payload) > self.cfg.max_batch_request_items:
                # one POST must not fan out into thousands of handler tasks
                return make_response(
                    None,
                    error=RPCError(
                        INVALID_REQUEST,
                        f"batch of {len(payload)} exceeds "
                        f"{self.cfg.max_batch_request_items} requests",
                    ),
                )
            return list(await asyncio.gather(*(self._dispatch(r, source) for r in payload)))
        return await self._dispatch(payload, source)

    async def _dispatch(self, req: Any, source: str = "") -> dict:
        if not isinstance(req, dict) or "method" not in req:
            return make_response(None, error=RPCError(INVALID_REQUEST, "malformed request"))
        req_id = req.get("id")
        method = req["method"]
        params = from_jsonable(req.get("params") or {})
        if not isinstance(params, dict):
            return make_response(
                req_id, error=RPCError(INVALID_PARAMS, "params must be an object")
            )
        if method in ("subscribe", "unsubscribe", "unsubscribe_all"):
            return make_response(
                req_id,
                error=RPCError(
                    METHOD_NOT_FOUND, f"{method} is only available over /websocket"
                ),
            )
        try:
            result = await self.core.call(method, params, source=source)
            return make_response(req_id, result)
        except RPCError as e:
            return make_response(req_id, error=e)

    # -- HTTP GET: URI params ---------------------------------------------

    def _openapi(self) -> dict:
        """rpc/swagger flavor — spec generated from the route table."""
        from ..version import VERSION
        from .openapi import generate_spec

        return generate_spec(VERSION)

    async def _handle_get(self, method: str, params: dict, source: str) -> dict:
        if method in ("subscribe", "unsubscribe", "unsubscribe_all"):
            return make_response(-1, error=RPCError(METHOD_NOT_FOUND, "use /websocket"))
        try:
            result = await self.core.call(method, params, source=source)
            return make_response(-1, result)
        except RPCError as e:
            return make_response(-1, error=e)
