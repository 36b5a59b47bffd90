"""WebSocket (RFC 6455) on asyncio streams, both ends: the server's upgrade
of an HTTP request (rpc/http.py) and the client's handshake, then framing.
The JAX package runs its /websocket endpoint and WSClient on aiohttp; the
card's machine has no aiohttp, and hashlib.sha1 with base64 is all the
handshake needs.

Framing: text, binary and continuation frames (a fragmented message is
joined before it is handed over), ping answered by pong, pong ignored, and
the close handshake (a received close is echoed with its code, a sent one
waits briefly for the echo).  A client masks every frame it sends and a
server accepts only masked frames (RFC 6455 5.1; else close 1002).  A
message longer than `max_size` closes the connection with 1009, as
aiohttp's `max_msg_size` does.  No extension is negotiated, so an aiohttp
peer that offers permessage-deflate sends plain frames.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import hashlib
import json
import os
import struct
from typing import Any, Optional, Tuple

from .http import BadRequest, read_response_head

GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

CONTINUATION, TEXT, BINARY, CLOSE, PING, PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA

CLOSE_OK = 1000
CLOSE_GOING_AWAY = 1001
CLOSE_PROTOCOL_ERROR = 1002
CLOSE_INVALID_DATA = 1007
CLOSE_MESSAGE_TOO_BIG = 1009

DEFAULT_MAX_SIZE = 4 * 1024 * 1024  # aiohttp's max_msg_size default
CLOSE_WAIT_S = 2.0


class WSHandshakeError(ConnectionError):
    """The server refused the upgrade: its status and body text."""

    def __init__(self, status: int, text: str):
        super().__init__(f"websocket handshake refused: {status} {text}")
        self.status = status
        self.text = text


class _ProtocolError(Exception):
    def __init__(self, code: int, text: str):
        super().__init__(text)
        self.code = code


def accept_key(key: str) -> str:
    """Sec-WebSocket-Accept for a Sec-WebSocket-Key (RFC 6455 4.2.2)."""
    return base64.b64encode(hashlib.sha1(key.encode() + GUID).digest()).decode()


def mask(data: bytes, key: bytes) -> bytes:
    """XOR with the repeated 4-byte key (its own inverse)."""
    n = len(data)
    if not n:
        return data
    stream = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little") ^ int.from_bytes(stream, "little")).to_bytes(
        n, "little")


def encode_frame(opcode: int, payload: bytes, masked: bool, fin: bool = True) -> bytes:
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    bit = 0x80 if masked else 0
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(bit | 127)
        head += struct.pack("!Q", n)
    if masked:
        key = os.urandom(4)
        return bytes(head) + key + mask(payload, key)
    return bytes(head) + payload


def handshake_error(headers: dict) -> Optional[str]:
    """Why an upgrade request is refused (aiohttp's texts), or None."""
    upgrade = headers.get("upgrade")
    if (upgrade or "").lower().strip() != "websocket":
        return (f"No WebSocket UPGRADE hdr: {upgrade}\n Can "
                '"Upgrade" only to "WebSocket".')
    if "upgrade" not in headers.get("connection", "").lower():
        return f"No CONNECTION upgrade hdr: {headers.get('connection')}"
    version = headers.get("sec-websocket-version", "")
    if version not in ("13", "8", "7"):
        return f"Unsupported version: {version}"
    key = headers.get("sec-websocket-key")
    try:
        if not key or len(base64.b64decode(key)) != 16:
            return f"Handshake error: {key!r}"
    except binascii.Error:
        return f"Handshake error: {key!r}"
    return None


class WebSocket:
    """One open WebSocket connection (either end)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 client: bool, max_size: int = DEFAULT_MAX_SIZE):
        self.reader = reader
        self.writer = writer
        self.client = client
        self.max_size = max_size
        self.close_code: Optional[int] = None
        self._close_sent = False
        self._send_lock = asyncio.Lock()
        self._reading = False  # a receive() is waiting on the stream
        self._closed_evt = asyncio.Event()

    @property
    def closed(self) -> bool:
        return self.close_code is not None

    def _set_closed(self, code: int) -> None:
        if self.close_code is None:
            self.close_code = code
        self._closed_evt.set()

    # -- sending -----------------------------------------------------------

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self._close_sent:
            raise ConnectionResetError("websocket is closing")
        frame = encode_frame(opcode, payload, masked=self.client)
        async with self._send_lock:
            self.writer.write(frame)
            await self.writer.drain()

    async def send_str(self, text: str) -> None:
        await self._send_frame(TEXT, text.encode())

    async def send_json(self, data: Any) -> None:
        await self.send_str(json.dumps(data))

    async def _send_close(self, code: int) -> None:
        if self._close_sent:
            return
        self._close_sent = True
        frame = encode_frame(CLOSE, struct.pack("!H", code), masked=self.client)
        try:
            async with self._send_lock:
                self.writer.write(frame)
                await self.writer.drain()
        except (ConnectionError, RuntimeError):
            pass

    async def close(self, code: int = CLOSE_OK) -> None:
        """Send a close frame, wait briefly for the peer's, and close the
        connection."""
        if self.close_code is None:
            await self._send_close(code)
            # the peer's echo: read here, or by the receive() already reading
            wait = self._closed_evt.wait() if self._reading else self._await_close()
            try:
                await asyncio.wait_for(wait, CLOSE_WAIT_S)
            except (asyncio.TimeoutError, ConnectionError, asyncio.IncompleteReadError,
                    _ProtocolError):
                pass
            self._set_closed(code)
        self.writer.close()

    async def _await_close(self) -> None:
        while self.close_code is None:
            await self._read_frame()

    # -- receiving ---------------------------------------------------------

    async def _read_frame(self) -> Tuple[bool, int, bytes]:
        b0, b1 = await self.reader.readexactly(2)
        fin, opcode = bool(b0 & 0x80), b0 & 0x0F
        if b0 & 0x70:
            raise _ProtocolError(CLOSE_PROTOCOL_ERROR, "reserved bits set")
        masked, n = bool(b1 & 0x80), b1 & 0x7F
        if masked == self.client:
            raise _ProtocolError(CLOSE_PROTOCOL_ERROR,
                                 "masked frame from a server" if self.client
                                 else "unmasked frame from a client")
        if n == 126:
            n = struct.unpack("!H", await self.reader.readexactly(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", await self.reader.readexactly(8))[0]
        if opcode >= CLOSE and (n > 125 or not fin):
            raise _ProtocolError(CLOSE_PROTOCOL_ERROR, "bad control frame")
        if n > self.max_size:
            raise _ProtocolError(CLOSE_MESSAGE_TOO_BIG, f"frame of {n} bytes")
        key = await self.reader.readexactly(4) if masked else b""
        payload = await self.reader.readexactly(n)
        if masked:
            payload = mask(payload, key)
        if opcode == CLOSE:
            code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else CLOSE_OK
            await self._send_close(code)  # the echo
            self._set_closed(code)
        return fin, opcode, payload

    async def receive(self) -> Optional[Tuple[int, bytes]]:
        """The next data message as (TEXT or BINARY, payload), or None once
        the connection is closed (close_code says how).  Pings are answered
        here; a protocol error or an oversized message closes with its code."""
        parts = []
        kind = None
        size = 0
        self._reading = True
        try:
            while True:
                if self.close_code is not None:
                    return None
                fin, opcode, payload = await self._read_frame()
                if opcode == CLOSE:
                    self.writer.close()
                    return None
                if opcode == PING:
                    await self._send_frame(PONG, payload)
                    continue
                if opcode == PONG:
                    continue
                if opcode in (TEXT, BINARY):
                    if kind is not None:
                        raise _ProtocolError(CLOSE_PROTOCOL_ERROR, "message inside a message")
                    kind = opcode
                elif opcode == CONTINUATION:
                    if kind is None:
                        raise _ProtocolError(CLOSE_PROTOCOL_ERROR, "continuation of nothing")
                else:
                    raise _ProtocolError(CLOSE_PROTOCOL_ERROR, f"opcode {opcode}")
                size += len(payload)
                if size > self.max_size:
                    raise _ProtocolError(CLOSE_MESSAGE_TOO_BIG, f"message over {self.max_size}")
                parts.append(payload)
                if fin:
                    return kind, b"".join(parts)
        except _ProtocolError as e:
            await self._send_close(e.code)
            self._set_closed(e.code)
            self.writer.close()
            return None
        except (ConnectionError, asyncio.IncompleteReadError):
            self._set_closed(1006)  # abnormal closure: no close frame
            self.writer.close()
            return None
        finally:
            self._reading = False

    async def receive_text(self) -> Optional[str]:
        """The next text message (binary messages are skipped), or None."""
        while True:
            msg = await self.receive()
            if msg is None:
                return None
            if msg[0] == TEXT:
                try:
                    return msg[1].decode()
                except UnicodeDecodeError:
                    await self._send_close(CLOSE_INVALID_DATA)
                    self._set_closed(CLOSE_INVALID_DATA)
                    self.writer.close()
                    return None


async def server_upgrade(req, max_size: int) -> WebSocket:
    """Answer an HTTP upgrade request (rpc/http.Request) with 101 and
    return the server end; raises http.BadRequest(400, aiohttp's text)
    for a request that is no valid upgrade."""
    err = handshake_error(req.headers)
    if err is not None:
        raise BadRequest(400, err)
    head = (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept_key(req.headers['sec-websocket-key'])}\r\n\r\n"
    )
    req.writer.write(head.encode("latin-1"))
    await req.writer.drain()
    return WebSocket(req.reader, req.writer, client=False, max_size=max_size)


async def connect(host: str, port: int, path: str = "/websocket",
                  max_size: int = DEFAULT_MAX_SIZE) -> WebSocket:
    """Open a client WebSocket to ws://host:port/path; raises
    WSHandshakeError when the server refuses the upgrade."""
    reader, writer = await asyncio.open_connection(host, port, limit=1 << 20)
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write((
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}:{port}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n"
    ).encode("latin-1"))
    try:
        await writer.drain()
        status, headers = await read_response_head(reader)
        if status != 101:
            n = int(headers.get("content-length", "0") or 0)
            text = (await reader.readexactly(n)).decode(errors="replace") if n else ""
            raise WSHandshakeError(status, text)
        if headers.get("sec-websocket-accept") != accept_key(key):
            raise WSHandshakeError(status, "wrong Sec-WebSocket-Accept")
    except BaseException:
        writer.close()
        raise
    return WebSocket(reader, writer, client=True, max_size=max_size)
