"""Transport: TCP listen/dial + connection upgrade (the port's copy of
tendermint_tpu/p2p/transport.py; the NodeInfo exchange runs on the port's
encoding/msgpack.py, whose bytes are the `msgpack` package's).

Reference parity: p2p/transport.go (MultiplexTransport:127, upgrade:376 =
SecretConnection handshake + NodeInfo exchange :504 + filters).
"""

from __future__ import annotations

import asyncio
from typing import Optional, Tuple

from ..encoding import msgpack
from ..libs.log import get_logger
from .conn.secret_connection import SecretConnection
from .key import NodeKey, node_id_from_pubkey
from .node_info import NodeInfo

HANDSHAKE_TIMEOUT = 20.0
DIAL_TIMEOUT = 3.0


class TransportError(Exception):
    pass


class Transport:
    def __init__(self, node_key: NodeKey, node_info: NodeInfo, handshake_timeout: float = HANDSHAKE_TIMEOUT):
        self.node_key = node_key
        self.node_info = node_info
        self.handshake_timeout = handshake_timeout
        self.log = get_logger("p2p-transport")
        self._server: Optional[asyncio.AbstractServer] = None
        self._accept_queue: asyncio.Queue = asyncio.Queue(maxsize=64)
        self.listen_addr = ""

    # -- listening ---------------------------------------------------------
    async def listen(self, addr: str) -> str:
        """Start accepting; returns the bound address (port 0 resolved)."""
        host, port = _split_addr(addr)
        self._server = await asyncio.start_server(self._on_accept, host, port)
        sock = self._server.sockets[0]
        bound = sock.getsockname()
        self.listen_addr = f"{bound[0]}:{bound[1]}"
        self.node_info.listen_addr = self.listen_addr
        return self.listen_addr

    async def _on_accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            upgraded = await asyncio.wait_for(
                self._upgrade(reader, writer), self.handshake_timeout
            )
            await self._accept_queue.put(upgraded)
        except Exception as e:
            self.log.debug("inbound upgrade failed", err=str(e))
            writer.close()

    async def accept(self) -> Tuple[SecretConnection, NodeInfo]:
        """Next fully-upgraded inbound connection."""
        return await self._accept_queue.get()

    # -- dialing -----------------------------------------------------------
    async def dial(self, addr: str, expected_id: str = "") -> Tuple[SecretConnection, NodeInfo]:
        host, port = _split_addr(addr)
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), DIAL_TIMEOUT
        )
        try:
            conn, ni = await asyncio.wait_for(
                self._upgrade(reader, writer), self.handshake_timeout
            )
        except Exception:
            writer.close()  # reconnect loops must not leak sockets
            raise
        if expected_id and ni.node_id != expected_id:
            conn.close()
            raise TransportError(f"dialed {expected_id}, got {ni.node_id}")
        return conn, ni

    # -- upgrade: encrypt + identify (transport.go:376) --------------------
    async def _upgrade(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> Tuple[SecretConnection, NodeInfo]:
        conn = await SecretConnection.make(reader, writer, self.node_key.priv_key)
        peername = writer.get_extra_info("peername")
        # remote socket IP, for the switch's dup-IP filter (transport.go:376)
        conn.remote_ip = peername[0] if peername else ""

        # node-info handshake (transport.go:504): exchange concurrently
        await conn.write_msg(msgpack.packb(self.node_info.to_dict()))
        raw = await conn.read_msg(max_size=1024 * 1024)
        ni = NodeInfo.from_dict(msgpack.unpackb(raw))
        ni.validate_basic()

        # the claimed ID must match the secret-connection identity key
        secret_id = node_id_from_pubkey(conn.remote_pubkey)
        if ni.node_id != secret_id:
            conn.close()
            raise TransportError(f"node id {ni.node_id} does not match secret conn {secret_id}")
        if ni.node_id == self.node_info.node_id:
            conn.close()
            raise TransportError("connected to self")
        self.node_info.compatible_with(ni)
        return conn, ni

    def close(self) -> None:
        if self._server is not None:
            self._server.close()


def _split_addr(addr: str) -> Tuple[str, int]:
    for prefix in ("tcp://",):
        if addr.startswith(prefix):
            addr = addr[len(prefix):]
    if "@" in addr:  # id@host:port
        addr = addr.split("@", 1)[1]
    host, port = addr.rsplit(":", 1)
    return host, int(port)


def parse_peer_addr(addr: str) -> Tuple[str, str]:
    """'id@host:port' -> (id, 'host:port'); plain 'host:port' -> ('', ...)."""
    for prefix in ("tcp://",):
        if addr.startswith(prefix):
            addr = addr[len(prefix):]
    if "@" in addr:
        pid, hostport = addr.split("@", 1)
        return pid, hostport
    return "", addr
