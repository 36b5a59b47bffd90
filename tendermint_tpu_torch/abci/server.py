"""ABCI socket server — the app side of the process boundary (the port's
copy of tendermint_tpu/abci/server.py; its frames are the port's
encoding/msgpack.py, byte-equal to the JAX package's).

Reference parity: abci/server/socket_server.go:17 (NewSocketServer:32).
Handles multiple connections (the node opens three), processing each
connection's requests strictly in order.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..libs.log import get_logger
from ..libs.service import Service
from . import types as t
from .client import read_frame, write_frame

_METHODS = {
    "echo": "echo",
    "info": "info",
    "set_option": "set_option",
    "init_chain": "init_chain",
    "query": "query",
    "begin_block": "begin_block",
    "check_tx": "check_tx",
    "deliver_tx": "deliver_tx",
    "end_block": "end_block",
    "commit": "commit",
    "list_snapshots": "list_snapshots",
    "offer_snapshot": "offer_snapshot",
    "load_snapshot_chunk": "load_snapshot_chunk",
    "apply_snapshot_chunk": "apply_snapshot_chunk",
}


class SocketServer(Service):
    def __init__(self, address: str, app: t.Application):
        super().__init__("abci-server")
        self.address = address
        self.app = app
        self.log = get_logger("abci-server")
        self._server: Optional[asyncio.AbstractServer] = None

    async def on_start(self) -> None:
        if self.address.startswith("unix://"):
            self._server = await asyncio.start_unix_server(self._handle, self.address[7:])
        else:
            addr = self.address
            if addr.startswith("tcp://"):
                addr = addr[6:]
            host, port = addr.rsplit(":", 1)
            self._server = await asyncio.start_server(self._handle, host, int(port))

    async def on_stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                frame = await read_frame(reader)
                kind, req = t.decode_msg(frame, direction=0)
                try:
                    if kind == "flush":
                        resp = t.ResponseFlush()
                    elif kind == "echo":
                        resp = self.app.echo(req)
                    else:
                        resp = getattr(self.app, _METHODS[kind])(req)
                    write_frame(writer, t.encode_msg(kind, resp))
                except Exception as e:  # app exception -> ResponseException
                    self.log.error("abci app error", method=kind, err=str(e))
                    write_frame(writer, t.encode_msg("exception", t.ResponseException(str(e))))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()
