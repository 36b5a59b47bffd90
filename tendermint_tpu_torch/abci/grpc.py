"""ABCI over gRPC (the port's copy of tendermint_tpu/abci/grpc.py, on the
port's own HTTP/2 and gRPC in rpc/grpc.py, where the JAX package's runs on
grpcio).

Reference parity: abci/server/grpc_server.go:16 + abci/client/grpc_client.go:34
— the second ABCI transport next to the socket server.

Service `tendermint.abci.types.ABCIApplication` with the JAX package's 15
methods, camel-cased; each message is the msgpack of `types.encode_msg`
through the port's codec, so either package's client calls the other's
server (tests/test_torch_grpc.py).
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..encoding import codec
from ..libs.log import get_logger
from ..libs.service import Service
from ..rpc.grpc import Channel, Server, UnaryMethod
from . import types as t
from .client import Client

SERVICE = "tendermint.abci.types.ABCIApplication"

_METHODS = (
    "echo",
    "flush",
    "info",
    "set_option",
    "init_chain",
    "query",
    "begin_block",
    "check_tx",
    "deliver_tx",
    "end_block",
    "commit",
    "list_snapshots",
    "offer_snapshot",
    "load_snapshot_chunk",
    "apply_snapshot_chunk",
)


def _camel(snake: str) -> str:
    return "".join(w.capitalize() for w in snake.split("_"))


class GRPCServer(Service):
    """abci/server/grpc_server.go:16 — serves an Application over gRPC."""

    def __init__(self, address: str, app: t.Application):
        super().__init__("abci-grpc-server")
        self.address = address.split("://")[-1]
        self.app = app
        self.log = get_logger("abci-grpc")
        self._server: Optional[Server] = None
        self.bound_addr: str = ""

    async def on_start(self) -> None:
        server = Server(logger="abci-grpc")

        def make_handler(name):
            async def handler(request: dict):
                kind, req = t.decode_msg(dict(request), direction=0)
                if kind == "flush":
                    return t.encode_msg("flush", t.ResponseFlush())
                return t.encode_msg(kind, getattr(self.app, name)(req))

            return handler

        server.add_service(SERVICE, {
            _camel(name): UnaryMethod(make_handler(name), codec.loads, codec.dumps)
            for name in _METHODS
        })
        self.bound_addr = await server.start(self.address)
        self._server = server
        self.log.info("abci grpc serving", addr=self.bound_addr)

    async def on_stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)


class GRPCClient(Client):
    """abci/client/grpc_client.go:34 — the node-side ABCI client over gRPC.

    Same interface as SocketClient/LocalClient.  Calls are serialized with
    a lock, as the JAX client's are: concurrent unary calls would ride
    independent HTTP/2 streams and could reach the app out of issue order,
    breaking order-sensitive apps that the socket transport's FIFO framing
    supports."""

    def __init__(self, address: str):
        super().__init__("abci-grpc-client")
        self.address = address.split("://")[-1]
        self.channel: Optional[Channel] = None
        self._stubs = {}
        self._lock: Optional[asyncio.Lock] = None  # created lazily on the serving loop

    async def on_start(self) -> None:
        self.channel = Channel(self.address)

    async def on_stop(self) -> None:
        if self.channel is not None:
            await self.channel.close()

    def _stub(self, name: str):
        if name not in self._stubs:
            self._stubs[name] = self.channel.unary_unary(
                f"/{SERVICE}/{_camel(name)}", codec.dumps, codec.loads)
        return self._stubs[name]

    async def _call(self, kind: str, req):
        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            resp = await self._stub(kind)(t.encode_msg(kind, req))
        _, res = t.decode_msg(dict(resp), direction=1)
        return res

    # -- the 15 methods ------------------------------------------------------

    async def echo(self, message: str) -> t.ResponseEcho:
        return await self._call("echo", t.RequestEcho(message=message))

    async def flush(self) -> None:
        await self._stub("flush")(t.encode_msg("flush", t.RequestFlush()))

    async def info(self, req: t.RequestInfo) -> t.ResponseInfo:
        return await self._call("info", req)

    async def set_option(self, req: t.RequestSetOption) -> t.ResponseSetOption:
        return await self._call("set_option", req)

    async def init_chain(self, req: t.RequestInitChain) -> t.ResponseInitChain:
        return await self._call("init_chain", req)

    async def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        return await self._call("query", req)

    async def begin_block(self, req: t.RequestBeginBlock) -> t.ResponseBeginBlock:
        return await self._call("begin_block", req)

    async def check_tx(self, req: t.RequestCheckTx) -> t.ResponseCheckTx:
        return await self._call("check_tx", req)

    async def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        return await self._call("deliver_tx", req)

    async def end_block(self, req: t.RequestEndBlock) -> t.ResponseEndBlock:
        return await self._call("end_block", req)

    async def commit(self) -> t.ResponseCommit:
        return await self._call("commit", t.RequestCommit())

    async def list_snapshots(self, req: t.RequestListSnapshots) -> t.ResponseListSnapshots:
        return await self._call("list_snapshots", req)

    async def offer_snapshot(self, req: t.RequestOfferSnapshot) -> t.ResponseOfferSnapshot:
        return await self._call("offer_snapshot", req)

    async def load_snapshot_chunk(
        self, req: t.RequestLoadSnapshotChunk
    ) -> t.ResponseLoadSnapshotChunk:
        return await self._call("load_snapshot_chunk", req)

    async def apply_snapshot_chunk(
        self, req: t.RequestApplySnapshotChunk
    ) -> t.ResponseApplySnapshotChunk:
        return await self._call("apply_snapshot_chunk", req)
