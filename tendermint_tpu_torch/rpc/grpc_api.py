"""gRPC BroadcastAPI (the port's copy of tendermint_tpu/rpc/grpc_api.py,
on the port's own HTTP/2 and gRPC in rpc/grpc.py, where the JAX package's
runs on grpcio).

Reference parity: rpc/grpc/client_server.go:20 + rpc/grpc/api.go —
the minimal gRPC surface next to JSON-RPC: Ping and BroadcastTx
(CheckTx then DeliverTx result, the broadcast_tx_commit flavor).
Served when config `rpc.grpc_laddr` is set (node/node.go:766 area).

Messages are the msgpack of plain dicts through the port's codec, as in
the JAX package, so either package's client calls the other's server.
"""

from __future__ import annotations

from typing import Optional

from ..encoding import codec
from ..libs.log import get_logger
from ..libs.service import Service
from .grpc import Channel, Server, UnaryMethod

SERVICE = "tendermint.rpc.grpc.BroadcastAPI"


def _fields(obj) -> dict:
    """code, data and log of a response dataclass or plain dict."""
    get = obj.get if isinstance(obj, dict) else lambda k, d: getattr(obj, k, d)
    return {"code": get("code", 0), "data": get("data", b""), "log": get("log", "")}


class BroadcastAPIServer(Service):
    def __init__(self, node, listen_addr: str):
        super().__init__("rpc-grpc")
        self.node = node
        self.listen_addr = listen_addr.split("://")[-1]
        self.log = get_logger("rpc.grpc")
        self.server: Optional[Server] = None
        self.bound_addr = ""
        # ONE core for the server's lifetime: its _sub_seq numbers event-bus
        # subscribers, and per-request cores would collide on subscriber
        # names under concurrent BroadcastTx calls
        from .core import RPCCore

        self._core = RPCCore(node, timeout_broadcast_tx_commit=10.0)

    async def on_start(self) -> None:
        async def ping(request: dict) -> dict:
            return {}

        async def broadcast_tx(request: dict) -> dict:
            # rpc/grpc/api.go BroadcastTx — sync CheckTx, wait for commit
            res = await self._core.broadcast_tx_commit(tx=request.get("tx", b""))
            return {"check_tx": _fields(res["check_tx"]),
                    "deliver_tx": _fields(res["deliver_tx"])}

        server = Server(logger="rpc.grpc")
        server.add_service(SERVICE, {
            "Ping": UnaryMethod(ping, codec.loads, codec.dumps),
            "BroadcastTx": UnaryMethod(broadcast_tx, codec.loads, codec.dumps),
        })
        self.bound_addr = await server.start(self.listen_addr)
        self.server = server
        self.log.info("grpc broadcast api serving", addr=self.bound_addr)

    async def on_stop(self) -> None:
        if self.server is not None:
            await self.server.stop(grace=1.0)


class BroadcastAPIClient(Service):
    """rpc/grpc/client_server.go StartGRPCClient."""

    def __init__(self, address: str):
        super().__init__("rpc-grpc-client")
        self.address = address.split("://")[-1]
        self.channel: Optional[Channel] = None

    async def on_start(self) -> None:
        self.channel = Channel(self.address)

    async def on_stop(self) -> None:
        if self.channel is not None:
            await self.channel.close()

    def _stub(self, method: str):
        return self.channel.unary_unary(f"/{SERVICE}/{method}", codec.dumps, codec.loads)

    async def ping(self) -> dict:
        return await self._stub("Ping")({})

    async def broadcast_tx(self, tx: bytes) -> dict:
        return await self._stub("BroadcastTx")({"tx": tx})
