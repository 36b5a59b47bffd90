"""ABCI clients: in-proc local and socket (the port's copy of
tendermint_tpu/abci/client.py).

Reference parity: abci/client/client.go (Client iface:21),
local_client.go (in-proc, one mutex), socket_client.go (varint-framed
request/response pipeline over TCP/unix — the process boundary).

Async surface only: the reference's *Async/*Sync split exists because Go
callers block; here every method is a coroutine and concurrency comes from
the event loop.  Per-connection ordering (the property the reference gets
from its single request queue) comes from an asyncio.Lock per client.
Socket frames are a uvarint length and a msgpack body written by the
port's own encoding/msgpack.py: the bytes equal the JAX package's, so
either package's client talks to the other's server.  The gRPC transport
is abci/grpc.py.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..encoding import msgpack
from ..encoding.varint import decode_uvarint_stream, encode_uvarint
from ..libs.service import Service
from . import types as t


class Client(Service):
    """Async ABCI client interface."""

    async def echo(self, message: str) -> t.ResponseEcho:
        raise NotImplementedError

    async def flush(self) -> None:
        raise NotImplementedError

    async def info(self, req: t.RequestInfo) -> t.ResponseInfo:
        raise NotImplementedError

    async def set_option(self, req: t.RequestSetOption) -> t.ResponseSetOption:
        raise NotImplementedError

    async def init_chain(self, req: t.RequestInitChain) -> t.ResponseInitChain:
        raise NotImplementedError

    async def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        raise NotImplementedError

    async def begin_block(self, req: t.RequestBeginBlock) -> t.ResponseBeginBlock:
        raise NotImplementedError

    async def check_tx(self, req: t.RequestCheckTx) -> t.ResponseCheckTx:
        raise NotImplementedError

    async def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        raise NotImplementedError

    async def end_block(self, req: t.RequestEndBlock) -> t.ResponseEndBlock:
        raise NotImplementedError

    async def commit(self) -> t.ResponseCommit:
        raise NotImplementedError

    async def list_snapshots(self, req: t.RequestListSnapshots) -> t.ResponseListSnapshots:
        raise NotImplementedError

    async def offer_snapshot(self, req: t.RequestOfferSnapshot) -> t.ResponseOfferSnapshot:
        raise NotImplementedError

    async def load_snapshot_chunk(
        self, req: t.RequestLoadSnapshotChunk
    ) -> t.ResponseLoadSnapshotChunk:
        raise NotImplementedError

    async def apply_snapshot_chunk(
        self, req: t.RequestApplySnapshotChunk
    ) -> t.ResponseApplySnapshotChunk:
        raise NotImplementedError


class LocalClient(Client):
    """Wraps an in-proc Application (abci/client/local_client.go).  One
    lock serializes calls, mirroring the reference's global mutex."""

    def __init__(self, app: t.Application, lock: Optional[asyncio.Lock] = None):
        super().__init__("abci-local-client")
        self.app = app
        # Sharing one lock across the three node connections reproduces the
        # reference's tmsync.Mutex in NewLocalClientCreator.
        self._lock = lock or asyncio.Lock()

    async def _call(self, fn, req):
        async with self._lock:
            return fn(req)

    async def echo(self, message: str) -> t.ResponseEcho:
        return await self._call(self.app.echo, t.RequestEcho(message))

    async def flush(self) -> None:
        return None

    async def info(self, req: t.RequestInfo) -> t.ResponseInfo:
        return await self._call(self.app.info, req)

    async def set_option(self, req: t.RequestSetOption) -> t.ResponseSetOption:
        return await self._call(self.app.set_option, req)

    async def init_chain(self, req: t.RequestInitChain) -> t.ResponseInitChain:
        return await self._call(self.app.init_chain, req)

    async def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        return await self._call(self.app.query, req)

    async def begin_block(self, req: t.RequestBeginBlock) -> t.ResponseBeginBlock:
        return await self._call(self.app.begin_block, req)

    async def check_tx(self, req: t.RequestCheckTx) -> t.ResponseCheckTx:
        return await self._call(self.app.check_tx, req)

    async def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        return await self._call(self.app.deliver_tx, req)

    async def end_block(self, req: t.RequestEndBlock) -> t.ResponseEndBlock:
        return await self._call(self.app.end_block, req)

    async def commit(self) -> t.ResponseCommit:
        return await self._call(self.app.commit, t.RequestCommit())

    async def list_snapshots(self, req: t.RequestListSnapshots) -> t.ResponseListSnapshots:
        return await self._call(self.app.list_snapshots, req)

    async def offer_snapshot(self, req: t.RequestOfferSnapshot) -> t.ResponseOfferSnapshot:
        return await self._call(self.app.offer_snapshot, req)

    async def load_snapshot_chunk(
        self, req: t.RequestLoadSnapshotChunk
    ) -> t.ResponseLoadSnapshotChunk:
        return await self._call(self.app.load_snapshot_chunk, req)

    async def apply_snapshot_chunk(
        self, req: t.RequestApplySnapshotChunk
    ) -> t.ResponseApplySnapshotChunk:
        return await self._call(self.app.apply_snapshot_chunk, req)


# ---------------------------------------------------------------------------
# socket framing: uvarint length prefix + msgpack body
# ---------------------------------------------------------------------------


async def read_frame(reader: asyncio.StreamReader) -> dict:
    length = await decode_uvarint_stream(reader)
    body = await reader.readexactly(length)
    return msgpack.unpackb(body)


def write_frame(writer: asyncio.StreamWriter, payload: dict) -> None:
    body = msgpack.packb(payload)
    writer.write(encode_uvarint(len(body)) + body)


class SocketClient(Client):
    """Out-of-process app over TCP/unix socket
    (abci/client/socket_client.go — the process boundary).  Requests are
    written in order; responses resolve futures FIFO, matching the
    reference's reqSent queue discipline."""

    def __init__(self, address: str):
        super().__init__("abci-socket-client")
        self.address = address
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._inflight: asyncio.Queue = asyncio.Queue()
        self._recv_task: Optional[asyncio.Task] = None
        self._write_lock = asyncio.Lock()

    async def on_start(self) -> None:
        if self.address.startswith("unix://"):
            self._reader, self._writer = await asyncio.open_unix_connection(self.address[7:])
        else:
            addr = self.address
            if addr.startswith("tcp://"):
                addr = addr[6:]
            host, port = addr.rsplit(":", 1)
            self._reader, self._writer = await asyncio.open_connection(host, int(port))
        self._recv_task = asyncio.create_task(self._recv_loop())

    async def on_stop(self) -> None:
        if self._recv_task:
            self._recv_task.cancel()
        if self._writer:
            self._writer.close()

    async def _recv_loop(self) -> None:
        try:
            while True:
                frame = await read_frame(self._reader)
                kind, resp = t.decode_msg(frame, direction=1)
                fut, want_kind = await self._inflight.get()
                if kind == "exception":
                    fut.set_exception(RuntimeError(f"abci exception: {resp.error}"))
                elif kind != want_kind:
                    fut.set_exception(
                        RuntimeError(f"unexpected response {kind}, expected {want_kind}")
                    )
                else:
                    fut.set_result(resp)
        except (asyncio.CancelledError, asyncio.IncompleteReadError, ConnectionError):
            while not self._inflight.empty():
                fut, _ = self._inflight.get_nowait()
                if not fut.done():
                    fut.set_exception(ConnectionError("abci socket closed"))

    async def _request(self, kind: str, req):
        fut = asyncio.get_event_loop().create_future()
        async with self._write_lock:
            await self._inflight.put((fut, kind))
            write_frame(self._writer, t.encode_msg(kind, req))
            await self._writer.drain()
        return await fut

    async def echo(self, message: str) -> t.ResponseEcho:
        return await self._request("echo", t.RequestEcho(message))

    async def flush(self) -> None:
        await self._request("flush", t.RequestFlush())

    async def info(self, req: t.RequestInfo) -> t.ResponseInfo:
        return await self._request("info", req)

    async def set_option(self, req: t.RequestSetOption) -> t.ResponseSetOption:
        return await self._request("set_option", req)

    async def init_chain(self, req: t.RequestInitChain) -> t.ResponseInitChain:
        return await self._request("init_chain", req)

    async def query(self, req: t.RequestQuery) -> t.ResponseQuery:
        return await self._request("query", req)

    async def begin_block(self, req: t.RequestBeginBlock) -> t.ResponseBeginBlock:
        return await self._request("begin_block", req)

    async def check_tx(self, req: t.RequestCheckTx) -> t.ResponseCheckTx:
        return await self._request("check_tx", req)

    async def deliver_tx(self, req: t.RequestDeliverTx) -> t.ResponseDeliverTx:
        return await self._request("deliver_tx", req)

    async def end_block(self, req: t.RequestEndBlock) -> t.ResponseEndBlock:
        return await self._request("end_block", req)

    async def commit(self) -> t.ResponseCommit:
        return await self._request("commit", t.RequestCommit())

    async def list_snapshots(self, req: t.RequestListSnapshots) -> t.ResponseListSnapshots:
        return await self._request("list_snapshots", req)

    async def offer_snapshot(self, req: t.RequestOfferSnapshot) -> t.ResponseOfferSnapshot:
        return await self._request("offer_snapshot", req)

    async def load_snapshot_chunk(
        self, req: t.RequestLoadSnapshotChunk
    ) -> t.ResponseLoadSnapshotChunk:
        return await self._request("load_snapshot_chunk", req)

    async def apply_snapshot_chunk(
        self, req: t.RequestApplySnapshotChunk
    ) -> t.ResponseApplySnapshotChunk:
        return await self._request("apply_snapshot_chunk", req)
