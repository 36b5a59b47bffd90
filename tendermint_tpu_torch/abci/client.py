"""ABCI clients: the in-proc local client (the port's copy of the
`Client` interface and `LocalClient` of tendermint_tpu/abci/client.py).

Reference parity: abci/client/client.go (Client iface:21),
local_client.go (in-proc, one mutex).

Async surface only: the reference's *Async/*Sync split exists because Go
callers block; here every method is a coroutine and concurrency comes from
the event loop.  Per-connection ordering (the property the reference gets
from its single request queue) comes from an asyncio.Lock per client.
The socket and gRPC clients (the process boundary) are not ported yet
(ROADMAP 1.7): they frame messages with msgpack, which this package never
imports.
"""

from __future__ import annotations

import asyncio
from typing import Optional

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
