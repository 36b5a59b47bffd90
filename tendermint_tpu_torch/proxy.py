"""Proxy: the node's three named connections to one app (the port's copy of
tendermint_tpu/proxy.py).

Reference parity: proxy/ (AppConns multi_app_conn.go — consensus/mempool/
query connections; ClientCreator client.go with local in-proc creators for
the builtin kvstore/counter/noop apps and remote socket otherwise;
interface-narrowing wrappers app_conn.go:11,23,33).  A remote app is
reached over the ABCI socket or, with `abci = "grpc"`, over gRPC
(abci/grpc.py).
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from .abci.client import Client, LocalClient, SocketClient
from .abci.examples import CounterApplication, KVStoreApplication
from .abci.types import Application, BaseApplication
from .libs.service import Service

ClientCreator = Callable[[], Client]


def local_client_creator(app: Application) -> ClientCreator:
    """In-proc app shared by all three connections behind one lock
    (proxy/client.go NewLocalClientCreator)."""
    lock = asyncio.Lock()
    return lambda: LocalClient(app, lock)


def remote_client_creator(address: str, transport: str = "socket") -> ClientCreator:
    """One client per connection to the app at `address`: a SocketClient,
    or a GRPCClient for transport "grpc" (proxy/client.go
    NewRemoteClientCreator)."""
    if transport == "grpc":
        from .abci.grpc import GRPCClient

        return lambda: GRPCClient(address)
    return lambda: SocketClient(address)


def default_client_creator(
    address: str,
    transport: str = "socket",
    app_db=None,
    snapshot_interval: int = 0,
    snapshot_chunk_bytes: int = 65536,
    snapshot_keep_recent: int = 2,
) -> ClientCreator:
    """proxy/client.go DefaultClientCreator: builtin names get in-proc
    apps, anything else is a socket (or, per config `abci = "grpc"`,
    gRPC) address.  The node passes
    `app_db` (a KVStore under home/data) so the builtin kvstore survives
    restarts — required for statesync crash recovery, where the restored
    app state must outlive the process — plus the `[statesync]
    snapshot_interval` producing snapshots every N heights."""
    if address == "kvstore":
        return local_client_creator(
            KVStoreApplication(
                db=app_db,
                snapshot_interval=snapshot_interval,
                snapshot_chunk_bytes=snapshot_chunk_bytes,
                snapshot_keep_recent=snapshot_keep_recent,
            )
        )
    if address == "bank":
        from .apps.bank import BankApplication

        return local_client_creator(BankApplication(db=app_db))
    if address == "staking":
        from .apps.staking import StakingApplication

        return local_client_creator(StakingApplication(db=app_db))
    if address == "counter":
        return local_client_creator(CounterApplication())
    if address == "counter_serial":
        return local_client_creator(CounterApplication(serial=True))
    if address == "noop":
        return local_client_creator(BaseApplication())
    return remote_client_creator(address, transport)


class AppConns(Service):
    """Three connections: consensus (block execution), mempool (CheckTx),
    query (Info/Query) — proxy/multi_app_conn.go."""

    def __init__(self, creator: ClientCreator):
        super().__init__("proxy-app-conns")
        self.creator = creator
        self._consensus: Optional[Client] = None
        self._mempool: Optional[Client] = None
        self._query: Optional[Client] = None

    async def on_start(self) -> None:
        self._query = self.creator()
        await self._query.start()
        self._mempool = self.creator()
        await self._mempool.start()
        self._consensus = self.creator()
        await self._consensus.start()

    async def on_stop(self) -> None:
        for c in (self._consensus, self._mempool, self._query):
            if c is not None and c.is_running:
                await c.stop()

    def consensus(self) -> Client:
        return self._consensus

    def mempool(self) -> Client:
        return self._mempool

    def query(self) -> Client:
        return self._query
