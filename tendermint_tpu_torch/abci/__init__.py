"""ABCI: the application boundary (the port's copy of tendermint_tpu/abci;
its gRPC transport, abci/grpc.py, runs on the port's own HTTP/2 and gRPC).

Counterpart of the reference `abci/` tree: typed request/response surface
for the 12 methods (abci/types/types.proto), in-proc and socket
client/server (abci/client/, abci/server/), and the kvstore/counter
example apps (abci/example/).
"""

from .types import (
    Application,
    BaseApplication,
    Event,
    RequestBeginBlock,
    RequestCheckTx,
    RequestCommit,
    RequestDeliverTx,
    RequestEndBlock,
    RequestEcho,
    RequestInfo,
    RequestInitChain,
    RequestQuery,
    RequestSetOption,
    ResponseBeginBlock,
    ResponseCheckTx,
    ResponseCommit,
    ResponseDeliverTx,
    ResponseEndBlock,
    ResponseEcho,
    ResponseInfo,
    ResponseInitChain,
    ResponseQuery,
    ResponseSetOption,
    ValidatorUpdate,
    CheckTxType,
    CODE_TYPE_OK,
)
from .client import Client, LocalClient, SocketClient
from .server import SocketServer

__all__ = [n for n in dir() if not n.startswith("_")]
