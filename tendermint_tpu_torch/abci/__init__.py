"""ABCI: the application boundary (the port's copy of tendermint_tpu/abci,
without the socket and gRPC transports).

Counterpart of the reference `abci/` tree: typed request/response surface
for the 12 methods (abci/types/types.proto), the in-proc client
(abci/client/local_client.go), and the kvstore/counter example apps
(abci/example/).
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
from .client import Client, LocalClient

__all__ = [n for n in dir() if not n.startswith("_")]
