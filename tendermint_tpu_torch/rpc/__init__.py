"""JSON-RPC API layer (reference: rpc/), the port's copy of
tendermint_tpu/rpc on asyncio streams.

- jsonrpc: envelope + JSON-safe codec for domain types
- core:    route handlers reading node internals (rpc/core/routes.go:10-56)
- server:  HTTP server (rpc/lib/server/); /websocket waits (ROADMAP 1.7.3)
- client:  HTTP / in-proc Local clients (rpc/client/, rpc/lib/client/)
"""

from .client import HTTPClient, LocalClient  # noqa: F401
from .core import RPCCore  # noqa: F401
from .jsonrpc import RPCError, from_jsonable, to_jsonable  # noqa: F401
from .server import RPCServer  # noqa: F401
