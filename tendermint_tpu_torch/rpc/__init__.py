"""JSON-RPC API layer (reference: rpc/), the port's copy of
tendermint_tpu/rpc on asyncio streams.

- jsonrpc:   envelope + JSON-safe codec for domain types
- core:      route handlers reading node internals (rpc/core/routes.go:10-56)
- http:      HTTP/1.1 on asyncio streams, under every server and client
- websocket: RFC 6455 framing and both handshakes
- server:    HTTP + WebSocket server (rpc/lib/server/)
- client:    HTTP / WebSocket / in-proc Local clients (rpc/client/, rpc/lib/client/)
- hpack, http2, grpc: RFC 7541, RFC 9113 (h2c) and gRPC unary calls on
             asyncio streams, under abci/grpc.py and grpc_api
- grpc_api:  the BroadcastAPI (Ping, BroadcastTx) on rpc.grpc_laddr
"""

from .client import HTTPClient, LocalClient, WSClient  # noqa: F401
from .core import RPCCore  # noqa: F401
from .jsonrpc import RPCError, from_jsonable, to_jsonable  # noqa: F401
from .server import RPCServer  # noqa: F401
