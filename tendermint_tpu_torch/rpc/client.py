"""RPC clients: HTTP, WebSocket, and in-proc Local (the port's copy of
tendermint_tpu/rpc/client.py, whose HTTPClient and WSClient run on aiohttp;
the card's machine has no aiohttp, so these run on rpc/http.py and
rpc/websocket.py).

Reference parity: rpc/client/http (HTTPClient), rpc/lib/client/ws_client.go
(WSClient with request/response correlation + event delivery),
rpc/client/local (Local wraps the node directly — used by lite2's provider
and tests).  All three expose the same method surface so callers (lite2,
state sync, the liteserve gateway, tests) are transport-agnostic.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, AsyncIterator, Dict, Optional
from urllib.parse import urlsplit

from . import websocket
from .core import RPCCore
from .http import read_response as _read_response
from .jsonrpc import RPCError, from_jsonable, make_request, parse_response

# bound on a response head; a body is read to its Content-Length
_MAX_RESPONSE_HEAD = 1 << 20


class BaseClient:
    """Route methods shared by every transport; subclasses implement
    `_call(method, params)`."""

    async def _call(self, method: str, params: Optional[dict] = None) -> Any:
        raise NotImplementedError

    # info
    async def health(self):
        return await self._call("health")

    async def status(self):
        return await self._call("status")

    async def net_info(self):
        return await self._call("net_info")

    async def genesis(self):
        return await self._call("genesis")

    # blocks
    async def blockchain(self, min_height: int = 0, max_height: int = 0):
        return await self._call("blockchain", {"min_height": min_height, "max_height": max_height})

    async def block(self, height: Optional[int] = None):
        return await self._call("block", {} if height is None else {"height": height})

    async def block_by_hash(self, hash: bytes):  # noqa: A002
        return await self._call("block_by_hash", {"hash": hash})

    async def block_results(self, height: Optional[int] = None):
        return await self._call("block_results", {} if height is None else {"height": height})

    async def commit(self, height: Optional[int] = None):
        return await self._call("commit", {} if height is None else {"height": height})

    async def validators(self, height: Optional[int] = None, page: int = 1, per_page: int = 30):
        params: Dict[str, Any] = {"page": page, "per_page": per_page}
        if height is not None:
            params["height"] = height
        return await self._call("validators", params)

    async def consensus_params(self, height: Optional[int] = None):
        return await self._call("consensus_params", {} if height is None else {"height": height})

    async def consensus_state(self):
        return await self._call("consensus_state")

    async def dump_consensus_state(self):
        return await self._call("dump_consensus_state")

    # mempool / txs
    async def unconfirmed_txs(self, limit: int = 30):
        return await self._call("unconfirmed_txs", {"limit": limit})

    async def num_unconfirmed_txs(self):
        return await self._call("num_unconfirmed_txs")

    async def broadcast_tx_async(self, tx: bytes):
        return await self._call("broadcast_tx_async", {"tx": tx})

    async def broadcast_tx_sync(self, tx: bytes):
        return await self._call("broadcast_tx_sync", {"tx": tx})

    async def broadcast_tx_commit(self, tx: bytes):
        return await self._call("broadcast_tx_commit", {"tx": tx})

    # abci
    async def abci_query(self, path: str = "", data: bytes = b"", height: int = 0, prove: bool = False):
        return await self._call(
            "abci_query", {"path": path, "data": data, "height": height, "prove": prove}
        )

    async def abci_info(self):
        return await self._call("abci_info")

    # tx index
    async def tx(self, hash: bytes, prove: bool = False):  # noqa: A002
        return await self._call("tx", {"hash": hash, "prove": prove})

    async def tx_search(self, query: str, prove: bool = False, page: int = 1, per_page: int = 30):
        return await self._call(
            "tx_search", {"query": query, "prove": prove, "page": page, "per_page": per_page}
        )

    async def broadcast_evidence(self, evidence):
        return await self._call("broadcast_evidence", {"evidence": evidence})


class HTTPClient(BaseClient):
    """JSON-RPC over HTTP POST (rpc/client/http) on one keep-alive
    connection, opened at the first call.  `timeout` bounds each call
    (connect, send and the whole response).  A keep-alive connection the
    server closed while idle is re-opened once for the call that finds it
    closed; a call that times out drops its connection."""

    def __init__(self, addr: str, timeout: float = 30.0):
        # accept "host:port", "tcp://host:port" or full http URL
        if addr.startswith("http://") or addr.startswith("https://"):
            self.url = addr
        else:
            self.url = "http://" + addr.split("://", 1)[-1]
        u = urlsplit(self.url)
        if u.scheme != "http":
            raise ValueError(f"only http:// RPC servers are supported, got {self.url!r}")
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or 80
        self._path = u.path or "/"
        self.timeout = timeout
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._lock: Optional[asyncio.Lock] = None
        self._req_id = 0

    async def close(self) -> None:
        self._drop()

    async def __aenter__(self) -> "HTTPClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    def _drop(self) -> None:
        if self._writer is not None:
            self._writer.close()
        self._reader = self._writer = None

    async def _call(self, method: str, params: Optional[dict] = None) -> Any:
        self._req_id += 1
        body = json.dumps(make_request(method, params, self._req_id)).encode()
        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            try:
                raw = await asyncio.wait_for(self._roundtrip(body), self.timeout)
            except BaseException:
                self._drop()
                raise
        return parse_response(raw)

    async def _roundtrip(self, body: bytes) -> bytes:
        head = (
            f"POST {self._path} HTTP/1.1\r\n"
            f"Host: {self._host}:{self._port}\r\n"
            "Content-Type: application/json\r\n"
            "Accept: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n"
        ).encode("latin-1")
        for attempt in (0, 1):
            fresh = self._writer is None
            if fresh:
                self._reader, self._writer = await asyncio.open_connection(
                    self._host, self._port, limit=_MAX_RESPONSE_HEAD
                )
            try:
                self._writer.write(head + body)
                await self._writer.drain()
                status, headers, data = await _read_response(self._reader)
            except (ConnectionError, asyncio.IncompleteReadError) as e:
                self._drop()
                if fresh or attempt:
                    raise ConnectionError(f"RPC server {self.url} closed the connection: {e!r}")
                continue  # an idle keep-alive the server closed: once more, fresh
            if headers.get("connection", "").lower() == "close":
                self._drop()
            return data
        raise AssertionError("unreachable")


class WSClient(BaseClient):
    """JSON-RPC over one WebSocket connection with subscription streaming
    (rpc/lib/client/ws_client.go).  Responses correlate by request id;
    ``id:"N#event"`` notifications route to the matching subscription's
    async iterator.  `timeout` bounds the connect and each call."""

    def __init__(self, addr: str, timeout: float = 30.0):
        base = addr.split("://", 1)[-1].rstrip("/")
        self.url = f"ws://{base}/websocket"
        u = urlsplit(self.url)
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or 80
        self.timeout = timeout
        self._ws: Optional[websocket.WebSocket] = None
        self._recv_task: Optional[asyncio.Task] = None
        self._req_id = 0
        self._waiting: Dict[Any, asyncio.Future] = {}
        self._event_queues: Dict[str, asyncio.Queue] = {}

    async def connect(self) -> "WSClient":
        self._ws = await asyncio.wait_for(
            websocket.connect(self._host, self._port, "/websocket"), self.timeout)
        self._recv_task = asyncio.create_task(self._recv_loop())
        return self

    async def close(self) -> None:
        if self._recv_task is not None:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except asyncio.CancelledError:
                pass
        if self._ws is not None:
            await self._ws.close()
        for fut in self._waiting.values():
            if not fut.done():
                fut.cancel()
        self._waiting.clear()

    async def __aenter__(self) -> "WSClient":
        return await self.connect()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def _recv_loop(self) -> None:
        while True:
            msg = await self._ws.receive()
            if msg is None or msg[0] != websocket.TEXT:
                break
            d = json.loads(msg[1])
            rid = d.get("id")
            if isinstance(rid, str) and rid.endswith("#event"):
                result = from_jsonable(d.get("result") or {})
                q = self._event_queues.get(result.get("query", ""))
                if q is not None:
                    q.put_nowait(result)
                continue
            fut = self._waiting.pop(rid, None)
            if fut is not None and not fut.done():
                fut.set_result(d)

    async def _call(self, method: str, params: Optional[dict] = None) -> Any:
        self._req_id += 1
        rid = self._req_id
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._waiting[rid] = fut
        await self._ws.send_str(json.dumps(make_request(method, params, rid)))
        d = await asyncio.wait_for(fut, self.timeout)
        return parse_response(d)

    async def subscribe(self, query: str) -> AsyncIterator[dict]:
        """Subscribe and return an async iterator of event payloads
        ({"query", "data": {"type", "value"}, "events"})."""
        if query in self._event_queues:
            raise RPCError(-32603, f"already subscribed to {query!r}")
        q: asyncio.Queue = asyncio.Queue()
        self._event_queues[query] = q
        await self._call("subscribe", {"query": query})

        async def gen():
            while True:
                yield await q.get()

        return gen()

    async def unsubscribe(self, query: str) -> None:
        await self._call("unsubscribe", {"query": query})
        self._event_queues.pop(query, None)

    async def unsubscribe_all(self) -> None:
        await self._call("unsubscribe_all")
        self._event_queues.clear()


class LocalClient(BaseClient):
    """In-proc client wrapping a Node directly (rpc/client/local) — no
    serialization, used by tests and as a lite2 provider substrate."""

    def __init__(self, node):
        self.node = node
        self.core = RPCCore(
            node,
            unsafe=True,
            timeout_broadcast_tx_commit=node.config.rpc.timeout_broadcast_tx_commit,
        )
        self._sub_seq = 0

    async def _call(self, method: str, params: Optional[dict] = None) -> Any:
        return await self.core.call(method, params)

    async def subscribe(self, query: str) -> AsyncIterator[dict]:
        self._sub_seq += 1
        sub = await self.node.event_bus.subscribe(f"local-{self._sub_seq}", query)

        async def gen():
            async for msg in sub:
                yield {
                    "query": query,
                    "data": {"type": msg.data.type, "value": msg.data.data},
                    "events": msg.events,
                }

        return gen()

    async def close(self) -> None:
        pass
