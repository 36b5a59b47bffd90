"""HTTP + WebSocket JSON-RPC server on asyncio streams (the port's copy of
tendermint_tpu/rpc/server.py, which runs on aiohttp; the card's machine has
no aiohttp, so this one speaks HTTP/1.1 through rpc/http.py and RFC 6455
through rpc/websocket.py).

Reference parity: rpc/lib/server/http_server.go (listener, body and header
limits, max open connections), http_json_handler.go (POST JSON-RPC incl.
batches), http_uri_handler.go (GET with URI params), ws_handler.go
(WebSocket endpoint with per-client subscription management —
subscribe/unsubscribe/unsubscribe_all run only in WS context, events
stream as JSON-RPC notifications).

For the same request the answers equal the JAX server's: status, and the
JSON body byte for byte (`json.dumps` of the same envelope), over HTTP and
over /websocket.  Requests that match no route get aiohttp's 404/405 text
answers, a refused upgrade aiohttp's 400 texts and a full client table its
503.  The HTTP bounds are rpc/http.py's; a WebSocket message is bound at
`max_body_bytes`, as the JAX server's `max_msg_size`.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any
from urllib.parse import parse_qsl

from ..libs.log import get_logger
from ..libs.service import Service
from . import http, websocket
from .core import RPCCore
from .jsonrpc import (
    INTERNAL_ERROR,
    INVALID_PARAMS,
    INVALID_REQUEST,
    METHOD_NOT_FOUND,
    PARSE_ERROR,
    RPCError,
    from_jsonable,
    make_response,
    read_bounded_body,
)


def _coerce_uri_param(v: str) -> Any:
    """GET query params arrive as strings; strip quoting and decode 0x-hex
    to bytes here, but leave everything else a string — RPCCore._coerce
    converts by the handler's annotation (the reference likewise binds URI
    strings by reflected arg type, http_uri_handler.go).  Eagerly guessing
    int here would mistype e.g. tx=1234 for a bytes param."""
    if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
        return v[1:-1]
    if v.startswith("0x"):
        try:
            return bytes.fromhex(v[2:])
        except ValueError:
            return v
    return v


class RPCServer(Service):
    """One per node; serves cfg.rpc.laddr."""

    def __init__(self, node, rpc_cfg):
        super().__init__("rpc-server")
        self.node = node
        self.cfg = rpc_cfg
        self.core = RPCCore(
            node,
            unsafe=rpc_cfg.unsafe,
            timeout_broadcast_tx_commit=rpc_cfg.timeout_broadcast_tx_commit,
            broadcast_rate=rpc_cfg.broadcast_rate,
            broadcast_rate_burst=rpc_cfg.broadcast_rate_burst,
            max_broadcast_inflight=rpc_cfg.max_broadcast_inflight,
            max_commit_waiters=rpc_cfg.max_commit_waiters,
        )
        self.log = get_logger("rpc.server")
        self._http = http.HTTPServer(
            self._route,
            max_header_bytes=rpc_cfg.max_header_bytes,
            max_body_bytes=rpc_cfg.max_body_bytes,
            max_open_connections=rpc_cfg.max_open_connections,
        )
        self.listen_addr: str = ""
        self._ws_clients: set = set()
        self._ws_seq = 0

    async def on_start(self) -> None:
        self.listen_addr = await self._http.start(self.cfg.laddr)

    async def on_stop(self) -> None:
        for ws in list(self._ws_clients):
            await ws.close(websocket.CLOSE_GOING_AWAY)
        await self._http.stop()

    # -- routing (the JAX server's aiohttp routes) --------------------------

    async def _route(self, req: http.Request):
        path, method = req.path, req.method
        get = method in ("GET", "HEAD")
        if path == "/":
            if method != "POST":
                return http.NOT_ALLOWED
            return http.json_answer(await self._handle_post(req.body, req.source))
        segment = path[1:]
        if "/" in segment or not segment:
            return http.NOT_FOUND
        if not get:
            return http.NOT_ALLOWED
        if segment == "websocket":
            return await self._handle_ws(req)
        if segment == "openapi.json":
            return http.json_answer(self._openapi())
        params = {k: _coerce_uri_param(v)
                  for k, v in parse_qsl(req.query, keep_blank_values=True)}
        return http.json_answer(await self._handle_get(segment, params, req.source))

    # -- HTTP POST: JSON-RPC (single or batch) ----------------------------

    async def _handle_post(self, body: http.Body, source: str) -> Any:
        try:
            raw = await read_bounded_body(body, self.cfg.max_body_bytes)
        except RPCError as e:
            return make_response(None, error=e)
        try:
            payload = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            return make_response(None, error=RPCError(PARSE_ERROR, "invalid JSON"))
        if isinstance(payload, list):  # batch (http_json_handler.go:66)
            if len(payload) > self.cfg.max_batch_request_items:
                # one POST must not fan out into thousands of handler tasks
                return make_response(
                    None,
                    error=RPCError(
                        INVALID_REQUEST,
                        f"batch of {len(payload)} exceeds "
                        f"{self.cfg.max_batch_request_items} requests",
                    ),
                )
            return list(await asyncio.gather(*(self._dispatch(r, source) for r in payload)))
        return await self._dispatch(payload, source)

    async def _dispatch(self, req: Any, source: str = "") -> dict:
        if not isinstance(req, dict) or "method" not in req:
            return make_response(None, error=RPCError(INVALID_REQUEST, "malformed request"))
        req_id = req.get("id")
        method = req["method"]
        params = from_jsonable(req.get("params") or {})
        if not isinstance(params, dict):
            return make_response(
                req_id, error=RPCError(INVALID_PARAMS, "params must be an object")
            )
        if method in ("subscribe", "unsubscribe", "unsubscribe_all"):
            return make_response(
                req_id,
                error=RPCError(
                    METHOD_NOT_FOUND, f"{method} is only available over /websocket"
                ),
            )
        try:
            result = await self.core.call(method, params, source=source)
            return make_response(req_id, result)
        except RPCError as e:
            return make_response(req_id, error=e)

    # -- HTTP GET: URI params ---------------------------------------------

    def _openapi(self) -> dict:
        """rpc/swagger flavor — spec generated from the route table."""
        from ..version import VERSION
        from .openapi import generate_spec

        return generate_spec(VERSION)

    async def _handle_get(self, method: str, params: dict, source: str) -> dict:
        if method in ("subscribe", "unsubscribe", "unsubscribe_all"):
            return make_response(-1, error=RPCError(METHOD_NOT_FOUND, "use /websocket"))
        try:
            result = await self.core.call(method, params, source=source)
            return make_response(-1, result)
        except RPCError as e:
            return make_response(-1, error=e)

    # -- WebSocket: full surface + subscriptions --------------------------

    async def _handle_ws(self, req: http.Request):
        if (
            self.cfg.max_subscription_clients > 0
            and len(self._ws_clients) >= self.cfg.max_subscription_clients
        ):
            raise http.BadRequest(503, "max subscription clients reached")
        # frame-size bound on the receive path: a client must not be able
        # to stream an arbitrarily large text message into json.loads below
        # (same budget as the HTTP body cap)
        ws = await websocket.server_upgrade(req, max_size=self.cfg.max_body_bytes)
        self._ws_clients.add(ws)
        self._ws_seq += 1
        subscriber = f"ws-{self._ws_seq}"
        source = req.source or subscriber
        # query string -> pump task streaming matching events to this client
        subs: dict[str, asyncio.Task] = {}
        try:
            while True:
                text = await ws.receive_text()
                if text is None:
                    break
                try:
                    msg = json.loads(text)
                except ValueError:
                    await ws.send_json(
                        make_response(None, error=RPCError(PARSE_ERROR, "invalid JSON"))
                    )
                    continue
                await self._ws_dispatch(ws, subscriber, subs, msg, source)
        except ConnectionError:
            pass
        finally:
            for task in subs.values():
                task.cancel()
            await self.node.event_bus.unsubscribe_all(subscriber)
            self._ws_clients.discard(ws)
            await ws.close()
        return http.HIJACKED

    async def _ws_dispatch(
        self, ws, subscriber: str, subs: dict, req: Any, source: str = ""
    ) -> None:
        if not isinstance(req, dict) or "method" not in req:
            await ws.send_json(
                make_response(None, error=RPCError(INVALID_REQUEST, "malformed request"))
            )
            return
        req_id = req.get("id")
        method = req["method"]
        params = from_jsonable(req.get("params") or {})
        try:
            if method == "subscribe":
                query = params.get("query", "")
                if not query:
                    raise RPCError(INVALID_PARAMS, "missing query")
                if len(subs) >= self.cfg.max_subscriptions_per_client > 0:
                    raise RPCError(INTERNAL_ERROR, "max subscriptions per client reached")
                if query in subs:
                    raise RPCError(INTERNAL_ERROR, f"already subscribed to {query!r}")
                sub = await self.node.event_bus.subscribe(subscriber, query)
                subs[query] = asyncio.create_task(self._pump(ws, req_id, query, sub))
                await ws.send_json(make_response(req_id, {}))
            elif method == "unsubscribe":
                query = params.get("query", "")
                task = subs.pop(query, None)
                if task is None:
                    raise RPCError(INVALID_PARAMS, f"not subscribed to {query!r}")
                task.cancel()
                await self.node.event_bus.unsubscribe(subscriber, query)
                await ws.send_json(make_response(req_id, {}))
            elif method == "unsubscribe_all":
                for task in subs.values():
                    task.cancel()
                subs.clear()
                await self.node.event_bus.unsubscribe_all(subscriber)
                await ws.send_json(make_response(req_id, {}))
            else:
                result = await self.core.call(
                    method, params if isinstance(params, dict) else {}, source=source
                )
                await ws.send_json(make_response(req_id, result))
        except RPCError as e:
            try:
                await ws.send_json(make_response(req_id, error=e))
            except ConnectionError:
                pass

    async def _pump(self, ws, req_id, query: str, sub) -> None:
        """Stream matching events to the client as JSON-RPC notifications
        (ws_handler.go: id = original id + '#event').  A subscriber that
        stops draining gets its subscription cancelled by the bus
        (ErrOutOfCapacity flavor) — tell it so explicitly instead of going
        silent: the fan-out limit that keeps one hot client from stalling
        the bus must never look like a quiet stream."""
        try:
            async for msg in sub:
                await ws.send_json(
                    make_response(
                        f"{req_id}#event",
                        {
                            "query": query,
                            "data": {"type": msg.data.type, "value": msg.data.data},
                            "events": msg.events,
                        },
                    )
                )
            if getattr(sub, "cancelled", False):
                await ws.send_json(
                    make_response(
                        f"{req_id}#event",
                        error=RPCError(
                            INTERNAL_ERROR,
                            f"subscription cancelled: {sub.cancel_reason}",
                        ),
                    )
                )
        except (ConnectionError, asyncio.CancelledError):
            pass
