"""Light-client RPC proxy: serve a verifying subset of the RPC surface (the
port's copy of tendermint_tpu/lite2/proxy.py, which runs on aiohttp; this
one serves on the port's rpc/http.py, with the JAX proxy's routes, status
codes and JSON).

Reference parity: lite2/proxy/proxy.go + lite2/rpc/client.go (`tendermint
lite`): every header/commit the proxy serves has been light-verified
against the trust root; blocks are checked against their verified header
before forwarding.
"""

from __future__ import annotations

import json
from urllib.parse import parse_qsl

from ..libs.log import get_logger
from ..rpc import http
from ..rpc.jsonrpc import (
    INTERNAL_ERROR,
    INVALID_PARAMS,
    RPCError,
    from_jsonable,
    make_response,
    read_bounded_body,
)
from .client import BISECTION, Client, TrustOptions
from .provider import HTTPProvider

#: same default budget as RPCConfig.max_body_bytes — a light proxy faces
#: the same untrusted clients a full node's RPC does
DEFAULT_MAX_BODY_BYTES = 1_000_000


class LightProxy:
    """Wraps a lite2.Client + the primary's RPC client; exposes verified
    routes over HTTP JSON-RPC (GET URI + POST envelope)."""

    def __init__(self, client: Client, laddr: str, max_body_bytes: int = DEFAULT_MAX_BODY_BYTES):
        self.client = client
        self.laddr = laddr
        self.max_body_bytes = max_body_bytes
        self.log = get_logger("lite2.proxy")
        self._http = None
        self.listen_addr = ""

    # -- verified handlers -------------------------------------------------

    async def _commit(self, height: int = 0) -> dict:
        if height == 0:
            sh = await self.client.update()
            if sh is None:
                sh = await self.client.trusted_header()
        else:
            sh = await self.client.verify_header_at_height(height)
        return {"signed_header": sh, "canonical": True}

    async def _block(self, height: int = 0) -> dict:
        sh = (await self._commit(height))["signed_header"]
        res = await self.client.primary.client.block(sh.height)
        blk = res.get("block")
        if blk is None or blk.hash() != sh.header.hash():
            raise RPCError(INTERNAL_ERROR, "primary served a block not matching verified header")
        return res

    async def _validators(self, height: int = 0) -> dict:
        sh = (await self._commit(height))["signed_header"]
        vals = self.client.store.validator_set(sh.height)
        if vals is None:
            vals = await self.client.primary.validator_set(sh.height)
            if sh.header.validators_hash != vals.hash():
                raise RPCError(INTERNAL_ERROR, "primary served wrong validator set")
        return {
            "block_height": sh.height,
            "validators": [v.to_dict() for v in vals.validators],
            "total": vals.size(),
        }

    async def _status(self) -> dict:
        latest = await self.client.trusted_header()
        return {
            "light_client": True,
            "chain_id": self.client.chain_id,
            "latest_trusted_height": latest.height if latest else 0,
            "latest_trusted_hash": latest.header.hash() if latest else b"",
        }

    ROUTES = {
        "commit": "_commit",
        "block": "_block",
        "validators": "_validators",
        "status": "_status",
    }

    # -- server ------------------------------------------------------------

    async def start(self) -> None:
        await self.client.initialize()
        server = http.HTTPServer(self._route, logger="lite2.proxy")
        self.listen_addr = await server.start(self.laddr)
        self._http = server
        self.log.info("light proxy listening", laddr=self.listen_addr)

    async def stop(self) -> None:
        server, self._http = self._http, None
        if server is not None:
            await server.stop()

    async def _route(self, req: http.Request):
        """The JAX proxy's aiohttp routes: POST / and GET /{method}."""
        path, method = req.path, req.method
        if path == "/":
            if method != "POST":
                return http.NOT_ALLOWED
            return http.json_answer(await self._handle_post(req.body))
        segment = path[1:]
        if "/" in segment or not segment:
            return http.NOT_FOUND
        if method not in ("GET", "HEAD"):
            return http.NOT_ALLOWED
        return http.json_answer(await self._handle_get(segment, req.query))

    async def _dispatch(self, method: str, params: dict, req_id) -> dict:
        name = self.ROUTES.get(method)
        if name is None:
            return make_response(req_id, error=RPCError(INVALID_PARAMS, f"unknown route {method}"))
        try:
            return make_response(req_id, await getattr(self, name)(**params))
        except RPCError as e:
            return make_response(req_id, error=e)
        except Exception as e:  # noqa: BLE001
            return make_response(req_id, error=RPCError(INTERNAL_ERROR, repr(e)))

    async def _handle_post(self, body) -> dict:
        """`body` is the request body's stream (anything with an async
        `read(n)`); it is read bounded BEFORE json.loads."""
        try:
            raw = await read_bounded_body(body, self.max_body_bytes)
        except RPCError as e:
            return make_response(None, error=e)
        try:
            req = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            return make_response(None, error=RPCError(-32700, "bad JSON"))
        if not isinstance(req, dict):
            return make_response(None, error=RPCError(-32600, "malformed request"))
        params = from_jsonable(req.get("params") or {})
        return await self._dispatch(req.get("method", ""), params, req.get("id"))

    async def _handle_get(self, method: str, query: str) -> dict:
        params = {}
        for k, v in parse_qsl(query, keep_blank_values=True):
            try:
                params[k] = int(v)
            except ValueError:
                params[k] = v
        return await self._dispatch(method, params, -1)


async def run_proxy(
    chain_id: str,
    primary_addr: str,
    witness_addrs,
    laddr: str,
    trust_height: int,
    trust_hash: bytes,
    trusting_period_s: float,
) -> None:
    """CLI entry (`light` command) — runs until cancelled.  The client
    verifies through the installed crypto.batch hooks (the caller's
    engine)."""
    import asyncio

    primary = HTTPProvider(chain_id, primary_addr)
    witnesses = [HTTPProvider(chain_id, w) for w in witness_addrs]
    client = Client(
        chain_id,
        TrustOptions(int(trusting_period_s * 1e9), trust_height, trust_hash),
        primary,
        witnesses=witnesses,
        mode=BISECTION,
    )
    proxy = LightProxy(client, laddr)
    try:
        await proxy.start()
        while True:
            await asyncio.sleep(3600)
    except asyncio.CancelledError:
        pass
    finally:
        await proxy.stop()
        for p in [primary, *witnesses]:
            await p.close()
