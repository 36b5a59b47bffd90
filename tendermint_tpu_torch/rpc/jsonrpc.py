"""JSON-RPC 2.0 envelope + JSON-safe value codec (the port's copy of
tendermint_tpu/rpc/jsonrpc.py).

Reference parity: rpc/lib/types/types.go (RPCRequest/RPCResponse/RPCError)
and the amino-JSON value encoding.  Wire JSON here is our own shape: domain
objects ride as ``{"@t": tag, ...to_dict()}`` using the same registry as
the msgpack transport codec (encoding/codec.py), and bytes ride as
``{"@b": base64}`` — lossless round-trip without a second registry.  The
tags are the JAX package's, so either package reads the other's JSON.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Optional

from ..encoding import codec

# JSON-RPC 2.0 error codes (rpc/lib/types/types.go:153ff)
PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603
# Server-defined (-32000..-32099 range): the node is shedding load.  The
# error's `data` is a JSON OBJECT (not a string) carrying `retry_after`
# seconds — the explicit backoff hint admission control promises clients
# instead of silent queueing (rate limit hit, broadcast queue full,
# mempool full, commit-waiter cap reached).
SERVER_OVERLOADED = -32005


def overloaded_error(message: str, retry_after: float) -> "RPCError":
    """The one constructor for overload rejections, so every shedding
    path carries the same machine-readable retry_after hint."""
    return RPCError(
        SERVER_OVERLOADED, message,
        data={"retry_after": round(max(retry_after, 0.0), 3)},
    )


class RPCError(Exception):
    # `data` is any JSON-able value per the JSON-RPC 2.0 spec (overload
    # errors carry {"retry_after": s}); "" when absent
    def __init__(self, code: int, message: str, data=""):
        super().__init__(message)
        self.code = code
        self.message = message
        self.data = data

    def to_dict(self) -> dict:
        d = {"code": self.code, "message": self.message}
        if self.data:
            d["data"] = self.data
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RPCError":
        return cls(d.get("code", INTERNAL_ERROR), d.get("message", ""), d.get("data", ""))


def to_jsonable(x: Any) -> Any:
    """Recursively convert a value (possibly containing registered domain
    objects and bytes) into JSON-serializable structure."""
    tag = codec.tag_for(type(x))
    if tag is not None:
        d = {k: to_jsonable(v) for k, v in x.to_dict().items()}
        d["@t"] = tag
        return d
    if isinstance(x, dict):
        return {str(k): to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if isinstance(x, (bytes, bytearray)):
        return {"@b": base64.b64encode(bytes(x)).decode()}
    if x is None or isinstance(x, (str, int, float, bool)):
        return x
    if hasattr(x, "to_dict"):
        return {k: to_jsonable(v) for k, v in x.to_dict().items()}
    if hasattr(x, "__dict__"):  # dataclasses without to_dict (ABCI responses)
        return {k: to_jsonable(v) for k, v in vars(x).items()}
    return repr(x)


def from_jsonable(x: Any) -> Any:
    """Inverse of to_jsonable: bytes markers decode, tagged dicts rebuild
    their registered class; plain dicts/lists recurse."""
    if isinstance(x, dict):
        if set(x.keys()) == {"@b"}:
            return base64.b64decode(x["@b"])
        tag = x.get("@t")
        d = {k: from_jsonable(v) for k, v in x.items() if k != "@t"}
        if tag is not None:
            cls = codec.class_for(tag)
            if cls is not None:
                # from_dict implementations expect raw to_dict shape: nested
                # bytes decoded, nested plain dicts untouched — which is
                # exactly what the recursion above produced.
                return cls.from_dict(d)
        return d
    if isinstance(x, list):
        return [from_jsonable(v) for v in x]
    return x


def make_request(method: str, params: Optional[dict] = None, req_id: Any = 0) -> dict:
    return {
        "jsonrpc": "2.0",
        "id": req_id,
        "method": method,
        "params": to_jsonable(params or {}),
    }


def make_response(req_id: Any, result: Any = None, error: Optional[RPCError] = None) -> dict:
    resp: dict = {"jsonrpc": "2.0", "id": req_id}
    if error is not None:
        resp["error"] = error.to_dict()
    else:
        resp["result"] = to_jsonable(result)
    return resp


def parse_response(raw: str | bytes | dict) -> Any:
    """Decode a response; raises RPCError on error responses."""
    d = json.loads(raw) if not isinstance(raw, dict) else raw
    if d.get("error"):
        raise RPCError.from_dict(d["error"])
    return from_jsonable(d.get("result"))


async def read_bounded_body(content, limit: int) -> bytes:
    """Bounded request-body read BEFORE parsing (http_server.go
    maxBodyBytes): `content` (anything with an async `read(n)`, the
    server's body reader) is read up to `limit` + 1 bytes total — in a
    loop, because StreamReader.read(n) returns whatever chunk is buffered,
    not n bytes — so a client streaming an arbitrarily large body can never
    reach json.loads; it gets an explicit INVALID_REQUEST naming the cap
    after one bounded buffer."""
    body = b""
    while len(body) <= limit:
        chunk = await content.read(limit + 1 - len(body))
        if not chunk:
            break
        body += chunk
    if len(body) > limit:
        raise RPCError(INVALID_REQUEST, f"request body exceeds {limit} bytes")
    return body
