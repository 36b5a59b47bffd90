"""OpenAPI spec for the JSON-RPC surface, generated from the route table
(the port's copy of tendermint_tpu/rpc/openapi.py; the spec equals the JAX
spec).

Reference parity: rpc/swagger/swagger.yaml — the reference maintains a
~3k-line hand-written spec; here the spec derives from RPCCore itself
(route names, parameter names/types from the handlers' annotations, and
their docstrings), so it can never drift from the implementation.  Served
at GET /openapi.json by the RPC server.
"""

from __future__ import annotations

import functools
import inspect
import typing
from typing import Any, Dict

from .core import RPCCore

_TYPE_MAP = {
    int: {"type": "integer"},
    float: {"type": "number"},
    bool: {"type": "boolean"},
    str: {"type": "string"},
    bytes: {"type": "string", "description": "bytes: 0x-hex or quoted string"},
    list: {"type": "array"},
}


def _schema_for(annotation) -> Dict[str, Any]:
    if annotation is None:
        return {"type": "string"}
    origin = getattr(annotation, "__origin__", None)
    if origin is not None:
        args = [a for a in getattr(annotation, "__args__", ()) if a is not type(None)]
        if len(args) == 1:
            return _schema_for(args[0])
        return {"type": "string"}
    return dict(_TYPE_MAP.get(annotation, {"type": "string"}))


@functools.lru_cache(maxsize=4)
def generate_spec(version: str = "") -> Dict[str, Any]:
    """Pure per process (routes/signatures are fixed at import); cached."""
    paths: Dict[str, Any] = {}
    for route in RPCCore.ROUTES:
        handler = getattr(RPCCore, route)
        try:
            hints = typing.get_type_hints(handler)
        except Exception:
            hints = {}
        sig = inspect.signature(handler)
        params = []
        for name, p in sig.parameters.items():
            if name == "self":
                continue
            schema = _schema_for(hints.get(name))
            params.append({
                "name": name,
                "in": "query",
                "required": p.default is inspect.Parameter.empty,
                "schema": schema,
            })
        doc = (handler.__doc__ or "").strip().splitlines()
        summary = doc[0] if doc else route
        op: Dict[str, Any] = {
            "operationId": route,
            "summary": summary,
            "tags": ["unsafe" if route in RPCCore.UNSAFE else "info"],
            "responses": {
                "200": {
                    "description": "JSON-RPC response envelope",
                    "content": {"application/json": {"schema": {"type": "object"}}},
                }
            },
        }
        if params:
            op["parameters"] = params
        paths[f"/{route}"] = {"get": op}
    return {
        "openapi": "3.0.0",
        "info": {
            "title": "tendermint_tpu RPC",
            "description": (
                "JSON-RPC 2.0 over HTTP GET (URI params), HTTP POST and "
                "WebSocket (/websocket, incl. subscribe/unsubscribe). "
                "Generated from the live route table."
            ),
            "version": version or "dev",
        },
        "paths": paths,
    }
