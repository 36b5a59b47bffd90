"""The port's JSON-RPC layer (tendermint_tpu_torch/rpc: jsonrpc.py, core.py,
openapi.py, http.py, server.py, client.py) against the JAX package's rpc,
tolerance 0 (the WebSocket side is tests/test_torch_websocket.py).

Each package builds the same 6-height chain with
tests/test_torch_execution.run_chain on sqlite stores, and a node-shaped
object reopens them (the kvstore app on its db behind AppConns, a Mempool
with the signed-tx lane, the tx index, the evidence pool, a MockPV, no
switch and no consensus).  Then:

- every route of the JAX `RPCCore.ROUTES` through each package's
  `RPCCore.call`, with paging, height errors, an unknown method, bad
  parameters, the unsafe gate and the chaos routes' gate: the port's
  jsonable result, or its error code, message and data, equals the JAX
  core's;
- raw HTTP requests (GET URI params, POST single and batch, a batch over
  the cap, a body over `max_body_bytes`, junk bytes, keep-alive, unrouted
  paths, a plain GET of /websocket) to the port's server and the JAX
  server: equal statuses and equal JSON bodies; `/websocket` upgrades;
- the JAX HTTPClient reads the port's server and the port's HTTPClient
  reads the JAX server, with the results each reads from its own package's
  server; the port's LocalClient gives what its HTTPClient gives;
- a fresh interpreter importing the whole port loads no aiohttp, msgpack,
  jax or tendermint_tpu.
"""

import asyncio
import json
import os
import shutil
import subprocess
import sys
import tracemalloc
import types

import pytest

import tendermint_tpu.config as jconfig
import tendermint_tpu.libs.watchdog as jwatchdog
import tendermint_tpu.rpc.client as jclient
import tendermint_tpu.rpc.core as jcore
import tendermint_tpu.rpc.jsonrpc as jjsonrpc
import tendermint_tpu.rpc.openapi as jopenapi
import tendermint_tpu.rpc.server as jserver
import tendermint_tpu.types.events as jevents
from tendermint_tpu.types import MockPV as JMockPV
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch.libs import watchdog as pwatchdog
from tendermint_tpu_torch.rpc import client as pclient
from tendermint_tpu_torch.rpc import core as pcore
from tendermint_tpu_torch.rpc import jsonrpc as pjsonrpc
from tendermint_tpu_torch.rpc import openapi as popenapi
from tendermint_tpu_torch.rpc import server as pserver
from tendermint_tpu_torch.types import events as pevents
from tendermint_tpu_torch.types.priv_validator import MockPV as PMockPV

import test_torch_execution as tex

PORT = types.SimpleNamespace(
    **vars(tex.PORT), config=pconfig, watchdog=pwatchdog, core=pcore, jsonrpc=pjsonrpc,
    server=pserver, client=pclient, openapi=popenapi, bus=pevents, MockPV=PMockPV)
JAX = types.SimpleNamespace(
    **vars(tex.JAX), config=jconfig, watchdog=jwatchdog, core=jcore, jsonrpc=jjsonrpc,
    server=jserver, client=jclient, openapi=jopenapi, bus=jevents, MockPV=JMockPV)
PORT.name, JAX.name = "port", "jax"
MAX_BODY = 4000


@pytest.fixture(scope="module")
def homes(tmp_path_factory):
    """Each package's chain on sqlite, built once per module."""
    root = tmp_path_factory.mktemp("rpc-chains")
    out = {}
    for ns in (PORT, JAX):
        out[ns.name] = str(root / ns.name)
        asyncio.run(tex.run_chain(ns, home=out[ns.name]))
    return out


async def rpc_node(ns, home):
    """run_chain's stores under `home`, reopened under a node-shaped object
    with what RPCCore reads."""
    keys = tex.chain_keys(ns)
    dbs = {name: ns.kvstore.open_db(name, home) for name in tex.DBS}
    cfg = ns.config.test_config(home)
    cfg.base.moniker = "rpc-parity"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.max_body_bytes = MAX_BODY
    cfg.rpc.max_batch_request_items = 5
    cfg.rpc.timeout_broadcast_tx_commit = 0.2
    state_store = ns.state.StateStore(dbs["state"])
    state = state_store.load()
    conns = ns.proxy.AppConns(ns.proxy.local_client_creator(
        ns.examples.KVStoreApplication(db=dbs["app"])))
    await conns.start()
    bus = ns.bus.EventBus()
    await bus.start()
    node = types.SimpleNamespace(
        config=cfg, genesis_doc=tex.genesis(ns, keys),
        block_store=ns.BlockStore(dbs["blockstore"]), state_store=state_store,
        proxy_app=conns, event_bus=bus,
        mempool=ns.mempool.Mempool(conns.mempool(), {"sig_precheck": True}),
        tx_indexer=ns.txindex.TxIndexer(dbs["txindex"]),
        evidence_pool=ns.evpool.EvidencePool(dbs["evidence"], state_store, state),
        storage_health=ns.watchdog.StorageHealth(), priv_validator=ns.MockPV(keys[0]),
        switch=None, node_key=None, consensus=None, consensus_reactor=None,
        blockchain_reactor=None, statesync_reactor=None, watchdog=None, disk_faults=None,
        flight_recorder=None, dbs=dbs, keys=keys)
    return node


class open_nodes:
    """Both packages' node-shaped objects on fresh copies of the chains."""

    def __init__(self, homes, tmp_path):
        self.homes, self.tmp_path = homes, tmp_path

    async def __aenter__(self):
        self.nodes = {}
        for ns in (PORT, JAX):
            home = str(self.tmp_path / ns.name)
            shutil.copytree(self.homes[ns.name], home)
            self.nodes[ns.name] = await rpc_node(ns, home)
        return self.nodes

    async def __aexit__(self, *exc):
        for node in self.nodes.values():
            await node.event_bus.stop()
            await node.proxy_app.stop()
            for db in node.dbs.values():
                db.close()


def calls(node):
    """(method, params) pairs covering every route; params are the JAX
    package's Python values (bytes, ints, strings, typed evidence where
    the route takes one)."""
    blk = node.block_store.load_block(2)
    tx = blk.txs[0]
    import hashlib

    return [
        ("health", {}), ("status", {}), ("net_info", {}), ("genesis", {}),
        ("blockchain", {}), ("blockchain", {"min_height": 2, "max_height": 4}),
        ("blockchain", {"min_height": 5, "max_height": 3}),
        ("block", {}), ("block", {"height": 2}), ("block", {"height": 99}),
        ("block", {"height": "3"}), ("block", {"height": "abc"}), ("block", {"foo": 1}),
        ("block_by_hash", {"hash": blk.hash()}), ("block_by_hash", {"hash": b"\x00" * 32}),
        ("block_results", {"height": 3}), ("block_results", {}),
        ("commit", {"height": 3}), ("commit", {}), ("commit", {"height": 0}),
        ("validators", {"height": 3}),
        ("validators", {"height": 4, "page": 2, "per_page": 3}),
        ("validators", {"height": 4, "page": 4, "per_page": 3}),
        ("validators", {"height": 4, "page": 1, "per_page": 0}),
        ("validators", {"height": 4, "page": 1, "per_page": 1000}),
        ("consensus_params", {"height": 2}), ("consensus_state", {}),
        ("dump_consensus_state", {}), ("dump_flight_recorder", {}),
        ("dump_flight_recorder", {"since": 3, "kinds": "step,gossip."}),
        ("unconfirmed_txs", {}), ("num_unconfirmed_txs", {}),
        ("broadcast_tx_sync", {"tx": b"rpc-sync=1"}),
        ("broadcast_tx_sync", {"tx": b"rpc-sync=1"}),
        ("broadcast_tx_async", {"tx": b"rpc-async=2"}),
        ("unconfirmed_txs", {"limit": 1}), ("num_unconfirmed_txs", {}),
        ("broadcast_tx_commit", {"tx": b"rpc-commit=3"}),
        ("broadcast_tx_commit", {"tx": b"rpc-commit=3"}),
        ("abci_query", {"data": b"k1-0"}), ("abci_query", {"path": "/store", "data": "k2-1"}),
        ("abci_info", {}),
        ("tx", {"hash": hashlib.sha256(tx).digest()}),
        ("tx", {"hash": hashlib.sha256(tx).digest(), "prove": True}),
        ("tx", {"hash": b"\x01" * 32}),
        ("tx_search", {"query": "tx.height=2"}),
        ("tx_search", {"query": "tx.height=2", "page": 2, "per_page": 2, "prove": "true"}),
        ("tx_search", {"query": "tx.height=2", "page": 9}),
        ("broadcast_evidence", {"evidence": "not evidence"}),
        ("dial_peers", {"peers": ["ab@127.0.0.1:1"]}),
        ("unsafe_flush_mempool", {}), ("num_unconfirmed_txs", {}),
        ("unsafe_stop_cpu_profiler", {}),
        ("unsafe_chaos_link", {"peer_id": "*", "drop": 1.0}), ("unsafe_chaos_heal", {}),
        ("unsafe_chaos_clock_skew", {"skew": 2.0}), ("unsafe_chaos_status", {}),
        ("unsafe_chaos_disk", {"kind": "eio"}), ("unsafe_chaos_rot", {"height": 2}),
        ("unsafe_store_integrity_scan", {"limit": 3}),
        ("storage_info", {}),
        ("nope", {}),
    ]


async def outcome(ns, core, method, params):
    try:
        res = await core.call(method, params)
    except ns.jsonrpc.RPCError as e:
        return ("err", e.code, e.message, e.data)
    res = ns.jsonrpc.to_jsonable(res)
    # the sweep's wall time is this run's, not the route's
    if method == "unsafe_store_integrity_scan":
        res.pop("ms")
    if method == "storage_info" and res["blockstore"]["last_scan"]:
        res["blockstore"]["last_scan"].pop("ms")
    return ("ok", res)


def _to_port(x):
    """A JAX-side param value as the port's (typed values through JSON)."""
    return pjsonrpc.from_jsonable(jjsonrpc.to_jsonable(x))


async def test_every_route_equals_the_jax_core(homes, tmp_path):
    async with open_nodes(homes, tmp_path) as nodes:
        assert pcore.RPCCore.ROUTES == jcore.RPCCore.ROUTES
        assert pcore.RPCCore.UNSAFE == jcore.RPCCore.UNSAFE
        assert pcore.RPCCore.BROADCAST_ROUTES == jcore.RPCCore.BROADCAST_ROUTES
        cores = {name: ns.core.RPCCore(nodes[name], unsafe=True, timeout_broadcast_tx_commit=0.2)
                 for name, ns in (("port", PORT), ("jax", JAX))}
        cases = calls(nodes["jax"])
        assert {m for m, _ in cases} >= set(jcore.RPCCore.ROUTES) - {
            "unsafe_start_cpu_profiler", "unsafe_write_heap_profile", "unsafe_dump_tasks"}
        for method, params in cases:
            port = await outcome(PORT, cores["port"], method, _to_port(params))
            jax = await outcome(JAX, cores["jax"], method, params)
            assert port == jax, (method, params)
        # the routes whose answers hold this process's state: same shape
        for name, ns in (("port", PORT), ("jax", JAX)):
            tasks = await cores[name].call("unsafe_dump_tasks")
            assert tasks["n_tasks"] == len(tasks["tasks"]) >= 1
        # the evidence route on real evidence (typed through JSON)
        ev = tex.duplicate_vote(JAX, nodes["jax"].keys[0], 1)
        port = await outcome(PORT, cores["port"], "broadcast_evidence", {"evidence": _to_port(ev)})
        jax = await outcome(JAX, cores["jax"], "broadcast_evidence", {"evidence": ev})
        assert port == jax and port[0] == "ok"


async def test_unsafe_gate_and_profilers_equal_jax(homes, tmp_path):
    async with open_nodes(homes, tmp_path) as nodes:
        for method in sorted(jcore.RPCCore.UNSAFE):
            got = []
            for name, ns in (("port", PORT), ("jax", JAX)):
                core = ns.core.RPCCore(nodes[name])
                got.append(await outcome(ns, core, method, {}))
            assert got[0] == got[1] == ("err", -32601, f"{method} requires rpc.unsafe=true", "")
        for name, ns in (("port", PORT), ("jax", JAX)):
            core = ns.core.RPCCore(nodes[name], unsafe=True)
            prof = str(tmp_path / f"{name}.prof")
            assert await core.call("unsafe_start_cpu_profiler", {"filename": prof}) == {}
            with pytest.raises(ns.jsonrpc.RPCError, match="already running"):
                await core.call("unsafe_start_cpu_profiler", {"filename": prof})
            assert await core.call("unsafe_stop_cpu_profiler") == {"filename": prof}
            assert os.path.getsize(prof) > 0
            was = tracemalloc.is_tracing()
            tracemalloc.stop()
            try:
                first = await core.call("unsafe_write_heap_profile",
                                        {"filename": str(tmp_path / f"{name}.heap")})
                assert first == {"log": "tracemalloc started; call again for a snapshot"}
                second = await core.call("unsafe_write_heap_profile",
                                         {"filename": str(tmp_path / f"{name}.heap")})
                assert second["filename"].endswith(".heap") and second["entries"] >= 1
            finally:
                tracemalloc.stop()
                if was:
                    tracemalloc.start()


async def test_admission_control_equals_jax(homes, tmp_path):
    """The per-source token bucket, the in-flight cap and the commit-waiter
    cap: the same SERVER_OVERLOADED answers with the same retry_after."""
    async with open_nodes(homes, tmp_path) as nodes:
        got = {}
        for name, ns in (("port", PORT), ("jax", JAX)):
            core = ns.core.RPCCore(nodes[name], broadcast_rate=1.0, broadcast_rate_burst=2,
                                   max_broadcast_inflight=0, max_commit_waiters=0)
            trace = []
            for i in range(4):
                trace.append(await outcome(ns, core, "broadcast_tx_sync", {"tx": b"ac%d=1" % i}))
            core = ns.core.RPCCore(nodes[name], max_broadcast_inflight=1)
            core._inflight = 1
            trace.append(await outcome(ns, core, "broadcast_tx_async", {"tx": b"x=1"}))
            core = ns.core.RPCCore(nodes[name], max_commit_waiters=1)
            core._commit_waiters = 1
            trace.append(await outcome(ns, core, "broadcast_tx_commit", {"tx": b"y=1"}))
            got[name] = trace
        # the rate limit keys on the source: the trusted in-proc calls pass
        assert got["port"] == got["jax"]
        for name, ns in (("port", PORT), ("jax", JAX)):
            core = ns.core.RPCCore(nodes[name], broadcast_rate=1.0, broadcast_rate_burst=1)
            first = await core.call("broadcast_tx_sync", {"tx": b"src=1"}, source="10.0.0.9")
            assert first["code"] == 0
            with pytest.raises(ns.jsonrpc.RPCError) as ei:
                await core.call("broadcast_tx_sync", {"tx": b"src=2"}, source="10.0.0.9")
            assert ei.value.code == -32005 and set(ei.value.data) == {"retry_after"}
            assert core.throttled_total == 1


def test_jsonable_round_trip_equals_jax():
    import test_torch_chain_types as tct

    for ns_chain in (tct.PORT, tct.JAX):
        tct.chain(ns_chain)
    pc, jc = tct.chain(tct.PORT), tct.chain(tct.JAX)
    for h in (1, 4):
        p_vals, j_vals = pc["states"][h].validators, jc["states"][h].validators
        for p, j in ((pc["blocks"][h], jc["blocks"][h]), (pc["commits"][h], jc["commits"][h]),
                     (p_vals, j_vals), (p_vals.validators[0].to_dict(),
                                        j_vals.validators[0].to_dict()),
                     (b"\x00\xffbytes", b"\x00\xffbytes"), ({"a": [1, b"b"]}, {"a": [1, b"b"]})):
            pj, jj = pjsonrpc.to_jsonable(p), jjsonrpc.to_jsonable(j)
            assert json.dumps(pj) == json.dumps(jj)
            back = pjsonrpc.from_jsonable(jj)
            assert pjsonrpc.to_jsonable(back) == pj and type(back).__name__ == type(j).__name__
    err = pjsonrpc.overloaded_error("busy", 1.23456)
    assert err.to_dict() == jjsonrpc.overloaded_error("busy", 1.23456).to_dict()
    assert pjsonrpc.make_request("status", {"x": b"y"}, 3) == jjsonrpc.make_request(
        "status", {"x": b"y"}, 3)


def test_openapi_paths_equal_jax():
    p, j = popenapi.generate_spec("0.1.0"), jopenapi.generate_spec("0.1.0")
    assert p["paths"] == j["paths"] and p["openapi"] == j["openapi"]
    # no deviation named: the whole spec equals the JAX spec
    assert "ROADMAP" not in p["info"]["description"] and p == j


# -- the HTTP servers ----------------------------------------------------------


async def _servers(nodes):
    srv = {"port": pserver.RPCServer(nodes["port"], nodes["port"].config.rpc),
           "jax": jserver.RPCServer(nodes["jax"], nodes["jax"].config.rpc)}
    for s in srv.values():
        await s.start()
    return srv


async def _stop(srv):
    for s in srv.values():
        await s.stop()


async def _raw(addr, *requests):
    """Send raw HTTP requests on one connection; one (status, headers,
    body) per request."""
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        out = []
        for req in requests:
            writer.write(req)
            await writer.drain()
        for _ in requests:
            out.append(await asyncio.wait_for(pclient._read_response(reader), 10.0))
        return out
    finally:
        writer.close()


def _get(path):
    return f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode()


def _post(body, path="/", extra=""):
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n{extra}"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def _view(resp):
    status, headers, body = resp
    if headers.get("content-type", "").startswith("application/json"):
        return status, json.loads(body)
    return status, body.decode()


async def test_http_answers_equal_the_jax_server(homes, tmp_path):
    async with open_nodes(homes, tmp_path) as nodes:
        blk = nodes["jax"].block_store.load_block(2)
        import hashlib

        txh = hashlib.sha256(blk.txs[0]).hexdigest()
        single = json.dumps({"jsonrpc": "2.0", "id": 7, "method": "commit",
                             "params": {"height": 3}}).encode()
        batch = json.dumps([{"jsonrpc": "2.0", "id": i, "method": m, "params": p} for i, (m, p) in
                            enumerate([("block", {"height": 2}), ("validators", {"height": 3}),
                                       ("nope", {}), ("status", None)])]).encode()
        over = json.dumps([{"jsonrpc": "2.0", "id": i, "method": "health"}
                           for i in range(6)]).encode()
        requests = [
            [_get("/status")], [_get("/block?height=2")],
            [_get("/validators?height=3&page=2&per_page=3")],
            [_get('/abci_query?path=""&data=0x6b312d30')],
            [_get(f"/tx?hash=0x{txh}&prove=true")], [_get("/block?height=abc")],
            [_get("/nope")], [_get("/subscribe")], [_get("/blockchain?min_height=2&max_height=3")],
            [_get("/block_by_hash?hash=0x" + blk.hash().hex())],
            [_post(single)], [_post(batch)], [_post(over)], [_post(b"[]")], [_post(b"5")],
            [_post(b"\xff\x00 not json")], [_post(b"x" * (MAX_BODY + 10))],
            [_post(b'{"jsonrpc": "2.0", "id": 1, "method": "subscribe", "params": {}}')],
            [_post(b'{"jsonrpc": "2.0", "id": 1, "method": "block", "params": [1]}')],
            # keep-alive: two requests on one connection, answered in order
            [_get("/health"), _post(single)],
            # routes that do not exist
            [_get("/")], [_post(single, path="/status")], [_get("/a/b")],
            # /websocket without an upgrade: aiohttp's 400 text
            [_get("/websocket")],
        ]
        srv = await _servers(nodes)
        try:
            for reqs in requests:
                got = {name: [_view(r) for r in await _raw(s.listen_addr, *reqs)]
                       for name, s in srv.items()}
                assert got["port"] == got["jax"], reqs
                assert all(status in (200, 400, 404, 405) for status, _ in got["port"])
            # the spec, byte for byte
            (p,), (j,) = [await _raw(s.listen_addr, _get("/openapi.json")) for s in
                          (srv["port"], srv["jax"])]
            assert p[0] == j[0] == 200
            assert json.loads(p[2]) == json.loads(j[2])
        finally:
            await _stop(srv)


async def test_websocket_upgrades(homes, tmp_path):
    """/websocket answers an upgrade with 101 and the RFC 6455 accept key,
    then serves JSON-RPC: the port's answer to `status` over a WebSocket
    equals its answer over HTTP POST (both servers' WebSocket surfaces are
    held against each other in tests/test_torch_websocket.py)."""
    from tendermint_tpu_torch.rpc import websocket as pws

    async with open_nodes(homes, tmp_path) as nodes:
        srv = await _servers(nodes)
        try:
            host, port = srv["port"].listen_addr.rsplit(":", 1)
            ws = await pws.connect(host, int(port))
            try:
                await ws.send_json({"jsonrpc": "2.0", "id": 5, "method": "commit",
                                    "params": {"height": 3}})
                kind, text = await asyncio.wait_for(ws.receive(), 10.0)
            finally:
                await ws.close()
            assert kind == pws.TEXT and ws.close_code == 1000
            body = json.dumps({"jsonrpc": "2.0", "id": 5, "method": "commit",
                               "params": {"height": 3}}).encode()
            (status, _, http_body), = await _raw(srv["port"].listen_addr, _post(body))
            assert status == 200 and json.loads(text) == json.loads(http_body)
        finally:
            await _stop(srv)


async def test_port_server_bounds_and_connection_handling(homes, tmp_path):
    """Reads are bounded: a head over max_header_bytes gets 431, a body
    over max_body_bytes the JAX -32600 answer after at most the cap + 1
    bytes; a chunked body and Expect: 100-continue are read; HTTP/1.0
    closes unless asked to keep alive; max_open_connections holds extra
    connections until a slot frees."""
    async with open_nodes(homes, tmp_path) as nodes:
        node = nodes["port"]
        node.config.rpc.max_header_bytes = 2000
        node.config.rpc.max_open_connections = 1
        srv = pserver.RPCServer(node, node.config.rpc)
        await srv.start()
        try:
            addr = srv.listen_addr
            big = f"GET /health HTTP/1.1\r\nHost: x\r\nX-Pad: {'a' * 3000}\r\n\r\n".encode()
            (status, _, body), = await _raw(addr, big)
            assert status == 431
            (status, _, body), = await _raw(addr, _post(b"y" * (MAX_BODY + 1)))
            assert json.loads(body)["error"] == {
                "code": -32600, "message": f"request body exceeds {MAX_BODY} bytes"}
            body = b'{"jsonrpc": "2.0", "id": 3, "method": "health"}'
            chunked = (b"POST / HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                       + b"%x\r\n%s\r\n" % (10, body[:10]) + b"%x\r\n%s\r\n" % (len(body) - 10,
                                                                               body[10:])
                       + b"0\r\n\r\n")
            (status, _, out), = await _raw(addr, chunked)
            assert json.loads(out) == {"jsonrpc": "2.0", "id": 3, "result": {}}
            (status, _, out), = await _raw(addr, _post(body, extra="Expect: 100-continue\r\n"))
            assert status == 200 and json.loads(out)["result"] == {}
            (status, headers, _), = await _raw(addr, b"GET /health HTTP/1.0\r\n\r\n")
            assert status == 200 and headers.get("connection") == "close"
            # one slot: a second connection waits until the first closes
            r1, w1 = await asyncio.open_connection(*addr.rsplit(":", 1))
            w1.write(_get("/health"))
            await w1.drain()
            assert (await pclient._read_response(r1))[0] == 200
            second = asyncio.ensure_future(_raw(addr, _get("/health")))
            await asyncio.sleep(0.2)
            assert not second.done()
            w1.close()
            (status, _, _), = await asyncio.wait_for(second, 5.0)
            assert status == 200
        finally:
            await srv.stop()


async def test_http_clients_read_each_others_servers(homes, tmp_path):
    async with open_nodes(homes, tmp_path) as nodes:
        srv = await _servers(nodes)
        clients = {}
        try:
            def reads(c):
                return [("status", c.status()), ("commit", c.commit(3)), ("commit", c.commit()),
                        ("validators", c.validators(4, page=1, per_page=100)),
                        ("block", c.block(2)), ("abci_info", c.abci_info()),
                        ("block_results", c.block_results(3)),
                        ("consensus_params", c.consensus_params(2)),
                        ("broadcast_tx_sync", c.broadcast_tx_sync(b"cross=1"))]

            got = {}
            for reader, mod, jsonable in (("port", pclient, pjsonrpc.to_jsonable),
                                          ("jax", jclient, jjsonrpc.to_jsonable)):
                for server in ("port", "jax"):
                    c = clients[(reader, server)] = mod.HTTPClient(srv[server].listen_addr,
                                                                   timeout=10.0)
                    out = []
                    for name, coro in reads(c):
                        try:
                            out.append((name, jsonable(await coro)))
                        except mod.RPCError if hasattr(mod, "RPCError") else Exception as e:
                            out.append((name, "err", repr(e)))
                    got[(reader, server)] = out
            # what each client reads from the other package's server equals what
            # it reads from its own (the first broadcast of the tx is each
            # mempool's, so the second reads "already exists" on both)
            for reader in ("port", "jax"):
                a, b = got[(reader, "port")], got[(reader, "jax")]
                assert a[:-1] == b[:-1]
            assert got[("port", "port")][:-1] == got[("jax", "jax")][:-1]
            # typed values arrive as each reader's own classes
            sh = (await clients[("port", "jax")].commit(3))["signed_header"]
            assert type(sh).__module__.startswith("tendermint_tpu_torch")
            sh = (await clients[("jax", "port")].commit(3))["signed_header"]
            assert type(sh).__module__.startswith("tendermint_tpu.")
            # an RPC error reaches the caller as the reader's RPCError
            with pytest.raises(pjsonrpc.RPCError, match="must be less than or equal to 6"):
                await clients[("port", "jax")].block(99)
            with pytest.raises(jjsonrpc.RPCError, match="must be less than or equal to 6"):
                await clients[("jax", "port")].block(99)
        finally:
            for c in clients.values():
                await c.close()
            await _stop(srv)


async def test_http_client_reconnects_and_times_out(homes, tmp_path):
    """One keep-alive connection across calls; a server restart in between
    is met by one fresh connection; a call past `timeout` raises and drops
    the connection."""
    async with open_nodes(homes, tmp_path) as nodes:
        node = nodes["port"]
        srv = pserver.RPCServer(node, node.config.rpc)
        await srv.start()
        c = pclient.HTTPClient(srv.listen_addr, timeout=5.0)
        try:
            await c.health()
            first = c._writer
            await c.health()
            assert c._writer is first
            node.config.rpc.laddr = "tcp://" + srv.listen_addr
            await srv.stop()
            srv = pserver.RPCServer(node, node.config.rpc)
            await srv.start()
            assert await c.health() == {}
            assert c._writer is not first
            await srv.stop()
            with pytest.raises(OSError):
                await c.health()

            release = asyncio.Event()

            async def silent(reader, writer):
                await release.wait()
                writer.close()

            quiet = await asyncio.start_server(silent, "127.0.0.1", 0)
            try:
                slow = pclient.HTTPClient("127.0.0.1:%d" % quiet.sockets[0].getsockname()[1],
                                          timeout=0.2)
                with pytest.raises(asyncio.TimeoutError):
                    await slow.status()
                assert slow._writer is None
            finally:
                release.set()
                quiet.close()
                await quiet.wait_closed()
        finally:
            await c.close()
            if srv.is_running:
                await srv.stop()


async def test_local_client_mirrors_http(homes, tmp_path):
    async with open_nodes(homes, tmp_path) as nodes:
        node = nodes["port"]
        srv = pserver.RPCServer(node, node.config.rpc)
        await srv.start()
        http = pclient.HTTPClient(srv.listen_addr)
        local = pclient.LocalClient(node)
        try:
            for name in ("status", "net_info", "genesis", "abci_info", "num_unconfirmed_txs"):
                a = await getattr(local, name)()
                b = await getattr(http, name)()
                assert pjsonrpc.to_jsonable(a) == pjsonrpc.to_jsonable(b), name
            for h in (2, 5):
                assert pjsonrpc.to_jsonable(await local.commit(h)) == pjsonrpc.to_jsonable(
                    await http.commit(h))
                assert await local.validators(h, per_page=2) == await http.validators(h, per_page=2)
            sub = await local.subscribe("tm.event='Tx'")
            assert hasattr(sub, "__anext__")
            await sub.aclose()
        finally:
            await http.close()
            await local.close()
            await srv.stop()
            await node.event_bus.unsubscribe_all("local-1")


def test_port_imports_no_aiohttp_msgpack_jax_or_the_jax_package():
    code = (
        "import importlib, pkgutil, sys, tendermint_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'tendermint_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'tendermint_tpu_torch.rpc.server' in sys.modules\n"
        "assert 'tendermint_tpu_torch.statesync.reactor' in sys.modules\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('aiohttp', 'msgpack', 'jax', 'tendermint_tpu')))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
