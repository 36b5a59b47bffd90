"""The port's WebSocket (tendermint_tpu_torch/rpc: websocket.py, the
server's /websocket, client.py WSClient) against the JAX package's aiohttp
endpoint and client, tolerance 0.

- RFC 6455 by itself: the sample handshake of section 1.3, masking,
  frame lengths (7-bit, 16-bit and 64-bit), a fragmented message with a
  ping between its fragments, the close handshake, the frame bound (1009)
  and an unmasked client frame (1002).
- Raw frames to both servers (the port's RPCServer and the JAX one on
  node-shaped objects over tests/test_torch_rpc.py's chain): the same
  frames and JSON answers back, including the refused upgrades.
- Every route of tests/test_torch_rpc.py `calls` over /websocket: the
  port's answers equal the JAX server's, JSON for JSON.
- Interop both ways: the JAX WSClient reads the port's server and the
  port's WSClient reads the JAX server, as each reads its own.
- Subscriptions: subscribe, unsubscribe and unsubscribe_all, NewBlock and
  Tx notifications (published on each node's event bus), both
  subscription limits and the "subscription cancelled" notice of a
  subscriber that stopped draining: every message equals the JAX server's.
"""

import asyncio
import base64
import json
import os
import struct

import pytest

import tendermint_tpu.rpc.client as jclient
import tendermint_tpu.rpc.jsonrpc as jjsonrpc
from tendermint_tpu_torch.rpc import client as pclient
from tendermint_tpu_torch.rpc import http as phttp
from tendermint_tpu_torch.rpc import jsonrpc as pjsonrpc
from tendermint_tpu_torch.rpc import websocket as pws

from test_torch_rpc import MAX_BODY, _servers, _stop, calls, homes, open_nodes  # noqa: F401


# -- RFC 6455 by itself ----------------------------------------------------------


def test_rfc6455_sample_handshake_and_refusals():
    assert pws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    good = {"upgrade": "websocket", "connection": "Upgrade",
            "sec-websocket-version": "13", "sec-websocket-key": "dGhlIHNhbXBsZSBub25jZQ=="}
    assert pws.handshake_error(good) is None
    assert pws.handshake_error({**good, "upgrade": "h2c"}).startswith("No WebSocket UPGRADE hdr")
    assert pws.handshake_error({**good, "connection": "close"}) == \
        "No CONNECTION upgrade hdr: close"
    assert pws.handshake_error({**good, "sec-websocket-version": "12"}) == \
        "Unsupported version: 12"
    assert pws.handshake_error({**good, "sec-websocket-key": "c2hvcnQ="}) == \
        "Handshake error: 'c2hvcnQ='"


class Sink:
    """A writer that keeps what is written."""

    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def close(self):
        pass


def frames_of(data: bytes):
    """Parse unmasked or masked frames: [(fin, opcode, payload)]."""
    out, i = [], 0
    while i < len(data):
        b0, b1 = data[i], data[i + 1]
        n, i = b1 & 0x7F, i + 2
        if n == 126:
            n, i = struct.unpack("!H", data[i:i + 2])[0], i + 2
        elif n == 127:
            n, i = struct.unpack("!Q", data[i:i + 8])[0], i + 8
        key = b""
        if b1 & 0x80:
            key, i = data[i:i + 4], i + 4
        payload = data[i:i + n]
        out.append((bool(b0 & 0x80), b0 & 0x0F, pws.mask(payload, key) if key else payload))
        i += n
    return out


def ws_on(data: bytes, client: bool, max_size=1 << 20):
    reader = asyncio.StreamReader()
    reader.feed_data(data)
    reader.feed_eof()
    sink = Sink()
    return pws.WebSocket(reader, sink, client=client, max_size=max_size), sink


@pytest.mark.parametrize("n", [0, 5, 125, 126, 65535, 65536, 200_000])
def test_frame_lengths_and_masking_round_trip(n):
    payload = os.urandom(n)
    key = b"\x01\x02\x03\x04"
    assert pws.mask(pws.mask(payload, key), key) == payload
    for masked in (False, True):
        frame = pws.encode_frame(pws.BINARY, payload, masked=masked)
        head = 2 + (2 if 126 <= n < 65536 else 8 if n >= 65536 else 0) + (4 if masked else 0)
        assert len(frame) == head + n
        assert frames_of(frame) == [(True, pws.BINARY, payload)]


async def test_fragments_ping_close_and_bounds():
    # a masked text message in three fragments with a ping between them
    parts = [b'{"a": ', b"[1, 2", b"]}"]
    data = (pws.encode_frame(pws.TEXT, parts[0], True, fin=False)
            + pws.encode_frame(pws.PING, b"hi", True)
            + pws.encode_frame(pws.CONTINUATION, parts[1], True, fin=False)
            + pws.encode_frame(pws.CONTINUATION, parts[2], True)
            + pws.encode_frame(pws.CLOSE, struct.pack("!H", 1000), True))
    ws, sink = ws_on(data, client=False)
    assert await ws.receive_text() == '{"a": [1, 2]}'
    assert frames_of(bytes(sink.data)) == [(True, pws.PONG, b"hi")]
    assert await ws.receive() is None and ws.close_code == 1000
    # the close is echoed, unmasked from a server
    assert frames_of(bytes(sink.data))[-1] == (True, pws.CLOSE, struct.pack("!H", 1000))
    # over the bound: 1009, whether in one frame or across fragments
    for data in (pws.encode_frame(pws.TEXT, b"x" * 101, True),
                 pws.encode_frame(pws.TEXT, b"x" * 60, True, fin=False)
                 + pws.encode_frame(pws.CONTINUATION, b"x" * 60, True)):
        ws, sink = ws_on(data, client=False, max_size=100)
        assert await ws.receive() is None and ws.close_code == 1009
        assert frames_of(bytes(sink.data)) == [(True, pws.CLOSE, struct.pack("!H", 1009))]
    # a server takes only masked frames, a client only unmasked ones
    for client, masked in ((False, False), (True, True)):
        ws, sink = ws_on(pws.encode_frame(pws.TEXT, b"x", masked), client=client)
        assert await ws.receive() is None and ws.close_code == 1002
        (_, _, payload), = frames_of(bytes(sink.data))
        assert payload == struct.pack("!H", 1002)
    # a continuation with nothing to continue, and a stream that just ends
    ws, _ = ws_on(pws.encode_frame(pws.CONTINUATION, b"x", True), client=False)
    assert await ws.receive() is None and ws.close_code == 1002
    ws, _ = ws_on(b"", client=False)
    assert await ws.receive() is None and ws.close_code == 1006


# -- raw frames to both servers ----------------------------------------------------


async def raw_upgrade(addr, extra=""):
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write((f"GET /websocket HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                  f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                  f"Sec-WebSocket-Version: 13\r\n{extra}\r\n").encode())
    status, headers = await phttp.read_response_head(reader)
    return reader, writer, status, headers, key


async def read_frame(reader):
    b0, b1 = await reader.readexactly(2)
    n = b1 & 0x7F
    if n == 126:
        n = struct.unpack("!H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack("!Q", await reader.readexactly(8))[0]
    payload = await reader.readexactly(n)
    if b0 & 0x0F == pws.TEXT:
        return "text", json.loads(payload)
    if b0 & 0x0F == pws.CLOSE:
        return "close", struct.unpack("!H", payload[:2])[0]
    return b0 & 0x0F, payload


def req(rid, method, params=None):
    return json.dumps(jjsonrpc.make_request(method, params, rid)).encode()


RAW = {
    "fragments_and_ping": [
        (pws.TEXT, req(1, "health")[:10], False), (pws.PING, b"p1", True),
        (pws.CONTINUATION, req(1, "health")[10:], True), (pws.TEXT, req(2, "commit", {"height": 3}), True),
        (pws.TEXT, b"{not json", True), (pws.TEXT, b'{"id": 4}', True),
        (pws.BINARY, b"ignored", True), (pws.TEXT, req(5, "subscribe", {}), True),
        (pws.CLOSE, struct.pack("!H", 1000), True)],
    "oversized": [(pws.TEXT, b" " * (MAX_BODY + 1), True)],
    "oversized_fragments": [(pws.TEXT, b" " * 3000, False), (pws.CONTINUATION, b" " * 3000, True)],
}
EXPECT = {"fragments_and_ping": 7, "oversized": 1, "oversized_fragments": 1}


@pytest.mark.parametrize("case", sorted(RAW))
async def test_raw_frames_equal_the_jax_server(case, homes, tmp_path):  # noqa: F811
    async with open_nodes(homes, tmp_path) as nodes:
        srv = await _servers(nodes)
        try:
            got = {}
            for name, s in srv.items():
                reader, writer, status, headers, key = await raw_upgrade(s.listen_addr)
                assert status == 101 and headers["sec-websocket-accept"] == pws.accept_key(key)
                for opcode, payload, fin in RAW[case]:
                    writer.write(pws.encode_frame(opcode, payload, True, fin=fin))
                await writer.drain()
                got[name] = [await asyncio.wait_for(read_frame(reader), 10.0)
                             for _ in range(EXPECT[case])]
                writer.close()
            assert got["port"] == got["jax"]
            if case == "fragments_and_ping":
                assert got["port"][0] == (pws.PONG, b"p1") and got["port"][-1] == ("close", 1000)
            else:
                assert got["port"] == [("close", 1009)]
        finally:
            await _stop(srv)


async def test_refused_upgrades_equal_the_jax_server(homes, tmp_path):  # noqa: F811
    async with open_nodes(homes, tmp_path) as nodes:
        for node in nodes.values():
            node.config.rpc.max_subscription_clients = 1
        srv = await _servers(nodes)
        try:
            got = {}
            for name, s in srv.items():
                out = []
                host, port = s.listen_addr.rsplit(":", 1)
                for bad in ("Sec-WebSocket-Version: 12\r\n", ):
                    r, w = await asyncio.open_connection(host, int(port))
                    w.write((f"GET /websocket HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                             f"Connection: Upgrade\r\n{bad}"
                             "Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n\r\n").encode())
                    status, _, body = await pclient._read_response(r)
                    out.append((status, body))
                    w.close()
                first = await raw_upgrade(s.listen_addr)
                assert first[2] == 101
                # the client table is full: 503 with the JAX text
                r, w = await asyncio.open_connection(host, int(port))
                w.write(b"GET /websocket HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                        b"Connection: Upgrade\r\nSec-WebSocket-Version: 13\r\n"
                        b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n\r\n")
                status, _, body = await pclient._read_response(r)
                out.append((status, body))
                w.close()
                first[1].close()
                got[name] = out
            assert got["port"] == got["jax"]
            assert got["port"] == [(400, b"Unsupported version: 12"),
                                   (503, b"max subscription clients reached")]
        finally:
            await _stop(srv)


# -- every route over /websocket ---------------------------------------------------


def _scrub(method, d):
    """The route answers that hold this run's wall time."""
    res = d.get("result")
    if method == "unsafe_store_integrity_scan" and res:
        res.pop("ms", None)
    if method == "storage_info" and res and res["blockstore"]["last_scan"]:
        res["blockstore"]["last_scan"].pop("ms", None)
    return d


async def test_every_route_over_websocket_equals_jax(homes, tmp_path):  # noqa: F811
    """One WebSocket per server (the port's client on both), every route
    of `calls` in order: the JSON answers are equal."""
    async with open_nodes(homes, tmp_path) as nodes:
        srv = await _servers(nodes)
        try:
            cases = calls(nodes["jax"])
            got = {}
            for name, s in srv.items():
                host, port = s.listen_addr.rsplit(":", 1)
                ws = await pws.connect(host, int(port))
                out = []
                for i, (method, params) in enumerate(cases):
                    await ws.send_str(json.dumps(jjsonrpc.make_request(method, params, i)))
                    kind, text = await asyncio.wait_for(ws.receive(), 20.0)
                    out.append(_scrub(method, json.loads(text)))
                await ws.close()
                got[name] = out
            for (method, params), p, j in zip(cases, got["port"], got["jax"]):
                assert p == j, (method, params)
        finally:
            await _stop(srv)


async def test_ws_clients_read_each_others_servers(homes, tmp_path):  # noqa: F811
    async with open_nodes(homes, tmp_path) as nodes:
        srv = await _servers(nodes)
        try:
            got = {}
            for reader, mod, jsonable in (("port", pclient, pjsonrpc.to_jsonable),
                                          ("jax", jclient, jjsonrpc.to_jsonable)):
                for server in ("port", "jax"):
                    async with mod.WSClient(srv[server].listen_addr, timeout=10.0) as c:
                        out = [jsonable(await c.status()), jsonable(await c.commit(3)),
                               jsonable(await c.validators(4, page=1, per_page=100)),
                               jsonable(await c.block(2)), jsonable(await c.abci_info())]
                        try:
                            await c.block(99)
                        except Exception as e:  # each package's RPCError
                            out.append((e.code, e.message))
                        events = await c.subscribe("tm.event='NewBlock'")
                        blk = nodes[server].block_store.load_block(3)
                        await nodes[server].event_bus.publish_new_block(blk)
                        ev = await asyncio.wait_for(events.__anext__(), 10.0)
                        out.append(jsonable(ev))
                        await c.unsubscribe("tm.event='NewBlock'")
                    got[(reader, server)] = out
            # each client reads the other package's server as its own
            assert got[("port", "jax")] == got[("port", "port")]
            assert got[("jax", "port")] == got[("jax", "jax")]
            assert got[("port", "port")] == got[("jax", "jax")]
            assert got[("port", "port")][-1]["data"]["type"] == "NewBlock"
        finally:
            await _stop(srv)


# -- subscriptions -----------------------------------------------------------------


async def subscription_session(node, addr):
    """One client's subscription traffic; returns every message it got
    (JSON), in order, and what a second subscriber saw."""
    host, port = addr.rsplit(":", 1)
    ws = await pws.connect(host, int(port))
    out = []

    async def call(rid, method, params=None, events=0):
        await ws.send_str(json.dumps(jjsonrpc.make_request(method, params, rid)))
        for _ in range(1 + events):
            kind, text = await asyncio.wait_for(ws.receive(), 10.0)
            out.append(json.loads(text))

    async def recv(n):
        for _ in range(n):
            kind, text = await asyncio.wait_for(ws.receive(), 10.0)
            out.append(json.loads(text))

    blk = node.block_store.load_block(2)
    await call(1, "subscribe", {"query": "tm.event='NewBlock'"})
    await call(2, "subscribe", {"query": "tm.event='Tx'"})
    await call(3, "subscribe", {"query": "tm.event='Tx'"})  # already subscribed
    await call(4, "subscribe", {})  # missing query
    await call(5, "subscribe", {"query": "tm.event='Vote'"})  # over the per-client cap
    await node.event_bus.publish_new_block(blk)
    await node.event_bus.publish_tx(2, 0, blk.txs[0], {"code": 0, "data": b"ok"})
    await recv(2)
    await call(6, "unsubscribe", {"query": "tm.event='NewBlock'"})
    await call(7, "unsubscribe", {"query": "tm.event='NewBlock'"})  # not subscribed
    await node.event_bus.publish_new_block(blk)  # nobody listens any more
    await call(8, "status")
    await call(9, "unsubscribe_all")
    await node.event_bus.publish_tx(2, 1, blk.txs[1], {"code": 0})
    await call(10, "health")
    # a subscriber that stops draining: its buffer (2 here) overflows, the
    # bus cancels it, and the pump says so after the events it held
    node.event_bus.pubsub._buffer = 2
    await call(11, "subscribe", {"query": "tm.event='NewBlock'"})
    for _ in range(4):
        await node.event_bus.publish_new_block(blk)
    await recv(3)
    await ws.close()
    return out


async def test_subscriptions_equal_jax(homes, tmp_path):  # noqa: F811
    async with open_nodes(homes, tmp_path) as nodes:
        for node in nodes.values():
            node.config.rpc.max_subscriptions_per_client = 2
        srv = await _servers(nodes)
        try:
            got = {name: await subscription_session(nodes[name], s.listen_addr)
                   for name, s in srv.items()}
            assert got["port"] == got["jax"]
            msgs = got["port"]
            assert [m.get("id") for m in msgs[:5]] == [1, 2, 3, 4, 5]
            assert msgs[4]["error"]["message"] == "max subscriptions per client reached"
            assert msgs[5]["id"] == "1#event" and msgs[5]["result"]["data"]["type"] == "NewBlock"
            assert msgs[6]["id"] == "2#event" and msgs[6]["result"]["data"]["type"] == "Tx"
            assert msgs[-1]["id"] == "11#event" and msgs[-1]["error"]["message"] == \
                "subscription cancelled: out of capacity"
            # the bus forgot every subscriber once the sockets closed
            for node in nodes.values():
                assert node.event_bus.num_clients() == 0
        finally:
            await _stop(srv)
