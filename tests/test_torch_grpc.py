"""The port's gRPC (tendermint_tpu_torch/rpc/grpc.py on rpc/http2.py and
rpc/hpack.py), its ABCI gRPC transport (abci/grpc.py), the BroadcastAPI
(rpc/grpc_api.py) and `abci_cli --abci grpc` against the JAX package's,
whose gRPC is grpcio; tolerance exact.

- ABCI: each package's GRPCClient calls each package's GRPCServer (the
  port's client against grpcio's server, grpcio's client against the
  port's): all 15 methods, an InitChain of 2,000 validators and an echo of
  200 KB (both past the 65,535-byte windows), several calls on one
  connection (so HPACK indexes the first call's fields), give the answers
  of the in-proc app.
- Status codes on both servers, from both clients: an unknown method 12
  UNIMPLEMENTED, a raising handler 2 UNKNOWN, a request over the 4 MiB
  receive limit 8 RESOURCE_EXHAUSTED (and an answer over it, at the
  client); the details are grpcio's.
- The BroadcastAPI: the JAX BroadcastAPIClient against a port node's
  rpc.grpc_laddr and the port's client against a JAX node give the same
  Ping and BroadcastTx dicts.
- A port node with `abci = "grpc"` commits heights on the CPU against
  either package's app server.
- `abci_cli --abci grpc`: one-shot commands and a batch script print the
  JAX CLI's lines (`info` apart, ROADMAP 3.8), each CLI against its own
  package's server.
"""

import asyncio
import dataclasses
import io
import threading

import grpc
import grpc.aio
import pytest

import tendermint_tpu.abci.examples as jexamples
import tendermint_tpu.abci.grpc as jgrpc_abci
import tendermint_tpu.abci.types as jabci
import tendermint_tpu.abci_cli as jcli
import tendermint_tpu.rpc.grpc_api as jgrpc_api
from tendermint_tpu_torch import abci_cli as pcli
from tendermint_tpu_torch.abci import examples as pexamples
from tendermint_tpu_torch.abci import grpc as pgrpc_abci
from tendermint_tpu_torch.abci import types as pabci
from tendermint_tpu_torch.rpc import grpc as pgrpc
from tendermint_tpu_torch.rpc import grpc_api as pgrpc_api

PORT = dict(abci=pabci, transport=pgrpc_abci, examples=pexamples, api=pgrpc_api, cli=pcli)
JAX = dict(abci=jabci, transport=jgrpc_abci, examples=jexamples, api=jgrpc_api, cli=jcli)
PKGS = {"port": PORT, "jax": JAX}
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax"), ("jax", "jax")]  # server, client


async def _script(abci, client):
    """All 15 methods, twice where it matters; the answers as plain dicts."""
    vals = [abci.ValidatorUpdate("ed25519", i.to_bytes(32, "big"), 10) for i in range(2000)]
    out = [await client.echo("hello"), await client.echo("x" * 200_000)]
    await client.flush()
    out.append(await client.info(abci.RequestInfo(version="v")))
    out.append(await client.set_option(abci.RequestSetOption("k", "v")))
    out.append(await client.init_chain(abci.RequestInitChain(
        time_ns=1, chain_id="abci-grpc", validators=vals)))
    for h in (1, 2):
        out.append(await client.begin_block(abci.RequestBeginBlock(hash=bytes([h]) * 32)))
        out.append(await client.check_tx(abci.RequestCheckTx(tx=b"a%d=1" % h)))
        for i in range(5):
            out.append(await client.deliver_tx(abci.RequestDeliverTx(tx=b"k%d.%d=v%d" % (h, i, i))))
        out.append(await client.end_block(abci.RequestEndBlock(height=h)))
        out.append(await client.commit())
    out.append(await client.query(abci.RequestQuery(data=b"k2.3", path="/key")))
    out.append(await client.list_snapshots(abci.RequestListSnapshots()))
    out.append(await client.offer_snapshot(abci.RequestOfferSnapshot()))
    out.append(await client.load_snapshot_chunk(abci.RequestLoadSnapshotChunk(height=2)))
    out.append(await client.apply_snapshot_chunk(abci.RequestApplySnapshotChunk(index=0)))
    return [dataclasses.asdict(r) for r in out]


async def _local(pkg):
    from importlib import import_module

    client_mod = import_module(pkg["abci"].__name__.rsplit(".", 1)[0] + ".client")
    local = client_mod.LocalClient(pkg["examples"].KVStoreApplication())
    await local.start()
    try:
        return await _script(pkg["abci"], local)
    finally:
        await local.stop()


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
async def test_abci_clients_and_servers_of_both_packages_interoperate(server_pkg, client_pkg):
    s, c = PKGS[server_pkg], PKGS[client_pkg]
    server = s["transport"].GRPCServer("tcp://127.0.0.1:0", s["examples"].KVStoreApplication())
    await server.start()
    client = c["transport"].GRPCClient(server.bound_addr)
    await client.start()
    try:
        got = await _script(c["abci"], client)
    finally:
        await client.stop()
        await server.stop()
    assert got == await _local(c)


def test_abci_service_surface_matches_jax():
    assert pgrpc_abci.SERVICE == jgrpc_abci.SERVICE
    assert pgrpc_abci._METHODS == jgrpc_abci._METHODS
    assert pgrpc_api.SERVICE == jgrpc_api.SERVICE


# -- status codes -----------------------------------------------------------------

SERVICE = "test.Status"


def ident(b):
    return b


async def _echo(req, *ctx):
    return req


async def _boom(req, *ctx):
    raise ValueError("boom")


async def _big(req, *ctx):
    return b"q" * (4 * 1024 * 1024 + 1)


async def _serve(kind):
    if kind == "port":
        server = pgrpc.Server()
        server.add_service(SERVICE, {name: pgrpc.UnaryMethod(fn, ident, ident) for name, fn in (
            ("Echo", _echo), ("Boom", _boom), ("Big", _big))})
        return server, await server.start("tcp://127.0.0.1:0")
    server = grpc.aio.server()
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE, {
        name: grpc.unary_unary_rpc_method_handler(fn, request_deserializer=ident,
                                                  response_serializer=ident)
        for name, fn in (("Echo", _echo), ("Boom", _boom), ("Big", _big))}),))
    port = server.add_insecure_port("127.0.0.1:0")
    await server.start()
    return server, f"127.0.0.1:{port}"


async def _call(kind, addr, method, payload):
    """(code as an int, details) of a failed call; ("ok", len) otherwise."""
    if kind == "port":
        channel = pgrpc.Channel(addr)
        try:
            return "ok", len(await channel.unary_unary(f"/{SERVICE}/{method}", ident, ident)(
                payload))
        except pgrpc.RpcError as e:
            return int(e.code()), e.details()
        finally:
            await channel.close()
    async with grpc.aio.insecure_channel(addr) as channel:
        try:
            return "ok", len(await channel.unary_unary(
                f"/{SERVICE}/{method}", request_serializer=ident, response_deserializer=ident)(
                payload))
        except grpc.aio.AioRpcError as e:
            return e.code().value[0], e.details()


CALLS = {
    "unknown method": ("Nope", b"a", 12),
    "raising handler": ("Boom", b"a", 2),
    "request over 4 MiB": ("Echo", b"y" * (4 * 1024 * 1024 + 1), 8),
    "answer over 4 MiB": ("Big", b"a", 8),
    "echo past the windows": ("Echo", b"e" * 300_000, "ok"),
}


@pytest.mark.parametrize("case", sorted(CALLS))
async def test_status_codes_match_grpcio(case):
    method, payload, code = CALLS[case]
    got = {}
    for server_kind in ("port", "grpcio"):
        server, addr = await _serve(server_kind)
        try:
            for client_kind in ("port", "grpcio"):
                got[(server_kind, client_kind)] = await _call(client_kind, addr, method, payload)
        finally:
            if server_kind == "port":
                await server.stop()
            else:
                await server.stop(None)
    assert {v[0] for v in got.values()} == {code}
    assert len({v[1] for v in got.values()}) == 1, got  # the same details everywhere


# -- the BroadcastAPI on a node --------------------------------------------------


def _node(pkg_name, tmp_path, **cfg_fields):
    """A one-validator node of either package on the CPU, RPC off."""
    if pkg_name == "port":
        from tendermint_tpu_torch import config as cfgmod
        from tendermint_tpu_torch import node as nodemod
        from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
        from tendermint_tpu_torch.types import genesis as genmod
        from tendermint_tpu_torch.types.params import BlockParams, ConsensusParams
        from tendermint_tpu_torch.types.priv_validator import MockPV
    else:
        from tendermint_tpu import config as cfgmod
        from tendermint_tpu import node as nodemod
        from tendermint_tpu.crypto.keys import Ed25519PrivKey
        from tendermint_tpu.types import genesis as genmod
        from tendermint_tpu.types.params import BlockParams, ConsensusParams
        from tendermint_tpu.types.priv_validator import MockPV
    key = Ed25519PrivKey.from_secret(b"grpc-node")
    gen = genmod.GenesisDoc("grpc-chain", genesis_time_ns=1_700_000_000 * 10**9, validators=[
        genmod.GenesisValidator(key.pub_key().address(), key.pub_key(), 10)],
        consensus_params=ConsensusParams(block=BlockParams(time_iota_ms=1)))
    cfg = cfgmod.test_config(str(tmp_path / pkg_name))
    cfg.rpc.laddr = ""
    cfg.p2p.laddr = "none"
    cfg.base.db_backend = "memdb"
    for path, value in cfg_fields.items():
        section, field = path.split(".")
        setattr(getattr(cfg, section), field, value)
    kwargs = {"device": "cpu"} if pkg_name == "port" else {}
    return nodemod.Node(cfg, gen, priv_validator=MockPV(key), db_backend="memdb", **kwargs)


@pytest.mark.parametrize("node_pkg,client_pkg", [("port", "jax"), ("jax", "port"),
                                                 ("port", "port")])
async def test_broadcast_api_ping_and_broadcast_tx(node_pkg, client_pkg, tmp_path):
    node = _node(node_pkg, tmp_path, **{"rpc.grpc_laddr": "127.0.0.1:0"})
    await node.start()
    try:
        client = PKGS[client_pkg]["api"].BroadcastAPIClient(node.grpc_server.bound_addr)
        await client.start()
        try:
            assert await client.ping() == {}
            res = await client.broadcast_tx(b"gk=gv")
            again = await client.broadcast_tx(b"gk2=gv2")
        finally:
            await client.stop()
    finally:
        await node.stop()
    want = {"code": 0, "data": b"", "log": ""}
    assert res == again == {"check_tx": want, "deliver_tx": want}


@pytest.mark.parametrize("app_pkg", ["port", "jax"])
async def test_port_node_runs_against_a_grpc_app(app_pkg, tmp_path):
    pkg = PKGS[app_pkg]
    server = pkg["transport"].GRPCServer("127.0.0.1:0", pkg["examples"].KVStoreApplication())
    await server.start()
    node = _node("port", tmp_path, **{"base.proxy_app": server.bound_addr, "base.abci": "grpc"})
    try:
        await node.start()
        assert isinstance(node.proxy_app.consensus(), pgrpc_abci.GRPCClient)
        await node.mempool.check_tx(b"grpc=works")
        # the tx is in the mempool: it is in the block after the one being
        # proposed now at the latest, and the app has it once that block is
        # applied (the block store saves a block before its apply ends)
        top = max(2, node.block_store.height() + 2)

        async def reach(h):
            while node.state_store.load().last_block_height < h:
                await asyncio.sleep(0.02)

        await asyncio.wait_for(reach(top), 30.0)
        q = await node.proxy_app.query().query(pabci.RequestQuery(path="/key", data=b"grpc"))
        assert q.value == b"works"
    finally:
        await node.stop()
        await server.stop()


# -- abci_cli --abci grpc --------------------------------------------------------


class _Served:
    """A GRPCServer on a loop of its own thread, for the CLI's asyncio.run."""

    def __init__(self, pkg, app):
        self.loop = asyncio.new_event_loop()
        self.server = pkg["transport"].GRPCServer("127.0.0.1:0", app)
        self.loop.run_until_complete(self.server.start())
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def close(self):
        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


ONESHOT = [["echo", "hi there"], ["check_tx", "0x61"], ["deliver_tx", "abc=def"],
           ["commit"], ["query", "abc"], ["set_option", "a", "b"], ["deliver_tx"]]
BATCH = "deliver_tx 0x6b3d76\ncheck_tx 0x00\ncommit\nquery 0x6b\nbogus 1\necho one\n"


def test_abci_cli_over_grpc_prints_the_jax_lines(capsys, monkeypatch):
    outs = {}
    for name, pkg in PKGS.items():
        served = _Served(pkg, pkg["examples"].KVStoreApplication())
        try:
            lines = []
            for argv in ONESHOT:
                rc = pkg["cli"].main(["--abci", "grpc", "--address", served.server.bound_addr,
                                      *argv])
                cap = capsys.readouterr()
                lines.append((argv, rc, cap.out, cap.err))
            monkeypatch.setattr("sys.stdin", io.StringIO(BATCH))
            rc = pkg["cli"].main(["--abci", "grpc", "--address", served.server.bound_addr,
                                  "batch"])
            cap = capsys.readouterr()
            lines.append(("batch", rc, cap.out, cap.err))
            outs[name] = lines
        finally:
            served.close()
    assert outs["port"] == outs["jax"]
    assert "-> value: v" in outs["port"][-1][2] and outs["port"][-1][1] == 1


def test_abci_cli_info_over_grpc_prints_height_and_app_hash(capsys):
    app = pexamples.KVStoreApplication()
    app.deliver_tx(pabci.RequestDeliverTx(tx=b"a=1"))
    app.commit(pabci.RequestCommit())
    served = _Served(PORT, app)
    try:
        assert pcli.main(["--abci", "grpc", "--address", served.server.bound_addr, "info"]) == 0
    finally:
        served.close()
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2:] == ["-> last_block_height: 1",
                          f"-> last_block_app_hash: 0x{app.app_hash.hex().upper()}"]
