"""The port's light proxy (tendermint_tpu_torch/lite2/proxy.py `LightProxy`
and `run_proxy`, the CLI's `light`) against the JAX package's, tolerance
exact.

One port RPC server serves a 4-validator chain (tests/test_torch_execution
run_chain on sqlite: 6 heights, two validators rotated out and two in from
height 4).  A port LightProxy (port lite2 client, port HTTPProvider) and a
JAX LightProxy (JAX client and provider, on aiohttp) both trust header 1
and sit in front of it.  The same raw HTTP requests, in the same order, to
both proxies give the same status and the same JSON: every verified route
by GET and by POST envelope, heights 0, inside and above the tip, an
unknown route, an oversized body, malformed bodies and unrouted paths
(an internal error that names a function's module is compared with the
package names made equal).
Blocks and validator sets served are the node's own.  Neither proxy has a
crypto.batch hook installed, so both verify on their host paths.  The
port's `light` command takes the JAX command's flags and exits 1 without a
card, before anything starts.
"""

import asyncio
import json
import os
import shutil
import subprocess
import sys

import pytest

import tendermint_tpu.cli as jcli
import tendermint_tpu.lite2 as jlite2
import tendermint_tpu.lite2.proxy as jproxy
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu_torch import cli as pcli
from tendermint_tpu_torch import lite2 as plite2
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.lite2 import proxy as pproxy
from tendermint_tpu_torch.rpc import server as pserver
from tendermint_tpu_torch.rpc.jsonrpc import to_jsonable

import test_torch_execution as tex
from test_torch_rpc import PORT, _get, _post, _raw, _view, rpc_node

N_VALS = 4
MAX_BODY = 256
PERIOD_NS = 100 * 365 * 86400 * 10**9


@pytest.fixture(autouse=True)
def no_hooks():
    saved = jbatch._verifier, jbatch._indexed_verifier
    for hook in (jbatch, batch_hook):
        hook.set_verifier(None)
        hook.set_indexed_verifier(None)
    try:
        yield
    finally:
        jbatch.set_verifier(saved[0])
        jbatch.set_indexed_verifier(saved[1])


@pytest.fixture(scope="module")
def chain_home(tmp_path_factory):
    """The port's 4-validator chain on sqlite, built once."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tex, "N_VALS", N_VALS)
    home = str(tmp_path_factory.mktemp("light-proxy") / "chain")
    try:
        asyncio.run(tex.run_chain(PORT, home=home))
        yield home, mp
    finally:
        mp.undo()


def proxies(addr, trust):
    """The port's and the JAX package's LightProxy on the RPC server at
    `addr`, both trusting header 1."""
    out = {}
    for name, lite2, mod in (("port", plite2, pproxy), ("jax", jlite2, jproxy)):
        client = lite2.Client(
            tex.CHAIN, lite2.TrustOptions(PERIOD_NS, 1, trust),
            lite2.HTTPProvider(tex.CHAIN, addr), mode=lite2.BISECTION)
        out[name] = mod.LightProxy(client, "tcp://127.0.0.1:0", max_body_bytes=MAX_BODY)
    return out


def envelope(method, params, req_id=5):
    return json.dumps({"jsonrpc": "2.0", "id": req_id, "method": method,
                       "params": params}).encode()


REQUESTS = [
    _get("/status"), _get("/commit?height=2"), _get("/commit?height=5"), _get("/commit"),
    _get("/block?height=3"), _get("/validators?height=3"), _get("/validators?height=5"),
    _post(envelope("commit", {"height": 4})), _post(envelope("validators", {})),
    _post(envelope("block", {"height": 6})), _get("/status"),
    # a height above the tip
    _get("/commit?height=99"), _get("/block?height=99"),
    # an unknown route, by GET and by POST; bad parameters
    _get("/nope"), _post(envelope("nope", {})), _get("/commit?height=abc"),
    _post(envelope("commit", [1])),
    # an oversized body and malformed ones
    _post(b"x" * (MAX_BODY + 1)), _post(b"{nope"), _post(b"[1, 2, 3]"),
    _post(b'{"jsonrpc": "2.0", "id": 1}'),
    # unrouted paths and methods
    _get("/"), _get("/a/b"), _post(envelope("status", {}), path="/status"),
]


async def test_every_route_equals_the_jax_proxy(chain_home, tmp_path):
    home, _ = chain_home
    copy = str(tmp_path / "chain")
    shutil.copytree(home, copy)
    node = await rpc_node(PORT, copy)
    node.config.rpc.max_body_bytes = 1 << 20
    rpc = pserver.RPCServer(node, node.config.rpc)
    await rpc.start()
    pxs = {}
    try:
        trust = node.block_store.load_block(1).hash()
        pxs = proxies(rpc.listen_addr, trust)
        for p in pxs.values():
            await p.start()
        answers = {name: [] for name in pxs}
        for req in REQUESTS:
            for name, p in pxs.items():
                (resp,) = await _raw(p.listen_addr, req)
                answers[name].append(_view(resp))
        for i, req in enumerate(REQUESTS):
            assert same_package(answers["port"][i]) == answers["jax"][i], req
        got = answers["port"]
        # what the proxy served is the node's own, as the node's RPC serves it
        direct = [_view(r)[1]["result"] for r in await _raw(
            rpc.listen_addr, _get("/commit?height=2"), _get("/commit?height=5"),
            _get("/block?height=3"))]
        assert got[1][1]["result"]["signed_header"] == direct[0]["signed_header"]
        assert got[2][1]["result"]["signed_header"] == direct[1]["signed_header"]
        assert got[4][1]["result"] == direct[2]
        assert got[4][1]["result"]["block"] == to_jsonable(node.block_store.load_block(3))
        # a set as the node serves it, but its proposer priorities: the light
        # client's ValidatorSet derives its own when it builds the set (as
        # the JAX one does)
        for i, h in ((5, 3), (6, 5)):
            (page,) = await _raw(rpc.listen_addr, _get(f"/validators?height={h}&per_page=100"))
            res = got[i][1]["result"]
            assert (res["block_height"], res["total"]) == (h, N_VALS)
            assert without_priority(res["validators"]) == without_priority(
                _view(page)[1]["result"]["validators"])
        assert got[11][1]["error"]["code"] == -32603
        status = got[10][1]["result"]
        assert status["light_client"] is True and status["latest_trusted_height"] >= 6
        assert got[13][1]["error"] == {"code": -32602, "message": "unknown route nope"}
        assert got[17][1]["error"]["code"] == -32600 and str(MAX_BODY) in \
            got[17][1]["error"]["message"]
        assert got[18][1]["error"]["code"] == -32700
        assert [got[i][0] for i in (21, 22, 23)] == [405, 404, 405]
    finally:
        for p in pxs.values():
            await p.stop()
        for p in pxs.values():
            await p.client.primary.client.close()
        await rpc.stop()
        await node.event_bus.stop()
        await node.proxy_app.stop()
        for db in node.dbs.values():
            db.close()


def without_priority(vals):
    return [{k: v for k, v in val.items() if k != "proposer_priority"} for val in vals]


def same_package(answer):
    """An answer with the port's package name put back to the JAX one's
    (an internal error's text is the repr of a TypeError, which names the
    function's module)."""
    status, body = answer
    return status, json.loads(json.dumps(body).replace("tendermint_tpu_torch.", "tendermint_tpu."))


def test_light_command_parses_the_jax_flags_and_needs_a_card(capsys):
    argv = ["light", "--chain-id", "c", "--primary", "127.0.0.1:1", "--witnesses", "a,b",
            "--laddr", "tcp://127.0.0.1:2", "--height", "3", "--hash", "00" * 32,
            "--trusting-period", "60"]
    got = []
    for cli in (pcli, jcli):
        args = cli.build_parser().parse_args(argv)
        got.append({k: v for k, v in vars(args).items() if k not in ("fn", "home")})
    assert got[0] == got[1]
    assert pcli.main(argv) == 1
    err = capsys.readouterr().err
    assert err.startswith("light: ") and "CUDA" in err
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "tendermint_tpu_torch", *argv], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "light: " in r.stderr


def test_light_engine_serves_every_check_off_warmup_and_accounts_for_it():
    """`light`'s engine (node.install_engine, on the CPU here) is never in
    warmup mode: a set's first indexed check builds its table and is
    served, not declined, and no check takes the host-cold path.  Its exit
    line (cli.engine_account) gives launches, dispatch paths and table
    lookups, as phase 14 reads them."""
    import torch

    from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
    from tendermint_tpu_torch.config import Config
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
    from tendermint_tpu_torch.libs.tracing import FlightRecorder
    from tendermint_tpu_torch.node import install_engine, uninstall_engine

    n = 16  # the default min_device_batch: the smallest batch routed to the device path
    seeds = [bytes([i + 1]) * 32 for i in range(n)]
    keys = [Ed25519PrivKey(s) for s in seeds]
    msgs = [b"light-%d" % i for i in range(n)]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    sigs[3] = sigs[3][:5] + bytes([sigs[3][5] ^ 1]) + sigs[3][6:]
    pks = [k.pub_key().bytes() for k in keys]
    want = [JPrivKey(s).pub_key().verify(m, sig) for s, m, sig in zip(seeds, msgs, sigs)]
    assert want.count(False) == 1
    rec = FlightRecorder()
    bv, cache = install_engine(Config().tpu, torch.device("cpu"), recorder=rec)
    try:
        assert not bv._warmup_mode
        assert batch_hook.get_verifier() == bv.verify
        indexed = batch_hook.get_indexed_verifier()
        assert indexed == cache.verify_indexed
        assert indexed(b"set", lambda: pks, list(range(n)), msgs, sigs) == want
        assert indexed(b"set", None, list(range(n)), msgs, sigs) == want
        assert batch_hook.get_verifier()(pks, msgs, sigs) == want
    finally:
        uninstall_engine(bv, cache)
    assert batch_hook.get_indexed_verifier() is None
    account = {k: json.loads(v) for k, v in pcli.engine_account(rec).items()}
    assert account["tables"] == {"hit": 1, "miss": 1}
    paths = account["paths"]
    assert sum(paths.values()) == 3 and not set(paths) & {"host", "host-cold"}
    assert paths["device"] == 1
    assert set(account["launches"]) == {"ed25519_ladder", "ed25519_window_tables",
                                        "ed25519_tabulated"}
