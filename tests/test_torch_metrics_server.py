"""The port's /metrics listener (tendermint_tpu_torch/libs/metrics.py
`MetricsServer`, on rpc/http.py) against the JAX package's (on aiohttp),
tolerance exact; and the node's wiring of it and of the remote signer.

- For providers of each package fed the same updates (their creation time
  fixed, since the exposition carries each series' `_created`), GET
  /metrics gives status 200, the verbatim Content-Type `text/plain;
  version=0.0.4; charset=utf-8` and the exposition's bytes.  The two
  expositions are equal but for the HELP text of two series that the port
  words for its own backend (ROADMAP 3 deviations).  Other paths and
  methods get the JAX server's 404 and 405 answers.
- A listen address already taken gives the JAX OSError text; `bound_addr`
  resolves a `:0` port; a second `stop` does nothing.
- `check_ported` accepts `priv_validator_laddr`,
  `instrumentation.prometheus`, `rpc.grpc_laddr` (the BroadcastAPI) and
  `instrumentation.flight_spool` (the crash-persistent spool) and still
  refuses `tpu.mesh = "on"` and `chaos.enabled`; a port node with
  prometheus on serves its registry at the configured address.
"""

import asyncio
import socket
import time
import types

import pytest

import tendermint_tpu.libs.metrics as jmetrics
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch import node as pnode
from tendermint_tpu_torch.libs import metrics as pmetrics
from tendermint_tpu_torch.rpc import http as phttp

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# HELP texts the port words for its own backend (the JAX ones name XLA)
PORT_HELP = {
    "tendermint_verify_bucket_compiles": "Background builds of the CUDA kernel library.",
    "tendermint_verify_bls_tier": "Active BLS pairing tier: 1=C extension, 2=pure python "
                                  "reference.",
}


def providers(monkeypatch):
    """A provider of each package, created at one fixed time and fed the
    same updates."""
    with monkeypatch.context() as m:
        m.setattr(time, "time", lambda: 1_700_000_000.25)
        out = {"port": pmetrics.MetricsProvider(True, "metrics-parity"),
               "jax": jmetrics.MetricsProvider(True, "metrics-parity")}
    for p in out.values():
        p.consensus.height.set(42)
        p.consensus.validators.set(10_000)
        p.verify.batch_size.observe(9_999)
        p.verify.table_cache_hits.inc()
        p.verify.table_cache_misses.inc(2)
        p.mempool.size.set(17)
    return out


def strip_help(text: bytes) -> list:
    out = []
    for ln in text.decode().splitlines():
        for name in PORT_HELP:
            if ln.startswith(f"# HELP {name}"):
                ln = ln.split(" ", 3)[2]
        out.append(ln)
    return out


async def request(addr, head: bytes):
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        writer.write(head)
        await writer.drain()
        return await phttp.read_response(reader)
    finally:
        writer.close()


def get(path, method="GET"):
    return f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n".encode()


async def test_metrics_answers_equal_jax(monkeypatch):
    provs = providers(monkeypatch)
    servers = {"port": pmetrics.MetricsServer(provs["port"], "tcp://127.0.0.1:0"),
               "jax": jmetrics.MetricsServer(provs["jax"], "tcp://127.0.0.1:0")}
    answers = {}
    try:
        for name, srv in servers.items():
            await srv.start()
            assert srv.bound_addr.startswith("127.0.0.1:") and not srv.bound_addr.endswith(":0")
            answers[name] = [await request(srv.bound_addr, h) for h in (
                get("/metrics"), get("/"), get("/metrics/x"), get("/metrics", "POST"))]
    finally:
        for srv in servers.values():
            await srv.stop()
    for name, prov in provs.items():
        status, headers, body = answers[name][0]
        assert (status, headers["content-type"]) == (200, CONTENT_TYPE)
        assert body == prov.exposition()
    port, jax = answers["port"][0][2], answers["jax"][0][2]
    assert strip_help(port) == strip_help(jax)
    for name, text in PORT_HELP.items():
        assert f"# HELP {name}_total {text}" in port.decode() or \
            f"# HELP {name} {text}" in port.decode()
    assert b"tendermint_consensus_height{chain_id=\"metrics-parity\"} 42.0" in port
    # unrouted path and method: the JAX server's statuses and texts
    for got, want in zip(answers["port"][1:], answers["jax"][1:]):
        assert (got[0], got[2]) == (want[0], want[2])
    assert [a[0] for a in answers["port"][1:]] == [404, 404, 405]


async def test_bind_error_text_and_idempotent_stop():
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    holder.listen(1)
    addr = "tcp://127.0.0.1:%d" % holder.getsockname()[1]
    texts = []
    try:
        for mod in (pmetrics, jmetrics):
            srv = mod.MetricsServer(mod.MetricsProvider(False, "c"), addr)
            with pytest.raises(OSError) as e:
                await srv.start()
            texts.append(str(e.value))
            await srv.stop()
            await srv.stop()
    finally:
        holder.close()
    assert texts[0] == texts[1]
    assert texts[0].startswith(f"metrics server failed to bind {addr!r}: ")
    srv = pmetrics.MetricsServer(pmetrics.MetricsProvider(False, "c"), "127.0.0.1:0")
    await srv.start()
    status, headers, body = await request(srv.bound_addr, get("/metrics"))
    assert (status, body) == (200, b"")  # a disabled provider exposes nothing
    await srv.stop()
    await srv.stop()


def _cfg(tmp_path):
    cfg = pconfig.test_config(str(tmp_path / "h"))
    cfg.rpc.laddr = ""
    cfg.p2p.laddr = "none"
    cfg.base.db_backend = "memdb"
    return cfg


BOUNDARY = {
    "priv_validator_laddr": ("base", "priv_validator_laddr", "tcp://127.0.0.1:26659"),
    "prometheus": ("instrumentation", "prometheus", True),
    "socket_app": ("base", "proxy_app", "tcp://127.0.0.1:26658"),
    "grpc_laddr": ("rpc", "grpc_laddr", "tcp://127.0.0.1:36656"),
    "flight_spool": ("instrumentation", "flight_spool", True),
}
STILL_REFUSED = {
    "mesh_on": (("tpu", "mesh", "on"), r"2\.2"),
    "chaos": (("chaos", "enabled", True), r"1\.8"),
}


@pytest.mark.parametrize("case", sorted(BOUNDARY))
def test_check_ported_accepts_the_process_boundaries(case, tmp_path):
    section, field, value = BOUNDARY[case]
    cfg = _cfg(tmp_path)
    setattr(getattr(cfg, section), field, value)
    pnode.check_ported(cfg)


@pytest.mark.parametrize("case", sorted(STILL_REFUSED))
def test_check_ported_still_refuses(case, tmp_path):
    (section, field, value), item = STILL_REFUSED[case]
    cfg = _cfg(tmp_path)
    setattr(getattr(cfg, section), field, value)
    with pytest.raises(NotImplementedError, match=rf"\(ROADMAP {item}\); set "):
        pnode.check_ported(cfg)


async def test_node_serves_its_registry_at_the_configured_address(tmp_path):
    from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
    from tendermint_tpu_torch.types import genesis as pgenesis
    from tendermint_tpu_torch.types.priv_validator import MockPV

    cfg = _cfg(tmp_path)
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
    key = Ed25519PrivKey.from_secret(b"metrics-node")
    gen = pgenesis.GenesisDoc("metrics-node", genesis_time_ns=1_700_000_000 * 10**9,
                              validators=[pgenesis.GenesisValidator(
                                  key.pub_key().address(), key.pub_key(), 10, "v0")])
    node = pnode.Node(cfg, gen, priv_validator=MockPV(key), device="cpu")
    await node.start()
    try:
        for _ in range(2000):
            if node.block_store.height() >= 2:
                break
            await asyncio.sleep(0.005)
        status, headers, body = await request(node.metrics_server.bound_addr, get("/metrics"))
        height = node.consensus.rs.height
    finally:
        await node.stop()
    assert node.metrics_server._http is None  # stopped with the node
    assert (status, headers["content-type"]) == (200, CONTENT_TYPE)
    line = [ln for ln in body.decode().splitlines()
            if ln.startswith('tendermint_consensus_height{chain_id="metrics-node"}')]
    assert line and int(float(line[0].split()[-1])) in (height - 1, height)
    await node.metrics_server.stop()  # a second stop does nothing


def test_metrics_server_surface_matches_jax():
    assert pmetrics.MetricsServer.CONTENT_TYPE == jmetrics.MetricsServer.CONTENT_TYPE
    s = pmetrics.MetricsServer(types.SimpleNamespace(), "x:1")
    assert (s.listen_addr, s.bound_addr) == ("x:1", None)
