"""The port's tx-ingress load generator (tendermint_tpu_torch/tools/loadgen.py,
on the port's own HTTP/1.1 client) against the JAX package's (on aiohttp).

- `make_tx` gives the JAX bytes: signed and plain, with and without a fee,
  several workers, sequence numbers and sizes.
- `run_load` against a port node and against a JAX node (each on the CPU,
  RPC on a local port) gives the JAX report's keys, and its split adds up:
  offered = accepted + rejected + throttled + transport errors.
- A node with a per-source broadcast rate limit yields `throttled` with
  retry_after hints, never `transport` (JAX tests/test_overload.py:529).
- `run_lite_load` against the port's liteserve gateway gives the JAX
  report's keys, every tenant sustained and no transport error.
- `--mode bank` exits 2 naming ROADMAP 1.8; the CLI parses the JAX flags.
"""

import asyncio

import pytest

from tendermint_tpu.crypto.keys import Ed25519PrivKey as JKey
from tendermint_tpu.tools import loadgen as jloadgen
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey as PKey
from tendermint_tpu_torch.tools import loadgen as ploadgen


@pytest.mark.parametrize("worker,seq,tx_bytes,fee,signed", [
    (0, 0, 250, 0, True), (7, 12345, 250, 0, True), (3, 9, 96, 2, True),
    (1, 1, 40, 0, True), (5, 77, 192, 0, False), (2, 3, 60, 9, False)])
def test_make_tx_bytes_equal_jax(worker, seq, tx_bytes, fee, signed):
    secret = b"loadgen-%d" % worker
    got = ploadgen.make_tx(PKey.from_secret(secret), worker, seq, tx_bytes, fee=fee,
                           signed=signed)
    assert got == jloadgen.make_tx(JKey.from_secret(secret), worker, seq, tx_bytes, fee=fee,
                                   signed=signed)
    assert ploadgen.worker_key(worker).pub_key().bytes() == PKey.from_secret(
        secret).pub_key().bytes()


def _node(pkg, tmp_path, mutate=None):
    """A one-validator node of the package on the CPU with RPC on a local port."""
    if pkg == "port":
        from tendermint_tpu_torch import config as cfgmod
        from tendermint_tpu_torch import node as nodemod
        from tendermint_tpu_torch.types import genesis as genmod
        from tendermint_tpu_torch.types.params import BlockParams, ConsensusParams
        from tendermint_tpu_torch.types.priv_validator import MockPV
        key = PKey.from_secret(b"loadgen-node")
    else:
        from tendermint_tpu import config as cfgmod
        from tendermint_tpu import node as nodemod
        from tendermint_tpu.types import genesis as genmod
        from tendermint_tpu.types.params import BlockParams, ConsensusParams
        from tendermint_tpu.types.priv_validator import MockPV
        key = JKey.from_secret(b"loadgen-node")
    gen = genmod.GenesisDoc("loadgen-chain", genesis_time_ns=1_700_000_000 * 10**9, validators=[
        genmod.GenesisValidator(key.pub_key().address(), key.pub_key(), 10)],
        consensus_params=ConsensusParams(block=BlockParams(time_iota_ms=1)))
    cfg = cfgmod.test_config(str(tmp_path / pkg))
    cfg.base.db_backend = "memdb"
    cfg.p2p.laddr = "none"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.mempool.sig_precheck = True
    if mutate:
        mutate(cfg)
    kwargs = {"device": "cpu"} if pkg == "port" else {}
    return nodemod.Node(cfg, gen, priv_validator=MockPV(key), db_backend="memdb", **kwargs)


async def _live(pkg, tmp_path, mutate=None):
    node = _node(pkg, tmp_path, mutate)
    await node.start()
    while node.block_store.height() < 1:
        await asyncio.sleep(0.02)
    return node


def _split_adds_up(r):
    return r["offered"] == r["accepted"] + r["rejected"] + r["throttled"] + r["transport_errors"]


@pytest.mark.parametrize("node_pkg", ["port", "jax"])
async def test_run_load_report_against_a_node(node_pkg, tmp_path):
    node = await _live(node_pkg, tmp_path)
    try:
        report = await ploadgen.run_load([node.rpc_server.listen_addr], duration=1.5, rate=60,
                                         connections=3, tx_bytes=120)
        jreport = await jloadgen.run_load([node.rpc_server.listen_addr], duration=0.5, rate=20,
                                          connections=2, tx_bytes=120)
        mempool_txs = [tx for tx in getattr(node.mempool, "txs").values()]
    finally:
        await node.stop()
    assert set(report) == set(jreport)
    assert report["mode"] == "sync" and report["tx_bytes"] == 120 and report["connections"] == 3
    assert report["accepted"] > 0 and report["transport_errors"] == 0
    assert report["rejected"] == 0 and _split_adds_up(report) and _split_adds_up(jreport)
    assert report["commits_under_load"] >= 1
    assert isinstance(mempool_txs, list)


async def test_rate_limited_node_throttles_not_transport(tmp_path):
    def qos(cfg):
        cfg.rpc.broadcast_rate = 30.0
        cfg.rpc.broadcast_rate_burst = 10

    node = await _live("port", tmp_path, qos)
    try:
        result = await ploadgen.run_load([node.rpc_server.listen_addr], duration=1.5, rate=0.0,
                                         connections=2, tx_bytes=96, mode="sync", fee=2)
    finally:
        await node.stop()
    assert result["accepted"] > 0
    assert result["throttled"] > 0
    assert result["retry_after_seen"] == result["throttled"]
    assert result["transport_errors"] == 0
    assert result["tx_ingress_sustained_tps"] > 0
    assert result["commits_under_load"] >= 1
    assert _split_adds_up(result)


async def test_run_lite_load_against_the_port_gateway(tmp_path):
    import test_torch_execution as tex
    from test_torch_liteserve import gateway_node

    from tendermint_tpu_torch.crypto import batch as batch_hook

    home = str(tmp_path / "gw")
    await tex.run_chain(tex.PORT, home=home)
    db = tex.PORT.kvstore.open_db("blockstore", home)
    root = tex.PORT.BlockStore(db).load_block_meta(2).header.hash()
    db.close()
    node = gateway_node(tex.PORT, home, root)
    await node.start()
    try:
        report = await ploadgen.run_lite_load(node.liteserve.listen_addr, sessions=3,
                                              duration=1.0, trust_height=2,
                                              trust_hash=root.hex())
    finally:
        await node.stop()
        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)
    want_keys = {"duration_s", "lite_sessions", "lite_sessions_sustained",
                 "lite_bisections_per_sec", "lite_cache_hit_ratio", "lite_verify_coalesce_ratio",
                 "lite_commit_latency_ms", "lite_requests_completed", "lite_throttled",
                 "lite_rejected", "lite_transport_errors", "lite_server_verify",
                 "lite_server_sessions"}
    assert set(report) == want_keys
    assert report["lite_sessions_sustained"] == 3 and report["lite_requests_completed"] > 0
    assert report["lite_transport_errors"] == 0 and report["lite_rejected"] == 0
    assert report["lite_server_verify"] and report["lite_commit_latency_ms"]["p50"] >= 0


def test_bank_mode_exits_2_naming_the_roadmap_item(capsys):
    assert ploadgen.main(["127.0.0.1:1", "--mode", "bank"]) == 2
    assert "ROADMAP 1.8" in capsys.readouterr().err
    with pytest.raises(ValueError, match=r"ROADMAP 1\.8"):
        asyncio.run(ploadgen.run_load(["127.0.0.1:1"], mode="bank"))


def test_percentiles_equal_jax():
    xs = [5.0, 1.0, 3.5, 9.25, 7.0, 2.0, 8.5]
    assert ploadgen.percentiles(xs) == jloadgen.percentiles(xs)
    assert ploadgen.percentiles([]) == jloadgen.percentiles([])
