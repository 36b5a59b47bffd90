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
- `make_bank_tx` gives the JAX bytes for the same key and sequence number,
  the overdraft slot and the nonce it reuses included; `_bank_start_seq`
  reads a worker's nonce lane from a port node on the bank app, as JAX's
  does from a JAX node; `run_load(mode="bank")` and the CLI's `--mode bank`
  against a port node on the bank app give the JAX report's keys, with the
  overdrafts as `app:13` and fault 3.13's `app:12` (ROADMAP 3).
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


@pytest.mark.parametrize("worker,seq,fee", [
    (0, 0, 0), (1, 1, 0), (2, 48, 0), (3, 49, 0), (3, 50, 0), (4, 99, 3), (5, 149, 0),
    (6, 1234, 1)])
def test_make_bank_tx_bytes_equal_jax(worker, seq, fee):
    """Slot 49 of every 50 is the overdraft (2^62) and reuses the nonce the
    next real transfer takes."""
    got = ploadgen.make_bank_tx(ploadgen.worker_key(worker), seq, fee=fee)
    assert got == jloadgen.make_bank_tx(JKey.from_secret(b"loadgen-%d" % worker), seq, fee=fee)
    assert ploadgen._HOT_ACCOUNT == jloadgen._HOT_ACCOUNT
    assert ploadgen._BANK_OVERDRAFT_EVERY == jloadgen._BANK_OVERDRAFT_EVERY == 50
    nonce = seq - seq // 50
    assert got.endswith(b":%d" % nonce)
    assert (b":%d:" % (1 << 62) in got) == (seq % 50 == 49)


def test_make_bank_tx_reuses_the_overdrafts_nonce():
    txs = [ploadgen.make_bank_tx(ploadgen.worker_key(0), seq) for seq in (48, 49, 50)]
    assert [tx.rsplit(b":", 1)[1] for tx in txs] == [b"48", b"49", b"49"]


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


def _bank(cfg):
    cfg.base.proxy_app = "bank"


async def _advance(node, wid, n):
    """Commit n transfers of worker `wid`'s key on the node, one a block."""
    for seq in range(n):
        tx = ploadgen.make_bank_tx(ploadgen.worker_key(wid), seq)
        h = node.block_store.height()
        assert (await node.mempool.check_tx(tx)).code == 0
        while node.block_store.height() < h + 2:
            await asyncio.sleep(0.02)


@pytest.mark.parametrize("node_pkg", ["port", "jax"])
async def test_bank_start_seq_reads_the_chains_nonce(node_pkg, tmp_path):
    """Both tools resume a worker's lane from `abci_query path=nonce` on a
    node of either package on the bank app: seq = nonce + nonce // 49."""
    import aiohttp

    from tendermint_tpu_torch.rpc.client import HTTPClient

    node = await _live(node_pkg, tmp_path, _bank)
    try:
        await _advance(node, 2, 3)
        target = node.rpc_server.listen_addr
        client = HTTPClient(target, timeout=5.0)
        try:
            got = [await ploadgen._bank_start_seq(client, ploadgen.worker_key(w)) for w in (2, 3)]
        finally:
            await client.close()
        async with aiohttp.ClientSession() as session:
            want = [await jloadgen._bank_start_seq(session, jloadgen._base_url(target),
                                                   JKey.from_secret(b"loadgen-%d" % w))
                    for w in (2, 3)]
        dead = HTTPClient("127.0.0.1:1", timeout=1.0)
        try:
            assert await ploadgen._bank_start_seq(dead, ploadgen.worker_key(2)) == 0
        finally:
            await dead.close()
    finally:
        await node.stop()
    assert got == want == [3, 0]


async def test_bank_mode_against_a_port_node_on_the_bank_app(tmp_path, capsys):
    """`--mode bank` runs: the JAX report's keys; accepted transfers move the
    hot account; overdrafts come back app:13; and most of a worker's later
    txs app:12, fault 3.13 (CheckTx reads committed nonces only, while the
    tool advances its lane on every send), as with the JAX tool."""
    node = await _live("port", tmp_path, _bank)
    try:
        target = node.rpc_server.listen_addr
        report = await ploadgen.run_load([target], duration=1.5, rate=200, connections=2,
                                         mode="bank")
        jreport = await jloadgen.run_load([target], duration=0.5, rate=40, connections=2,
                                          mode="bank")
        h = node.block_store.height()
        while node.block_store.height() < h + 2:
            await asyncio.sleep(0.02)
        hot = node.proxy_app.query().app._account(ploadgen._HOT_ACCOUNT)
        rc = await asyncio.get_event_loop().run_in_executor(None, ploadgen.main, [
            target, "--mode", "bank", "--duration", "0.5", "--rate", "20", "--connections", "1",
            "--json"])
    finally:
        await node.stop()
    assert set(report) == set(jreport) and report["mode"] == "bank"
    assert report["accepted"] > 0 and report["transport_errors"] == 0 and _split_adds_up(report)
    assert report["reject_codes"].get("app:12", 0) > 0
    assert set(report["reject_codes"]) <= {"app:12", "app:13"}
    assert hot[0] > 1_000_000
    assert rc == 0 and '"mode": "bank"' in capsys.readouterr().out


def test_percentiles_equal_jax():
    xs = [5.0, 1.0, 3.5, 9.25, 7.0, 2.0, 8.5]
    assert ploadgen.percentiles(xs) == jloadgen.percentiles(xs)
    assert ploadgen.percentiles([]) == jloadgen.percentiles([])
