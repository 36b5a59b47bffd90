"""The port's state sync (tendermint_tpu_torch/statesync: chunker.py,
syncer.py, reactor.py; lite2's HTTPProvider and LocalProvider; the node's
statesync wiring) against the JAX package's, and a port node and a JAX node
state-syncing from each other.

- ChunkScheduler: tests/test_statesync.py's cases (spread, timeout
  requeue, bad-hash ban, unsolicited, retry exhaustion, no peers), each
  driven on both packages by the same sequence of calls: the same requests,
  verdicts and states, tolerance 0.
- EngineCommitPreverify: one verify_many arrival per commit, on both
  packages, and verify_commit served from its cache.
- Live nets on 127.0.0.1 (memdb stores unless named, timeout_commit 0.1 s,
  snapshots every 4 heights in chunks of 256 bytes, PEX off; the port's
  engine on device="cpu", the kernels' plain versions): an empty port node
  bootstraps from a snapshot through LocalProviders; a crash mid-restore
  on sqlite, then a clean restart; unreachable trust servers fall back to
  fast sync from genesis; a chunk server that corrupts its chunks is
  reported while the restore completes; and the mixed net both ways, a
  port node from JAX validators over the JAX RPC and a JAX node from port
  validators over the port's RPC.  Each live wait runs under
  asyncio.wait_for with its own limit.
"""

import asyncio
import hashlib
import types

import pytest
import torch

import tendermint_tpu.statesync.chunker as jchunker
import tendermint_tpu.statesync.syncer as jsyncer
from tendermint_tpu.config import test_config as jtest_config
from tendermint_tpu.crypto.batch import host_batch_verify as jhost_batch_verify
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.node import Node as JNode
from tendermint_tpu.types import GenesisDoc as JGenesisDoc
from tendermint_tpu.types import GenesisValidator as JGenesisValidator
from tendermint_tpu.types import MockPV as JMockPV
from tendermint_tpu.types.params import BlockParams as JBP
from tendermint_tpu.types.params import ConsensusParams as JCP
from tendermint_tpu_torch.config import test_config as ptest_config
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey as PPrivKey
from tendermint_tpu_torch.libs import tracing as ptracing
from tendermint_tpu_torch.lite2.provider import LocalProvider
from tendermint_tpu_torch.node import Node as PNode
from tendermint_tpu_torch.rpc.core import RPCCore as PRPCCore
from tendermint_tpu_torch.statesync import chunker as pchunker
from tendermint_tpu_torch.statesync import reactor as preactor
from tendermint_tpu_torch.statesync import syncer as psyncer
from tendermint_tpu_torch.types.genesis import GenesisDoc as PGenesisDoc
from tendermint_tpu_torch.types.genesis import GenesisValidator as PGenesisValidator
from tendermint_tpu_torch.types.params import BlockParams as PBP
from tendermint_tpu_torch.types.params import ConsensusParams as PCP
from tendermint_tpu_torch.types.priv_validator import MockPV as PMockPV

torch.set_num_threads(1)

CHAIN_ID = "statesync-parity"
T0 = 1_700_000_000_000_000_000


# -- the chunk scheduler ----------------------------------------------------------


def _hashes(*chunks):
    return [hashlib.sha256(c).digest() for c in chunks]


def _state(s):
    return (list(s.status), dict(s.retries), sorted(s.owner.items()), sorted(s.banned),
            {p: sorted(v) for p, v in s.peers.items()}, s.apply_next, s.exhausted,
            {i: sorted(v) for i, v in s.avoid.items()})


def _spread(mod):
    chunks = [b"a", b"b", b"c", b"d"]
    s = mod.ChunkScheduler(_hashes(*chunks), max_inflight_per_peer=2)
    s.add_peer("p1")
    s.add_peer("p2")
    reqs = s.next_requests(0.0)
    for peer, idx in reqs:
        s.mark_requested(peer, idx, 0.0)
    assert {p for p, _ in reqs} == {"p1", "p2"}
    trace = [reqs, _state(s)]
    trace += [s.chunk_received(peer, idx, chunks[idx], 0.1) for peer, idx in reqs]
    applied = []
    while (item := s.next_apply()) is not None:
        applied.append(item)
        s.mark_applied(item[0])
    assert [i for i, _, _ in applied] == [0, 1, 2, 3] and s.done()
    return trace + [applied, _state(s)]


def _timeout(mod):
    s = mod.ChunkScheduler(_hashes(b"a"), timeout=1.0, max_retries=2)
    s.add_peer("p1")
    s.mark_requested("p1", 0, 0.0)
    trace = [s.next_requests(0.5), s.next_requests(2.0), _state(s), s.next_requests(10.0)]
    assert trace[3] == [("p1", 0)] and s.retries[0] == 1
    return trace


def _bad_hash(mod):
    s = mod.ChunkScheduler(_hashes(b"a"), max_retries=3)
    s.add_peer("bad")
    s.add_peer("good")
    s.mark_requested("bad", 0, 0.0)
    trace = [s.chunk_received("bad", 0, b"poison", 0.1), _state(s), s.next_requests(10.0)]
    assert trace[0] == "bad_hash" and trace[2] == [("good", 0)]
    s.mark_requested("good", 0, 10.0)
    trace += [s.chunk_received("good", 0, b"a", 10.1), _state(s)]
    s.add_peer("bad")  # a banned peer is not re-added
    return trace + [_state(s)]


def _unsolicited(mod):
    s = mod.ChunkScheduler(_hashes(b"a", b"b"))
    s.add_peer("p1")
    trace = [s.chunk_received("p1", 0, b"a", 0.0)]
    s.mark_requested("p1", 0, 0.0)
    trace += [s.chunk_received("p2", 0, b"a", 0.1), s.chunk_received("p1", 0, b"a", 0.1),
              s.chunk_received("p1", 0, b"a", 0.2), s.chunk_received("p1", 7, b"a", 0.2)]
    assert trace == ["unsolicited", "unsolicited", "ok", "dup", "unsolicited"]
    s.chunk_missing("p1", 1, 0.3)  # not requested: no requeue
    s.refetch(0, 0.4, avoid_peer="p1")
    return trace + [_state(s)]


def _exhausted(mod):
    s = mod.ChunkScheduler(_hashes(b"a"), timeout=0.1, max_retries=1)
    s.add_peer("p1")
    now, trace = 0.0, []
    for _ in range(10):
        if s.is_failed():
            break
        reqs = s.next_requests(now)
        trace.append(reqs)
        for peer, idx in reqs:
            s.mark_requested(peer, idx, now)
        now += 10.0
    assert s.is_failed()
    return trace + [_state(s)]


def _no_peers(mod):
    s = mod.ChunkScheduler(_hashes(b"a"))
    s.add_peer("p1")
    trace = [s.is_failed()]
    s.remove_peer("p1")
    trace += [s.is_failed(), _state(s)]
    assert trace[:2] == [False, True]
    with pytest.raises(ValueError, match="at least one chunk"):
        mod.ChunkScheduler([])
    return trace


@pytest.mark.parametrize("case", [_spread, _timeout, _bad_hash, _unsolicited, _exhausted,
                                  _no_peers], ids=lambda f: f.__name__[1:])
def test_chunk_scheduler_equals_jax(case):
    assert case(pchunker) == case(jchunker)


# -- the engine lane ----------------------------------------------------------


class _Lane:
    """A verify_many that answers on the host and records each arrival."""

    def __init__(self, host):
        self.calls, self.host = [], host

    def verify_many(self, items):
        self.calls.append(len(items))
        loop = asyncio.get_running_loop()
        futs = []
        for ok in self.host([i[0] for i in items], [i[1] for i in items], [i[2] for i in items]):
            f = loop.create_future()
            f.set_result(bool(ok))
            futs.append(f)
        return futs


async def test_engine_commit_preverify_is_one_arrival_per_commit():
    import test_torch_chain_types as tct

    for ns, mod, host in ((tct.PORT, psyncer, batch_hook.host_batch_verify),
                          (tct.JAX, jsyncer, jhost_batch_verify)):
        c = tct.chain(ns)
        block, commit = c["blocks"][5], c["commits"][5]
        vals = c["states"][4].validators
        signed = (psyncer.SignedHeader if mod is psyncer else jsyncer.SignedHeader)(
            block.header, commit)
        lane = _Lane(host)
        pre = mod.EngineCommitPreverify(lane)
        bv = await pre(signed, [vals])
        assert lane.calls == [vals.size()]  # one arrival, the whole commit
        vals.verify_commit(tct.CHAIN, c["ids"][5], 5, commit, batch_verify=bv)
        bv2 = await pre(signed, [vals])
        assert lane.calls == [vals.size()]  # the cache serves the second pass
        vals.verify_commit(tct.CHAIN, c["ids"][5], 5, commit, batch_verify=bv2)
        # a set that does not line up with the commit: left to verify_commit
        assert await pre(signed, [type(vals)(vals.validators[:3])]) is None


def test_statesync_frames_equal_jax():
    import tendermint_tpu.statesync.reactor as jreactor

    assert (preactor.SNAPSHOT_CHANNEL, preactor.CHUNK_CHANNEL) == (0x60, 0x61)
    assert preactor.MAX_SNAPSHOTS_PER_RESPONSE == jreactor.MAX_SNAPSHOTS_PER_RESPONSE
    assert preactor.CHUNK_RECV_CAPACITY == jreactor.CHUNK_RECV_CAPACITY
    for kind, fields in (("snapshots_request", {}),
                         ("snapshots_response", {"snapshots": [{
                             "height": 4, "format": 1, "chunks": 2, "hash": b"\x01" * 32,
                             "metadata": b"m"}]}),
                         ("chunk_request", {"height": 4, "format": 1, "index": 0}),
                         ("chunk_response", {"height": 4, "format": 1, "index": 0,
                                             "chunk": b"c", "missing": False})):
        assert preactor._enc(kind, fields) == jreactor._enc(kind, fields)
        assert preactor._dec(jreactor._enc(kind, fields)) == (kind, fields)
    p = [(c.id, c.priority, c.send_queue_capacity, c.recv_message_capacity)
         for c in preactor.StateSyncReactor(None).get_channels()]
    j = [(c.id, c.priority, c.send_queue_capacity, c.recv_message_capacity)
         for c in jreactor.StateSyncReactor(None).get_channels()]
    assert p == j


# -- live nets ------------------------------------------------------------------


def _seeds(n, tag):
    return sorted((bytes([i + 1]) * 16 + tag.encode().ljust(16, b"-") for i in range(n)),
                  key=lambda s: PPrivKey(s).pub_key().address())


def _genesis(seeds):
    jg = JGenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=T0, consensus_params=JCP(
        block=JBP(time_iota_ms=1)), validators=[
        JGenesisValidator(JPrivKey(s).pub_key().address(), JPrivKey(s).pub_key(), 10)
        for s in seeds])
    pg = PGenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=T0, consensus_params=PCP(
        block=PBP(time_iota_ms=1)), validators=[
        PGenesisValidator(PPrivKey(s).pub_key().address(), PPrivKey(s).pub_key(), 10)
        for s in seeds])
    return jg, pg


def _cfg(kind, home, db="memdb"):
    cfg = (jtest_config if kind == "jax" else ptest_config)(home)
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.base.db_backend = db
    cfg.p2p.laddr = "127.0.0.1:0"
    cfg.p2p.pex = False
    cfg.consensus.skip_timeout_commit = False
    cfg.consensus.timeout_commit = 0.1
    cfg.statesync.snapshot_interval = 4
    cfg.statesync.snapshot_chunk_bytes = 256  # a multi-chunk restore
    if kind == "port":
        cfg.tpu.enabled = True
    return cfg


def _node(kind, cfg, gens, seed=None):
    jg, pg = gens
    if kind == "jax":
        pv = JMockPV(JPrivKey(seed)) if seed else None
        return JNode(cfg, jg, priv_validator=pv, db_backend=cfg.base.db_backend)
    pv = PMockPV(PPrivKey(seed)) if seed else None
    return PNode(cfg, pg, priv_validator=pv, db_backend=cfg.base.db_backend, device="cpu")


async def _dial(a, b):
    await a.switch.dial_peer(f"{b.node_key.id}@{b.switch.transport.listen_addr}")


async def serving_net(tmp_path, kinds, name):
    """Validators of the given kinds, meshed, with RPC on and snapshots
    every 4 heights; a few txs so a snapshot spans several chunks."""
    seeds = _seeds(len(kinds), name)
    gens = _genesis(seeds)
    nodes = [_node(k, _cfg(k, str(tmp_path / f"{name}{i}")), gens, s)
             for i, (k, s) in enumerate(zip(kinds, seeds))]
    for n in nodes:
        await n.start()
    for i in range(len(nodes)):
        for j in range(i + 1, len(nodes)):
            await _dial(nodes[i], nodes[j])

    async def meshed():
        while not all(n.switch.num_peers() == len(nodes) - 1 for n in nodes):
            await asyncio.sleep(0.01)

    await asyncio.wait_for(meshed(), 10.0)
    for i in range(12):
        await nodes[0].mempool.check_tx(b"%s%d=%d" % (name.encode(), i, i))
    return nodes, gens


def joiner_config(kind, tmp_path, nodes, name, db="memdb"):
    """Trust root: node 0's header at height 2; trust servers: nodes 0 and
    1's RPC."""
    cfg = _cfg(kind, str(tmp_path / name), db=db)
    cfg.rpc.laddr = ""
    cfg.base.fast_sync = True
    cfg.statesync.enable = True
    cfg.statesync.rpc_servers = ",".join(n.rpc_server.listen_addr for n in nodes[:2])
    cfg.statesync.trust_height = 2
    cfg.statesync.trust_hash = nodes[0].block_store.load_block_meta(2).header.hash().hex()
    cfg.statesync.discovery_time = 0.5
    cfg.statesync.chunk_fetch_timeout = 5.0
    cfg.validate_basic()
    return cfg


async def _wait_height(nodes, h, timeout):
    async def reached():
        while not all(n.block_store.height() >= h for n in nodes):
            await asyncio.sleep(0.05)

    await asyncio.wait_for(reached(), timeout)


async def _stop(nodes):
    for n in nodes:
        if n is not None and n.is_running:
            await n.stop()
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)


async def _joined(joiner, nodes, above=3, timeout=40.0):
    target = nodes[0].block_store.height() + above
    await _wait_height([joiner], target, timeout)
    return target


def _check_joined(joiner, nodes, target):
    base = joiner.block_store.base()
    assert base > 1, "the joiner replayed from genesis"
    assert base % 4 == 0  # a snapshot height
    for h in range(base + 1, target):
        assert joiner.block_store.load_block(h).hash() == nodes[0].block_store.load_block(h).hash()
    return base


async def test_port_node_bootstraps_through_local_providers(tmp_path):
    """An empty port node restores a port validator's snapshot, its trust
    root read through LocalProviders on two validators (no HTTP), hands
    over to fast sync and follows the chain; its recorder holds the
    offer -> chunk -> restore -> handover chain and /status says so."""
    nodes, gens = await serving_net(tmp_path, ("port", "port", "port"), "local")
    joiner = None
    try:
        await _wait_height(nodes, 7, 40.0)
        cfg = joiner_config("port", tmp_path, nodes, "local-joiner")
        joiner = _node("port", cfg, gens)
        await joiner.start()
        assert joiner.statesync_reactor.syncing and joiner.rpc_server is None
        syncer = joiner.statesync_reactor.syncer
        syncer.provider_factory = lambda: (LocalProvider(nodes[0]), [LocalProvider(nodes[1])])
        for n in nodes:
            await _dial(joiner, n)
        target = await _joined(joiner, nodes)
        _check_joined(joiner, nodes, target)
        events = joiner.flight_recorder.events()
        assert ptracing.statesync_bootstrap_ms(events) > 0.0
        kinds = [e["kind"] for e in events if e["kind"].startswith("statesync.")]
        assert kinds.count("statesync.chunk") >= 2
        status = await PRPCCore(joiner).status()
        assert status["sync_info"]["sync_phase"] in ("fastsync", "caught_up")
        assert status["sync_info"]["earliest_block_height"] == joiner.block_store.base()
        assert status["sync_info"]["statesync"]["chunks_applied"] == syncer.chunks_total
    finally:
        await _stop([joiner] + nodes)


async def test_crash_mid_restore_then_recover(tmp_path):
    """The joiner (sqlite) stops while chunk 1 is held in the app; nothing
    is persisted, and a restart on the same home bootstraps cleanly."""
    nodes, gens = await serving_net(tmp_path, ("port", "port", "port"), "crash")
    joiner = None
    try:
        await _wait_height(nodes, 7, 40.0)
        cfg = joiner_config("port", tmp_path, nodes, "crash-joiner", db="sqlite")
        joiner = _node("port", cfg, gens)
        await joiner.start()
        conn = joiner.proxy_app.query()
        orig_apply = conn.apply_snapshot_chunk
        mid_restore, hold = asyncio.Event(), asyncio.Event()

        async def gated_apply(req):
            if req.index >= 1:
                mid_restore.set()
                await hold.wait()
            return await orig_apply(req)

        conn.apply_snapshot_chunk = gated_apply
        for n in nodes:
            await _dial(joiner, n)
        await asyncio.wait_for(mid_restore.wait(), 30.0)
        await joiner.stop()  # the crash, mid-restore
        assert joiner.block_store.height() == 0 and joiner.state_store.load() is None
        joiner = _node("port", cfg, gens)
        await joiner.start()
        assert joiner.statesync_reactor.syncing  # retries from empty
        for n in nodes:
            await _dial(joiner, n)
        target = await _joined(joiner, nodes, above=2)
        _check_joined(joiner, nodes, target)
    finally:
        await _stop([joiner] + nodes)


async def test_statesync_failure_falls_back_to_fast_sync(tmp_path, caplog):
    """No trust server answers: state sync gives up with the JAX messages
    and the node joins by fast sync from genesis (the handshake it skipped
    runs at the fallback)."""
    import logging

    caplog.set_level(logging.INFO, logger="statesync")
    nodes, gens = await serving_net(tmp_path, ("port", "port", "port"), "fb")
    joiner = None
    try:
        await _wait_height(nodes, 5, 40.0)
        cfg = joiner_config("port", tmp_path, nodes, "fb-joiner")
        cfg.statesync.rpc_servers = "127.0.0.1:1"  # nothing listens here
        cfg.statesync.discovery_time = 0.2
        joiner = _node("port", cfg, gens)
        await joiner.start()
        for n in nodes:
            await _dial(joiner, n)
        target = nodes[0].block_store.height() + 2
        await _wait_height([joiner], target, 60.0)
        assert joiner.block_store.base() == 1  # replayed from genesis
        assert not joiner.statesync_reactor.syncing
        records = [r.getMessage() for r in caplog.records if r.name == "statesync"]
        assert any("trust servers unreachable, giving up" in m for m in records)
        assert any("falling back to fastsync from local state" in m for m in records)
        for h in range(1, target):
            assert joiner.block_store.load_block(h).hash() == \
                nodes[0].block_store.load_block(h).hash()
    finally:
        await _stop([joiner] + nodes)


async def test_malicious_chunk_server_is_reported_and_the_restore_survives(tmp_path):
    nodes, gens = await serving_net(tmp_path, ("port", "port", "port"), "mal")
    joiner = None
    corrupted = []
    try:
        await _wait_height(nodes, 7, 40.0)
        evil = nodes[2].statesync_reactor

        async def corrupt_serve(peer, msg):
            corrupted.append(msg["index"])
            await peer.send(preactor.CHUNK_CHANNEL, preactor._enc("chunk_response", {
                "height": msg["height"], "format": msg["format"], "index": msg["index"],
                "chunk": b"\x66poison\x66", "missing": False}))

        evil._serve_chunk = corrupt_serve
        cfg = joiner_config("port", tmp_path, nodes, "mal-joiner")
        joiner = _node("port", cfg, gens)
        await joiner.start()
        reports = []
        syncer = joiner.statesync_reactor.syncer
        orig_report = syncer.report_bad_peer

        async def spy_report(peer_id, reason):
            reports.append((peer_id, reason))
            await orig_report(peer_id, reason)

        syncer.report_bad_peer = spy_report
        for n in nodes:
            await _dial(joiner, n)
        target = await _joined(joiner, nodes, above=2)
        _check_joined(joiner, nodes, target)
        if corrupted:
            assert any(pid == nodes[2].node_key.id and "hash mismatch" in why
                       for pid, why in reports), reports
    finally:
        await _stop([joiner] + nodes)


@pytest.mark.parametrize("joiner_kind,net_kind", [("port", "jax"), ("jax", "port")])
async def test_mixed_net_state_sync(tmp_path, joiner_kind, net_kind):
    """A port node restores a JAX validator's snapshot with its trust root
    read from the JAX RPC servers; and a JAX node a port validator's, read
    from the port's RPC servers.  Both then follow the chain."""
    nodes, gens = await serving_net(tmp_path, (net_kind,) * 3, f"mix-{net_kind}")
    joiner = None
    try:
        await _wait_height(nodes, 7, 40.0)
        cfg = joiner_config(joiner_kind, tmp_path, nodes, "mix-joiner")
        joiner = _node(joiner_kind, cfg, gens)
        await joiner.start()
        assert joiner.statesync_reactor.syncing
        for n in nodes:
            await _dial(joiner, n)
        target = await _joined(joiner, nodes, above=2)
        base = _check_joined(joiner, nodes, target)
        assert joiner.state_store.load().last_block_height >= base
    finally:
        await _stop([joiner] + nodes)
