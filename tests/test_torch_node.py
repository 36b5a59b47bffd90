"""The port's Node (tendermint_tpu_torch/node.py) against the JAX package's:
a solo validator chain on sqlite stores, run as `default_new_node` from a
home directory made the same way in each package (config.toml by
save_config with p2p and RPC off, the genesis file, the FilePV files).

The JAX node runs with `tpu.enabled = False` (its host path); the port's
with its engine on device="cpu" (the kernels' plain versions).  Every
timeout waits for the test (a MockTicker put in place of the
TimeoutTicker), and a fixed clock stands in for SYSTEM_CLOCK, so both
packages give the same bytes.  Height 1 carries a val: tx adding a power-1
validator (which never votes), a kv tx and a signed envelope.  Compared,
exactly: block hashes, app hashes, State.to_dict, the FilePV state file,
the WAL records without their wall-clock time_ns, and the `valset.update`
recorder event's fields.  Then each package's node restarts from the
other's home and commits two more heights, and the two resumed chains
must agree.  Each configuration the port does not carry raises
NotImplementedError naming its ROADMAP item, before anything is opened
(`p2p.test_fuzz`, `chaos.enabled`, `tpu.bls_jax_aggregation` and
`tpu.mesh = "on"` now pass, and a node with `tpu.mesh = "on"` exports
`resolve_mesh`'s shard count, JAX's on its 8 virtual CPU devices); a
node with the flight spool on flushes on its cadence and stops with a
synced final flush; a stock `init` home (PEX on) with a seed starts, and
so does a node with `liteserve.enable`.
"""

import asyncio
import base64
import contextlib
import dataclasses
import functools
import gc
import os
import shutil
import time
import types

import pytest
import torch

import tendermint_tpu.chaos.clock as jclock
import tendermint_tpu.config as jconfig
import tendermint_tpu.consensus.state as jcs_state
import tendermint_tpu.consensus.ticker as jticker
import tendermint_tpu.mempool as jmempool
import tendermint_tpu.node as jnode
import tendermint_tpu.privval.file as jfile
import tendermint_tpu.types.genesis as jgenesis
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu_torch import config as pconfig
from tendermint_tpu_torch import mempool as pmempool
from tendermint_tpu_torch import node as pnode
from tendermint_tpu_torch.chaos import clock as pclock
from tendermint_tpu_torch.consensus import state as pcs_state
from tendermint_tpu_torch.consensus import ticker as pticker
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.libs import loopprof as ploopprof
from tendermint_tpu_torch.privval import file as pfile
from tendermint_tpu_torch.types import genesis as pgenesis

torch.set_num_threads(1)

PORT = types.SimpleNamespace(
    name="port", PrivKey=Ed25519PrivKey, clock=pclock, config=pconfig, cs_state=pcs_state,
    ticker=pticker, mempool=pmempool, node=pnode, file=pfile, genesis=pgenesis, device="cpu")
JAX = types.SimpleNamespace(
    name="jax", PrivKey=JPrivKey, clock=jclock, config=jconfig, cs_state=jcs_state,
    ticker=jticker, mempool=jmempool, node=jnode, file=jfile, genesis=jgenesis, device=None)

CHAIN = "node-parity"
SEC = 1_000_000_000
T0 = 1_700_000_000 * SEC
NOW_NS = T0 + 5 * SEC
HEIGHTS = 3  # the first run; each cross-resume adds RESUMED
RESUMED = 2


@pytest.fixture(autouse=True)
def _port_hook_guard():
    yield
    prof = ploopprof._ACTIVE
    if prof is not None:
        ploopprof._ACTIVE = None
        if prof._gc_cb is not None and prof._gc_cb in gc.callbacks:
            gc.callbacks.remove(prof._gc_cb)


class FixedClock:
    def time_ns(self) -> int:
        return NOW_NS

    def monotonic(self) -> float:
        return 1000.0


@contextlib.contextmanager
def held_clock_and_ticker(ns, tickers):
    """While the node starts: the fixed clock as SYSTEM_CLOCK, and every
    TimeoutTicker the ConsensusState makes a MockTicker that fires only
    when the test says so (kept in `tickers`)."""
    real_clock, real_ticker = ns.clock.SYSTEM_CLOCK, ns.cs_state.TimeoutTicker

    def make_ticker():
        t = ns.ticker.MockTicker()
        t.fire_on_schedule = set()
        tickers.append(t)
        return t

    ns.clock.SYSTEM_CLOCK = FixedClock()
    ns.cs_state.TimeoutTicker = make_ticker
    try:
        yield
    finally:
        ns.clock.SYSTEM_CLOCK, ns.cs_state.TimeoutTicker = real_clock, real_ticker


def keys(ns):
    return ns.PrivKey.from_secret(b"node-ours"), ns.PrivKey.from_secret(b"node-joiner")


def make_home(ns, home):
    """config.toml (p2p and RPC off, the signed-tx precheck on), the
    genesis file and the FilePV files, each written by the package."""
    cfg = ns.config.Config(home=home)
    cfg.base.chain_id = CHAIN
    cfg.p2p.laddr = "none"
    cfg.rpc.laddr = ""
    cfg.mempool.sig_precheck = True
    cfg.ensure_dirs()
    ns.config.save_config(cfg, os.path.join(home, "config", "config.toml"))
    ours, _ = keys(ns)
    ns.genesis.GenesisDoc(CHAIN, genesis_time_ns=T0, validators=[
        ns.genesis.GenesisValidator(ours.pub_key().address(), ours.pub_key(), 10, "v0")
    ]).save_as(cfg.genesis_file())
    ns.file.FilePV(
        ns.file.FilePVKey(ours.pub_key().address(), ours.pub_key(), ours,
                          cfg.priv_validator_key_file()),
        ns.file.FilePVLastSignState(file_path=cfg.priv_validator_state_file())).save()


def load_cfg(ns, home):
    cfg = ns.config.load_config(os.path.join(home, "config", "config.toml"))
    if ns is JAX:
        cfg.tpu.enabled = False  # the JAX engine would compile XLA kernels
    return cfg


async def until(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.002)


async def run_node(ns, home, top, txs=()):
    """Start the package's node from `home`, submit `txs`, commit up to
    height `top` (firing each NEW_HEIGHT timeout), stop.  Returns what the
    comparisons read."""
    tickers = []
    node = ns.node.default_new_node(load_cfg(ns, home), **(
        {"device": ns.device} if ns is PORT else {}))
    with held_clock_and_ticker(ns, tickers):
        await node.start()
    try:
        out = {"responses": []}
        for tx in txs:
            res = await node.mempool.check_tx(tx)
            out["responses"].append((res.code, res.log))
        ticker = tickers[-1]
        start = node.block_store.height()
        for h in range(start + 1, top + 2):
            await until(lambda: any(t.height == h and t.step == 1 for t in ticker.scheduled),
                        f"height {h}'s NEW_HEIGHT timeout")
            ti = [t for t in ticker.scheduled if t.height == h and t.step == 1][-1]
            if h <= top:
                ticker.fire(ti)
                await until(lambda: node.block_store.height() >= h, f"block {h}")
        if ns is PORT and txs:
            next_vals = node.state_store.load().next_validators
            await until(lambda: node.table_cache.has_table(next_vals.pubkeys_digest()),
                        "the rotated set's table")
            out["table_rebuilt"] = True
        if ns is PORT:
            out["hooks"] = (batch_hook.get_verifier() == node.batch_verifier.verify,
                            batch_hook.get_indexed_verifier() == node.table_cache.verify_indexed)
            out["lane"] = node.mempool.sig_verifier is node.async_verifier
            out["device"] = node.batch_verifier.device.type
    finally:
        await node.stop()
    if ns is PORT:
        out["hooks_after"] = (batch_hook.get_verifier(), batch_hook.get_indexed_verifier())
    out["valset_events"] = [
        {k: v for k, v in e.items() if k not in ("seq", "t_ns")}
        for e in node.flight_recorder.events(kinds=["valset.update"])]
    out["blocks"] = [node.block_store.load_block(h).hash() for h in range(1, top + 1)]
    state = node.state_store.load()
    out["state"] = state.to_dict()
    out["app_hash"] = state.app_hash
    with open(node.config.priv_validator_state_file(), "rb") as f:
        out["pv_state"] = f.read()
    wal = type(node.consensus.wal)(node.config.wal_file())  # reopened: stop closed it
    out["wal"] = [{k: v for k, v in r.items() if k != "time_ns"} for r in wal.all_records()]
    wal.close()
    out["profiler_released"] = ploopprof._ACTIVE is None
    return out


def height1_txs(ns):
    ours, joiner = keys(ns)
    return [b"val:" + base64.b64encode(joiner.pub_key().bytes()) + b"!1", b"a=b",
            ns.mempool.make_signed_tx(ours, b"s=1")]


async def test_solo_chain_and_cross_resume_match_jax(tmp_path):
    runs = {}
    for ns in (PORT, JAX):
        home = str(tmp_path / ns.name)
        make_home(ns, home)
        runs[ns.name] = await run_node(ns, home, HEIGHTS, height1_txs(ns))
    port, jax = runs["port"], runs["jax"]
    for key in ("responses", "blocks", "state", "app_hash", "pv_state", "wal", "valset_events"):
        assert port[key] == jax[key], key
    assert port["valset_events"] == [{"kind": "valset.update", "height": 1, "n_updates": 1,
                                      "new_size": 2, "uniform_bls": False}]
    assert port["state"]["last_block_height"] == HEIGHTS
    assert port["table_rebuilt"] and port["lane"] and port["device"] == "cpu"
    assert port["hooks"] == (True, True)
    assert port["hooks_after"] == (batch_hook.host_batch_verify, None)  # the defaults again
    assert port["profiler_released"] and jax["profiler_released"]
    # cross-resume: each package's node continues the other's home
    resumed = {}
    for ns, other in ((PORT, "jax"), (JAX, "port")):
        home = str(tmp_path / f"{ns.name}-on-{other}")
        shutil.copytree(str(tmp_path / other), home)
        resumed[ns.name] = await run_node(ns, home, HEIGHTS + RESUMED)
    for key in ("blocks", "state", "app_hash", "pv_state", "wal"):
        assert resumed["port"][key] == resumed["jax"][key], key
    assert resumed["port"]["blocks"][:HEIGHTS] == port["blocks"]
    assert resumed["port"]["state"]["last_block_height"] == HEIGHTS + RESUMED


def test_only_validator_is_us_equals_jax():
    for ns in (PORT, JAX):
        ours, joiner = keys(ns)
        gen = ns.genesis.GenesisDoc(CHAIN, genesis_time_ns=T0, validators=[
            ns.genesis.GenesisValidator(ours.pub_key().address(), ours.pub_key(), 10)])
        state = types.SimpleNamespace(validators=gen.validator_set())
        pv = types.SimpleNamespace(get_pub_key=ours.pub_key)
        other = types.SimpleNamespace(get_pub_key=joiner.pub_key)
        assert ns.node.only_validator_is_us(state, pv) is True
        assert ns.node.only_validator_is_us(state, other) is False
        assert ns.node.only_validator_is_us(state, None) is False


# item None: a setting the port now carries (the chaos rig lifted
# `p2p.test_fuzz` and `chaos.enabled`, the batched BLS fold
# `tpu.bls_jax_aggregation`, the verify mesh `tpu.mesh = "on"`);
# check_ported passes it
UNPORTED = {
    "test_fuzz": ("p2p.test_fuzz", True, None),
    "chaos": ("chaos.enabled", True, None),
    "mesh_on": ("tpu.mesh", "on", None),
    "bls_jax_aggregation": ("tpu.bls_jax_aggregation", True, None),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_configuration_raises_before_opening(case, tmp_path):
    home = str(tmp_path / "h")
    make_home(PORT, home)
    os.unlink(os.path.join(home, "config", "priv_validator_key.json"))
    path, value, item = UNPORTED[case]
    cfg = load_cfg(PORT, home)
    section, field = path.split(".")
    setattr(getattr(cfg, section), field, value)
    if item is None:
        pnode.check_ported(cfg)
        return
    gen = pgenesis.GenesisDoc.from_file(cfg.genesis_file())
    for build in (lambda: pnode.default_new_node(cfg, device="cpu"),
                  lambda: pnode.Node(cfg, gen, device="cpu")):
        with pytest.raises(NotImplementedError, match=rf"\(ROADMAP {item}\)"):
            build()
    assert sorted(os.listdir(os.path.join(home, "data"))) == ["priv_validator_state.json"]
    assert not os.path.exists(cfg.priv_validator_key_file())


@pytest.mark.parametrize("cpu_shards", [1, 8])
async def test_a_node_with_mesh_on_exports_resolve_mesh_shards(cpu_shards, tmp_path, monkeypatch):
    """`tpu.mesh = "on"` starts a node whose shards gauge, engine and log
    line carry resolve_mesh's triple: on 8 virtual CPU shards the JAX
    node's shard count on its 8 virtual CPU devices, on one a single
    device."""
    from tendermint_tpu.crypto.backend import resolve_mesh as jresolve
    from tendermint_tpu_torch.crypto import backend as pbackend
    from tendermint_tpu_torch.crypto.backend import resolve_mesh

    home = str(tmp_path / "mesh")
    make_home(PORT, home)
    cfg = load_cfg(PORT, home)
    cfg.tpu.mesh = "on"
    pnode.check_ported(cfg)
    _, shards, reason = resolve_mesh("on", 0, device="cpu", cpu_shards=cpu_shards)
    if cpu_shards == 8:
        assert (shards, reason) == jresolve("on", 0)[1:] == (8, "sharded over 8/8 cpu devices")
    else:
        assert (shards, reason) == (1, "single device (1 visible, cpu)")
    from tendermint_tpu_torch.libs import metrics as pmetrics

    seen = []

    class Provider(pmetrics.MetricsProvider):  # the shards gauge, recorded
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.verify.shards = types.SimpleNamespace(set=seen.append)

    monkeypatch.setattr(pmetrics, "MetricsProvider", Provider)
    # the node's probe sees `cpu_shards` virtual CPU shards
    monkeypatch.setattr(pbackend, "resolve_mesh",
                        functools.partial(resolve_mesh, cpu_shards=cpu_shards))
    node = pnode.default_new_node(cfg, device="cpu")
    await node.start()
    try:
        assert seen == [shards]
        bv = node.batch_verifier
        assert bv.shards == shards and node.table_cache.verifier is bv
        assert (bv.mesh is None) == (shards == 1)
        assert bv.mesh is None or bv.mesh.devices == (torch.device("cpu"),) * 8
        await until(lambda: node.block_store.height() >= 1, "the node's first block")
    finally:
        await node.stop()
        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)


async def test_flight_spool_flushes_on_its_cadence_and_stops_synced(tmp_path):
    """`instrumentation.flight_spool` on (ported from the JAX node's
    wiring): the spool is built at start with its crash hooks installed,
    its task flushes every `flight_spool_flush_interval` without an fsync,
    and the stop makes one synced final flush holding every recorded
    event, closes the spool and removes its hooks."""
    import sys

    from tendermint_tpu_torch.libs import tracing as ptracing

    home = str(tmp_path / "spool")
    make_home(PORT, home)
    cfg = load_cfg(PORT, home)
    cfg.instrumentation.flight_spool = True
    cfg.instrumentation.flight_spool_flush_interval = 0.05
    cfg.instrumentation.loop_probe_interval = 0.02  # events for every flush to write
    hook = sys.excepthook
    node = pnode.default_new_node(cfg, device="cpu")
    assert node.flight_spool is None
    syncs = []
    await node.start()
    try:
        sp = node.flight_spool
        assert sp._hooks_installed and sys.excepthook is sp._hook_fn
        assert "flight-spool" in {t.get_name() for t in node._tasks}
        real_sync = sp._group.sync

        def sync():
            syncs.append(sp.recorder._seq)
            real_sync()

        sp._group.sync = sync
        n0 = sp.flushes
        t0 = time.monotonic()
        await until(lambda: sp.flushes >= n0 + 3, "three cadence flushes")
        assert time.monotonic() - t0 >= 2 * cfg.instrumentation.flight_spool_flush_interval
        assert syncs == []
        node.flight_recorder.record("test.stop")  # an event only the final flush can write
    finally:
        await node.stop()
    assert len(syncs) == 1 and sp._closed and not sp._hooks_installed
    assert sys.excepthook is hook
    dump = ptracing.read_spool(cfg.flight_spool_file())
    assert dump["runs"] == 1 and dump["node"] == cfg.base.moniker and dump["torn"] == 0
    assert dump["next_seq"] == syncs[0] == node.flight_recorder._seq
    assert "test.stop" in [e["kind"] for e in dump["events"]]
    assert dump["events"][-50:] == node.flight_recorder.events()[-50:]


async def test_stock_init_home_with_a_seed_starts(tmp_path):
    """A home from the port's `init` keeps the JAX defaults (PEX on, fast
    sync on, 10 outbound peers); with a seed added (and local listeners) it
    builds and starts: the PEX reactor dials the seed (here a closed port,
    so the dial fails and the book scores it), and the stop saves the
    address book at addr_book_file()."""
    from tendermint_tpu_torch import cli as pcli
    from tendermint_tpu_torch.p2p.key import NodeKey

    home = str(tmp_path / "stock")
    assert pcli.main(["--home", home, "init", "--chain-id", "stock-home"]) == 0
    cfg = load_cfg(PORT, home)
    assert (cfg.p2p.pex, cfg.base.fast_sync, cfg.p2p.max_num_outbound_peers) == (True, True, 10)
    seed_id = NodeKey.load_or_gen(str(tmp_path / "seed_key.json")).id
    cfg.p2p.seeds = f"{seed_id}@127.0.0.1:1"
    cfg.p2p.laddr, cfg.rpc.laddr = "tcp://127.0.0.1:0", "tcp://127.0.0.1:0"
    node = pnode.default_new_node(cfg, device="cpu")
    await node.start()
    try:
        assert node.pex_reactor.seeds == [cfg.p2p.seeds]
        assert node.switch.addr_book is node.addr_book
        assert "PEX" in node.switch.reactors
        await until(lambda: node.addr_book.trust_value(seed_id) < 1.0, "the seed dial")
    finally:
        await node.stop()
    batch_hook.set_verifier(None)
    batch_hook.set_indexed_verifier(None)
    assert os.path.exists(cfg.addr_book_file())


async def test_liteserve_enable_builds(tmp_path):
    """`liteserve.enable` is ported: the node builds (the gateway starts
    with Node.start, tests/test_torch_liteserve.py drives it)."""
    home = str(tmp_path / "h")
    make_home(PORT, home)
    cfg = load_cfg(PORT, home)
    cfg.liteserve.enable = True
    gen = pgenesis.GenesisDoc.from_file(cfg.genesis_file())
    node = pnode.Node(cfg, gen, device="cpu")
    assert node.liteserve is None and node.config.liteserve.enable
    for db in (node.block_store.db, node.state_db):
        db.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_node_without_a_card_raises_before_opening(tmp_path):
    home = str(tmp_path / "h")
    make_home(PORT, home)
    cfg = load_cfg(PORT, home)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pnode.default_new_node(cfg)
    assert sorted(os.listdir(os.path.join(home, "data"))) == ["priv_validator_state.json"]
    cfg.tpu.enabled = False  # no engine: nothing needs the card
    node = pnode.default_new_node(cfg)
    assert node.device is None
    assert dataclasses.asdict(node.config) == dataclasses.asdict(cfg)
