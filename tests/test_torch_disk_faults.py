"""The port's disk-fault layer (tendermint_tpu_torch/chaos/disk.py) and the
node's wiring of it, against the JAX package's, tolerance exact.

- DiskFaultTable: the same seed and the same operation stream (policy
  changes, write checks, fsync checks, read mangles over every store) give
  the same outcomes (errno and text of each OSError, torn cut lengths,
  lying fsyncs, flipped bytes), counters per store and kind, and policies.
- FaultyDB over each package's MemDB: the same outcomes and the same cells.
- FaultyGroup over each package's autofile Group: the same file bytes
  (torn appends cut at the same offset), lied syncs, durable offsets and
  the same bytes lost to `simulate_crash`.
- rot_block_store on the same stored chain (tests/test_torch_chain_types)
  flips the same byte of the same part; both stores then refuse the block
  and quarantine the height.
- The flight spool on a FaultyGroup: torn and lying appends still replay,
  with `torn` counted.  The JAX FaultyGroup has no `_enforce_group_limit`,
  so a JAX spool on it fails every flush (ROADMAP 3.12); the port's
  delegates it.
- Port nodes (device="cpu"): with `[chaos] enabled` every store and WAL is
  wrapped (block store, state, app, consensus WAL, mempool WAL, spool);
  ENOSPC on the block store halts consensus cleanly with the read path up
  and a critical disk_fault alarm; a rotted block on a 4-node net is found
  by the integrity scan, quarantined and refilled from the peers; the
  scenario DSL's `disk`/`rot` clauses drive the InProcRig.
- Phase 17 (b) of chip_smoke.py rehearsed on the CPU.
"""

import asyncio
import os
import random

import pytest

import tendermint_tpu.chaos.disk as jdisk
import tendermint_tpu.libs.autofile as jautofile
import tendermint_tpu.libs.kvstore as jkvstore
import tendermint_tpu.libs.tracing as jtracing
from test_torch_chain_types import JAX, PORT, chain
from test_torch_chaos import (_cfg, _chaos_net, _pgenesis, _seeds, _stop, _wait_heights,
                              chaos_phase_rehearsal)
from tendermint_tpu_torch import chaos as pchaos
from tendermint_tpu_torch import node as pnode
from tendermint_tpu_torch.chaos import disk as pdisk
from tendermint_tpu_torch.config import test_config as ptest_config
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey as PPrivKey
from tendermint_tpu_torch.libs import autofile as pautofile
from tendermint_tpu_torch.libs import kvstore as pkvstore
from tendermint_tpu_torch.libs import tracing as ptracing
from tendermint_tpu_torch.types.priv_validator import MockPV as PMockPV

KINDS = ("enospc", "eio", "eio_fsync", "torn", "fsync_lie", "bitrot")


def _outcome(fn):
    try:
        return ("ok", fn())
    except OSError as e:
        return ("oserror", e.errno, str(e))
    except ValueError as e:
        return ("valueerror", str(e))


def _table_stream(disk, seed):
    t = disk.DiskFaultTable(seed=seed)
    rng = random.Random(seed * 31 + 1)
    stores = list(disk.STORES) + ["*", "floppy"]
    out = []
    for k in range(3000):
        r = rng.random()
        store = rng.choice(stores[:-2])
        if r < 0.08:
            target, kind = rng.choice(stores), rng.choice(KINDS + ("headcrash",))
            p = rng.choice([1.0, 0.5, 0.1, 0.0])
            out.append(_outcome(lambda: t.set_policy(target, disk.policy_for(kind, p))))
        elif r < 0.1:
            out.append(_outcome(lambda: t.heal(rng.choice([None, "*", store]))))
        elif r < 0.6:
            out.append(_outcome(lambda: t.check_write(store, rng.randrange(0, 300))))
        elif r < 0.8:
            out.append(_outcome(lambda: t.check_fsync(store)))
        else:
            value = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40)))
            out.append(_outcome(lambda: t.mangle_read(store, value)))
    return out, t.counters(), t.policies(), t.policy("wal").to_dict()


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_disk_fault_table_sequences_equal_jax(seed):
    j, p = _table_stream(jdisk, seed), _table_stream(pdisk, seed)
    assert p == j
    kinds = {k.split(":")[1] for k in p[1]}
    assert kinds == set(KINDS), p[1]  # every kind was injected
    assert any(o[0] == "valueerror" for o in p[0])


def test_policy_for_and_unknown_store_equal_jax():
    for kind in KINDS:
        for prob in (1.0, 0.25, 0.0):
            assert pdisk.policy_for(kind, prob).to_dict() == jdisk.policy_for(kind, prob).to_dict()
    assert (_outcome(lambda: pdisk.policy_for("headcrash"))
            == _outcome(lambda: jdisk.policy_for("headcrash")))
    assert (pdisk.STORES, pdisk.FAULT_KINDS) == (jdisk.STORES, jdisk.FAULT_KINDS)


def _db_stream(disk, kvstore, seed):
    t = disk.DiskFaultTable(seed=seed)
    db = disk.FaultyDB(kvstore.MemDB(), t, "state")
    rng = random.Random(seed)
    out = []
    for k in range(1500):
        r = rng.random()
        key = b"k%d" % rng.randrange(50)
        if r < 0.05:
            kind = rng.choice(KINDS)
            t.set_policy(rng.choice(["state", "*"]), disk.policy_for(kind, rng.choice([1.0, 0.3])))
        elif r < 0.08:
            t.heal()
        elif r < 0.35:
            out.append(_outcome(lambda: db.set(key, os.urandom(0) + b"v%d" % k)))
        elif r < 0.45:
            out.append(_outcome(lambda: db.delete(key)))
        elif r < 0.55:
            batch = [(b"b%d" % rng.randrange(20), b"w%d" % k) for _ in range(3)]
            out.append(_outcome(lambda: db.write_batch(batch, [key])))
        elif r < 0.85:
            out.append(_outcome(lambda: db.get(key)))
        elif r < 0.9:
            out.append(_outcome(lambda: db.has(key)))
        else:
            out.append(_outcome(lambda: list(db.iterate_prefix(b"b"))))
    return out, t.counters(), list(db.inner.iterate_prefix(b""))


def test_faulty_db_equal_jax():
    j = _db_stream(jdisk, jkvstore, 5)
    p = _db_stream(pdisk, pkvstore, 5)
    assert p == j
    assert any(o[0] == "oserror" for o in p[0]) and any(k.endswith(":bitrot") for k in p[1])


def _group_stream(disk, autofile, path, seed):
    t = disk.DiskFaultTable(seed=seed)
    g = disk.FaultyGroup(autofile.Group(path), t, "wal")
    rng = random.Random(seed)
    out = []
    for k in range(400):
        r = rng.random()
        if r < 0.1:
            t.set_policy("wal", disk.policy_for(rng.choice(KINDS[:5]), rng.choice([1.0, 0.3])))
        elif r < 0.15:
            t.heal()
        elif r < 0.7:
            payload = b"r%d-" % k + b"x" * rng.randrange(1, 200)
            out.append(_outcome(lambda: g.append_record(payload)))
        elif r < 0.8:
            out.append(_outcome(g.flush))
        else:
            out.append(_outcome(g.sync))
        out.append((g.durable_offset, g.lied_syncs))
    g.flush()
    lost = list(t.simulate_crash().values())
    g.close()
    with open(path, "rb") as f:
        raw = f.read()
    return out, t.counters(), lost, raw, [k for k, _, _ in autofile.walk_frames(raw, resync=True)]


def test_faulty_group_equal_jax(tmp_path):
    j = _group_stream(jdisk, jautofile, str(tmp_path / "j.wal"), 3)
    p = _group_stream(pdisk, pautofile, str(tmp_path / "p.wal"), 3)
    assert p == j
    assert "wal:torn" in p[1] and "wal:fsync_lie" in p[1] and p[2] and p[2][0] > 0


@pytest.mark.parametrize("height, part", [(2, 0), (3, 1), (5, 0)])
def test_rot_block_store_flips_the_same_byte_as_jax(height, part):
    out = []
    for ns, disk in ((JAX, jdisk), (PORT, pdisk)):
        c = chain(ns)
        db = ns.kvstore.MemDB()
        bs = ns.block_store.BlockStore(db)
        for h in sorted(c["blocks"]):
            bs.save_block(c["blocks"][h], c["parts"][h], c["commits"][h])
        before = db.get(b"P:%d:%d" % (height, part))
        info = disk.rot_block_store(bs, height, seed=9, part_index=part)
        after = db.get(b"P:%d:%d" % (height, part))
        assert before != after and len(before) == len(after)
        out.append((info, after, bs.load_block(height), bs.quarantined()))
        with pytest.raises(ValueError, match="no stored part"):
            disk.rot_block_store(bs, 99, seed=9)
    assert out[1][:2] == out[0][:2]
    assert out[1][2] is None and out[1][3] == [height] == out[0][3]


def _spool_run(tracing, disk, path, seed):
    rec = tracing.FlightRecorder(size=4096)
    spool = tracing.FlightSpool(path, rec, node="n", **({"run_id": "00000001"}
                                                         if tracing is ptracing else {}))
    t = disk.DiskFaultTable(seed=seed)
    spool._group = disk.FaultyGroup(spool._group, t, "spool")
    errors = []
    for k in range(30):
        for i in range(20):
            rec.record("step.propose", h=k, i=i)
        if k == 10:
            t.set_policy("spool", disk.policy_for("torn"))
        if k == 12:
            t.heal()
        if k == 20:
            t.set_policy("spool", disk.policy_for("fsync_lie"))
        try:
            spool.flush(sync=k % 3 == 0)
        except (OSError, AttributeError) as e:
            errors.append(type(e).__name__)
    return spool, t, errors


def test_spool_on_a_faulty_group_replays_with_torn_counted(tmp_path):
    path = str(tmp_path / "p" / "spool")
    os.makedirs(os.path.dirname(path))
    spool, t, errors = _spool_run(ptracing, pdisk, path, 4)
    assert errors == ["OSError", "OSError"]  # the torn appends at flushes 10 and 11
    assert t.counters()["spool:torn"] == 2 and t.counters()["spool:fsync_lie"] >= 3
    replay = ptracing.read_spool(path)
    assert replay["torn"] >= 1 and replay["runs"] == 1
    assert len(replay["events"]) >= 600 - 60  # all but the torn flushes' lines
    lost = t.simulate_crash()
    spool.close()
    assert sum(lost.values()) > 0
    assert ptracing.read_spool(path)["torn"] >= 1


def test_jax_faulty_group_lacks_the_spools_size_cap_where_the_port_delegates(tmp_path):
    """ROADMAP 3.12: the JAX FlightSpool enforces its size cap through
    `_group._enforce_group_limit()` on every flush, which the JAX
    FaultyGroup does not have: every flush of a chaos node's spool raises
    AttributeError (after its write, so its events are written again at
    the next flush).  The port's FaultyGroup delegates the call."""
    jpath = str(tmp_path / "j" / "spool")
    os.makedirs(os.path.dirname(jpath))
    _, _, errors = _spool_run(jtracing, jdisk, jpath, 4)
    assert set(errors) == {"AttributeError", "OSError"} and errors.count("AttributeError") == 28
    assert not hasattr(jdisk.FaultyGroup, "_enforce_group_limit")
    assert hasattr(pdisk.FaultyGroup, "_enforce_group_limit")


# -- port nodes ----------------------------------------------------------------------


async def test_chaos_on_wraps_every_store_and_wal(tmp_path, monkeypatch):
    app_dbs = []
    creator = pnode.default_client_creator
    monkeypatch.setattr(pnode, "default_client_creator",
                        lambda *a, **kw: app_dbs.append(kw["app_db"]) or creator(*a, **kw))
    seeds = _seeds(1, "wrap")
    cfg = _cfg(ptest_config, str(tmp_path / "wrap"))
    cfg.base.db_backend = "sqlite"
    cfg.mempool.wal_dir = "data/mempool.wal"
    cfg.instrumentation.flight_spool = True
    cfg.chaos.clock_skew = 0.5
    n = pnode.Node(cfg, _pgenesis(seeds), priv_validator=PMockPV(PPrivKey(seeds[0])),
                   device="cpu")
    await n.start()
    try:
        t = n.disk_faults
        assert isinstance(t, pdisk.DiskFaultTable) and t.seed == 1234
        dbs = {"blockstore": n.block_store.db, "state": n.state_db, "app": app_dbs[0]}
        for store, db in dbs.items():
            assert isinstance(db, pdisk.FaultyDB) and db.store == store
        groups = {"wal": n.consensus.wal.group, "mempool-wal": n.mempool._wal,
                  "spool": n.flight_spool._group}
        for store, g in groups.items():
            assert isinstance(g, pdisk.FaultyGroup) and g.store == store
        assert sorted(os.path.basename(g.head_path) for g in t._groups) == sorted(
            os.path.basename(g.head_path) for g in groups.values())
        assert t.metrics is n.metrics_provider.chaos and t.recorder is n.flight_recorder
        assert n.consensus.clock is n.chaos_clock and n.chaos_clock.skew_s == 0.5
        await _wait_heights([n], 2)
        n.flight_spool.flush()  # the spool flushes through the wrapper
    finally:
        await n.stop()


async def test_enospc_halts_consensus_cleanly_read_path_alive(tmp_path, capfd):
    """JAX TestCleanHaltOnStorageFault on a port node: ENOSPC on the block
    store halts consensus with the reason attributed, the read path serves
    history, the watchdog raises disk_fault as CRITICAL, and nothing says
    CONSENSUS FAILURE."""
    from tendermint_tpu_torch.libs.watchdog import Watchdog

    seeds = _seeds(1, "halt")
    cfg = _cfg(ptest_config, str(tmp_path / "halt"))
    cfg.p2p.laddr = "none"
    cfg.consensus.timeout_commit = 0.02
    node = pnode.Node(cfg, _pgenesis(seeds), priv_validator=PMockPV(PPrivKey(seeds[0])),
                      db_backend="memdb", device="cpu")
    await node.start()
    try:
        await _wait_heights([node], 2)
        node.disk_faults.set_policy("blockstore", pdisk.policy_for("enospc"))
        await asyncio.wait_for(node.consensus.wait_done(), 30.0)
        assert "ENOSPC" in node.consensus.halted_reason
        assert node.block_store.load_block(1) is not None
        assert node.storage_health.halts.get("consensus")
        assert Watchdog(node).check()["alarms"]["disk_fault"]["severity"] == "critical"
        assert node.disk_faults.counters()["blockstore:enospc"] >= 1
        out = capfd.readouterr()
        assert "CONSENSUS FAILURE" not in out.out + out.err
    finally:
        await node.stop()


async def test_rot_scan_quarantine_refill_from_peers(tmp_path):
    """JAX TestSelfHealingRefill on port nodes, driven by the scenario DSL:
    `rot 1 blockstore h=2` through the InProcRig rots node 1's stored part,
    the integrity scan quarantines it, the fast-sync channel refills it from
    the peers and node 1 serves the verified block again while the net
    keeps committing; a `disk` clause pair sets and heals a policy."""
    nodes = await _chaos_net(tmp_path, 4, "heal")
    rig = pchaos.InProcRig(nodes)
    try:
        await _wait_heights(nodes, 4)
        victim = nodes[1]
        good_hash = victim.block_store.load_block(2).hash()
        await pchaos.ScenarioRunner(pchaos.Scenario.parse(
            "rot 1 blockstore h=2 @0; disk 3 eio store=mempool-wal p=0.5 @0", seed=7), rig).run()
        assert nodes[3].disk_faults.policies() == {"mempool-wal": {
            "enospc": 0.0, "eio": 0.5, "eio_fsync": 0.0, "torn": 0.0, "fsync_lie": False,
            "bitrot": 0.0}}
        await rig.heal_disk(3)
        assert nodes[3].disk_faults.policies() == {}
        report = victim.block_store.integrity_scan()
        assert report["corrupt"] == [2]
        assert victim.block_store.load_block(2) is None  # never served corrupt
        victim.blockchain_reactor.request_refill(report["quarantined"])

        async def healed():
            while victim.block_store.load_block(2) is None:
                await asyncio.sleep(0.05)

        await asyncio.wait_for(healed(), 20.0)
        assert victim.block_store.load_block(2).hash() == good_hash
        assert victim.block_store.quarantined() == []
        assert victim.blockchain_reactor.refilled == 1
        tip = max(n.block_store.height() for n in nodes)
        await _wait_heights(nodes, tip + 1, timeout=20.0)
    finally:
        await _stop(nodes)


def test_phase17b_disk_faults_on_cpu(monkeypatch):
    out = chaos_phase_rehearsal(monkeypatch, "b")["b"]
    assert out["violations"] == [] and out["scan_checked"] >= 4
    assert 0 <= out["disk_fault_recovery_ms"] < 45_000
    assert 0 <= out["enospc_recovery_ms"] < 45_000
    assert out["store_integrity_scan_ms"] >= 0
    assert out["launches"] == [0, 0, 0, 0]  # the host path: no plain kernel ran
