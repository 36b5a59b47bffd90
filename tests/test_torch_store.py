"""The port's stores (tendermint_tpu_torch: libs/kvstore, BlockStore,
StateStore, lite2 DBStore, StorageHealth) against the JAX package's.

The kv backends take the same operations to the same answers; a sqlite
store written by either package is read by the other to equal blocks,
commits, metas, sets, params and states; and the integrity machinery
(seals, quarantine, the integrity scan, pruning, StorageHealth) answers
the same damage with the same results, exceptions and messages.  The
chains come from test_torch_chain_types.build_chain.
"""

import numpy as np
import pytest

from test_torch_chain_types import CHAIN, HEIGHTS, JAX, PART, PORT, chain, outcome

PKGS = {"port": PORT, "jax": JAX}


def _kv_ops(db, seed=3):
    """A seeded mix of sets, deletes and batches; returns every read."""
    rng = np.random.default_rng(seed)
    keys = [bytes(rng.integers(0, 4, int(rng.integers(1, 4)), dtype=np.uint8)) for _ in range(40)]
    keys += [b"\xff\xff", b"\xff\xff\x00", b"a", b"ab", b"b"]
    reads = []
    for step in range(120):
        op = int(rng.integers(0, 4))
        k = keys[int(rng.integers(0, len(keys)))]
        if op == 0:
            db.set(k, bytes([step % 256]) * int(rng.integers(0, 5)))
        elif op == 1:
            db.delete(k)
        elif op == 2:
            sets = [(keys[int(i)], bytes([step % 256])) for i in rng.integers(0, len(keys), 3)]
            db.write_batch(sets, [keys[int(i)] for i in rng.integers(0, len(keys), 2)])
        else:
            reads.append((db.get(k), db.has(k)))
    for prefix in (b"", b"\x00", b"\x01\x02", b"\xff", b"\xff\xff", b"a"):
        reads.append(list(db.iterate_prefix(prefix)))
    return reads


@pytest.mark.parametrize("backend", ["memdb", "sqlite"])
def test_kv_backends_match_jax(backend, tmp_path):
    ours = PORT.kvstore.open_db("kv", str(tmp_path / "port"), backend=backend)
    theirs = JAX.kvstore.open_db("kv", str(tmp_path / "jax"), backend=backend)
    assert type(ours).__name__ == type(theirs).__name__
    assert _kv_ops(ours) == _kv_ops(theirs)
    ours.close()
    theirs.close()


def _write_stores(ns, home):
    """Blocks, states, ABCI responses and a trusted store of `ns`'s chain
    into sqlite stores under `home`."""
    c = chain(ns)
    block_db = ns.kvstore.open_db("blockstore", home)
    state_db = ns.kvstore.open_db("state", home)
    light_db = ns.kvstore.open_db("light", home)
    bs, ss, ls = ns.block_store.BlockStore(block_db), ns.state_store.StateStore(state_db), \
        ns.lite_store.DBStore(light_db)
    ss.save(c["states"][0])
    for h in range(1, HEIGHTS + 1):
        bs.save_block(c["blocks"][h], c["parts"][h], c["commits"][h])
        ss.save(c["states"][h])
        ss.save_abci_responses(h, {"deliver_txs": [{"code": 0, "data": b""}] * len(c["blocks"][h].txs),
                                   "end_block": {"validator_updates": []}})
        ls.save_signed_header_and_validator_set(
            ns.SignedHeader(c["blocks"][h].header, c["commits"][h]), c["states"][h - 1].validators)
    for db in (block_db, state_db, light_db):
        db.close()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_sqlite_stores_cross_packages(writer, reader, tmp_path):
    home = str(tmp_path)
    _write_stores(PKGS[writer], home)
    ns, w = PKGS[reader], chain(PKGS[writer])
    c = chain(ns)
    block_db = ns.kvstore.open_db("blockstore", home)
    state_db = ns.kvstore.open_db("state", home)
    light_db = ns.kvstore.open_db("light", home)
    bs, ss, ls = ns.block_store.BlockStore(block_db), ns.state_store.StateStore(state_db), \
        ns.lite_store.DBStore(light_db)
    assert (bs.base(), bs.height(), bs.size()) == (1, HEIGHTS, HEIGHTS)
    for h in range(1, HEIGHTS + 1):
        blk = bs.load_block(h)
        assert blk.hash() == c["blocks"][h].hash() == w["blocks"][h].hash()
        assert blk.to_dict() == w["blocks"][h].to_dict()
        assert bs.load_block_by_hash(blk.hash()).hash() == blk.hash()
        assert bs.load_block_meta(h).block_id == c["ids"][h]
        assert bs.load_block_part(h, 0).to_dict() == w["parts"][h].parts[0].to_dict()
        assert bs.load_seen_commit(h).to_dict() == w["commits"][h].to_dict()
        if h < HEIGHTS:
            assert bs.load_block_commit(h).to_dict() == w["commits"][h].to_dict()
        assert ss.load_validators(h).to_dict() == c["states"][h - 1].validators.to_dict()
        assert ss.load_consensus_params(h).to_dict() == c["states"][h - 1].consensus_params.to_dict()
        assert ss.load_abci_responses(h)["end_block"] == {"validator_updates": []}
        assert ls.validator_set(h).to_dict() == c["states"][h - 1].validators.to_dict()
        assert ls.signed_header(h).hash() == c["blocks"][h].hash()
    assert bs.load_block_commit(HEIGHTS) is None
    assert ss.load_validators(HEIGHTS + 2).to_dict() == c["states"][HEIGHTS].next_validators.to_dict()
    assert ss.load().bytes() == c["states"][HEIGHTS].bytes()
    assert ls.heights() == list(range(HEIGHTS, 0, -1))
    assert (ls.latest_height(), ls.first_height()) == (HEIGHTS, 1)
    for db in (block_db, state_db, light_db):
        db.close()


def _damage_scenario(ns):
    """One run of seals, repair, quarantine, scan, restore and pruning on
    `ns`'s stores over memdb; returns everything observable."""
    c = chain(ns)
    db = ns.kvstore.MemDB()
    bs = ns.block_store.BlockStore(db)
    health = ns.watchdog.StorageHealth()
    bs.storage_health = health
    kicked = []
    bs.on_quarantine = kicked.append
    for h in range(1, HEIGHTS + 1):
        bs.save_block(c["blocks"][h], c["parts"][h], c["commits"][h])

    def flip(key):
        v = bytearray(db.get(key))
        v[-1] ^= 1
        db.set(key, bytes(v))

    out = {}
    flip(b"P:3:1")  # a part of block 3
    out["load 3"] = bs.load_block(3)
    flip(b"C:2")  # canonical commit of 2: repaired from the seen commit
    out["commit 2"] = bs.load_block_commit(2).to_dict()
    flip(b"C:4")
    flip(b"SC:4")  # both commits of 4: the carrier height 5 is quarantined
    out["commit 4"] = bs.load_block_commit(4)
    out["quarantined"] = bs.quarantined()
    out["meta 5"] = bs.load_block_meta(5)
    flip(b"H:6")  # rot the scan finds
    scan = bs.integrity_scan()
    scan.pop("ms")
    out["scan"] = scan
    out["expected 3"] = bs.quarantine_expected_hash(3)
    out["restore wrong"] = outcome(lambda: bs.restore_block(3, c["blocks"][2]))[0]
    bs.restore_block(3, c["blocks"][3])
    out["load 3 after"] = bs.load_block(3).hash()
    out["prune 0"] = outcome(lambda: bs.prune_blocks(0))
    out["prune past"] = outcome(lambda: bs.prune_blocks(HEIGHTS + 1))
    out["pruned"] = bs.prune_blocks(4)
    out["after prune"] = (bs.base(), bs.height(), bs.quarantined(), bs.load_block(3))
    out["kicked"] = kicked
    summary = health.summary()
    summary["last_error"].pop("mono")
    out["health"] = summary
    # a restart remembers the quarantine and the range
    again = ns.block_store.BlockStore(db)
    out["restart"] = (again.base(), again.height(), again.quarantined())
    flip(b"blockStore")
    out["state record"] = outcome(lambda: ns.block_store.BlockStore(db))
    return out


def test_seals_quarantine_scan_and_prune_match_jax():
    ours, theirs = _damage_scenario(PORT), _damage_scenario(JAX)
    assert ours["quarantined"] == [3, 5] and ours["scan"]["corrupt"] == [6]
    assert ours == theirs


def test_seal_unseal_and_prune_states_match_jax():
    for payload in (b"", b"x", bytes(range(256))):
        sealed = PORT.block_store.seal(payload)
        assert sealed == JAX.block_store.seal(payload)
        assert PORT.block_store.unseal(sealed) == (payload, False)
        bad = sealed[:-1] + bytes([sealed[-1] ^ 1]) if payload else sealed[:2] + b"\x00" * 4
        assert PORT.block_store.unseal(bad) == JAX.block_store.unseal(bad)
    assert PORT.block_store.unseal(b"legacy") == (b"legacy", False)

    def pruned(ns):
        c = chain(ns)
        ss = ns.state_store.StateStore(ns.kvstore.MemDB())
        for h in range(0, HEIGHTS + 1):
            ss.save(c["states"][h])
            ss.save_abci_responses(h, {"h": h})
        ss.prune_states(HEIGHTS)
        def params(h):
            p = ss.load_consensus_params(h)
            return p.to_dict() if p else None

        return [(outcome(lambda: ss.load_validators(h).hash() if ss.load_validators(h) else None),
                 ss.load_abci_responses(h), outcome(lambda: params(h)))
                for h in range(1, HEIGHTS + 3)]

    assert pruned(PORT) == pruned(JAX)


def test_storage_health_counters_match_jax(tmp_path):
    def drive(ns):
        sh = ns.watchdog.StorageHealth(str(tmp_path))
        sh.note_write_error("wal", OSError(28, "No space left on device"))
        sh.note_corruption("blockstore", "bad seal")
        sh.note_quarantine("blockstore", 7, "scan")
        sh.note_quarantine("blockstore", 8, "scan", total=5)
        sh.note_refill("blockstore", 7)
        sh.note_halt("consensus", "storage")
        sh.note_scan({"ms": 1.5, "quarantined": [8]})
        out = sh.summary()
        out["last_error"].pop("mono")
        out.pop("free_bytes")
        return out, sh.total_faults(), sh.free_bytes() is not None

    assert drive(PORT) == drive(JAX)


def test_reopened_block_store_serves_the_replay(tmp_path):
    """What phase 7 of chip_smoke.py reads: blocks, ids and sets at every
    height of a store reopened with new handles, the part sets rebuilt at
    the stored part size."""
    home = str(tmp_path)
    _write_stores(PORT, home)
    bs = PORT.block_store.BlockStore(PORT.kvstore.open_db("blockstore", home))
    ss = PORT.state_store.StateStore(PORT.kvstore.open_db("state", home))
    digests = set()
    for h in range(1, HEIGHTS + 1):
        blk = bs.load_block(h)
        bid = PORT.BlockID(blk.hash(), blk.make_part_set(PART).header())
        assert bid == bs.load_block_meta(h).block_id
        vals = ss.load_validators(h)
        digests.add(vals.pubkeys_digest())
        if h < HEIGHTS:
            vals.verify_commit(CHAIN, bid, h, bs.load_block(h + 1).last_commit)
    assert len(digests) == 2  # one set before the rotation, one after
