"""The port's block execution (tendermint_tpu_torch: state/validation.py,
state/execution.py, consensus/replay.py's Handshaker, evidence.py) against
the JAX package's, on the same chain.

`run_chain(ns)` drives one package's node pieces the way node.py wires
them: genesis of 7 validators at power 10, a KVStoreApplication behind
AppConns(local_client_creator(app)), a Handshaker that sends InitChain, a
Mempool with the signed-tx precheck (host path), an EvidencePool, an
EventBus with an IndexerService over a TxIndexer, and a BlockExecutor.  At
every height a few kv txs and signed envelopes (one with a corrupted
signature) go through check_tx; at height VAL_TX_AT, `val:` txs remove the
2 oldest validators and add 2 new ones (set B from VAL_TX_AT + 2); before
height EVIDENCE_AT a DuplicateVoteEvidence of validator 0 enters the pool.
Each block comes from create_proposal_block, is signed by its set, saved
with its part set and seen commit, and applied with apply_block.  ed25519
signing is deterministic, so both packages must produce the same bytes.
Tolerance: exact everywhere.
"""

import asyncio
import dataclasses
import os
import shutil
import types

import numpy as np
import pytest

import tendermint_tpu.abci.examples as jexamples
import tendermint_tpu.abci.types as jabci
import tendermint_tpu.consensus.replay as jreplay
import tendermint_tpu.evidence as jevidence_pool
import tendermint_tpu.libs.kvstore as jkvstore
import tendermint_tpu.mempool as jmempool
import tendermint_tpu.proxy as jproxy
import tendermint_tpu.state as jstate
import tendermint_tpu.state.execution as jexecution
import tendermint_tpu.state.txindex as jtxindex
import tendermint_tpu.state.validation as jvalidation
import tendermint_tpu.types as jtypes
import tendermint_tpu.types.events as jevents
import tendermint_tpu.types.evidence as jevidence
import tendermint_tpu.types.genesis as jgenesis
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu.store import BlockStore as JBlockStore
from tendermint_tpu_torch import evidence as pevidence_pool
from tendermint_tpu_torch import mempool as pmempool
from tendermint_tpu_torch import proxy as pproxy
from tendermint_tpu_torch import state as pstate
from tendermint_tpu_torch.abci import examples as pexamples
from tendermint_tpu_torch.abci import types as pabci
from tendermint_tpu_torch.consensus import replay as preplay
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.libs import kvstore as pkvstore
from tendermint_tpu_torch.state import execution as pexecution
from tendermint_tpu_torch.state import txindex as ptxindex
from tendermint_tpu_torch.state import validation as pvalidation
from tendermint_tpu_torch.store import BlockStore as PBlockStore
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import events as pevents
from tendermint_tpu_torch.types import evidence as pevidence
from tendermint_tpu_torch.types import genesis as pgenesis
from tendermint_tpu_torch.types import vote as pvote
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE

from test_torch_chain_types import outcome

CHAIN = "exec-parity"
SEC = 1_000_000_000
T0 = 1_700_000_000 * SEC
N_VALS, ROTATE, HEIGHTS = 7, 2, 6
VAL_TX_AT = 2  # val: txs delivered here; set B serves from VAL_TX_AT + 2
EVIDENCE_AT = 3  # the evidence (of height EVIDENCE_AT - 1) enters this block
KV_TXS, SIGNED_TXS = 3, 4
PART = 256

PORT = types.SimpleNamespace(
    name="port", PrivKey=Ed25519PrivKey, abci=pabci, examples=pexamples, proxy=pproxy,
    mempool=pmempool, evpool=pevidence_pool, execution=pexecution, validation=pvalidation,
    txindex=ptxindex, events=pevents, replay=preplay, state=pstate, kvstore=pkvstore,
    genesis=pgenesis, evidence=pevidence, BlockStore=PBlockStore, Block=pblock.Block,
    BlockID=pblock.BlockID, PartSetHeader=pblock.PartSetHeader, Commit=pblock.Commit,
    CommitSig=pblock.CommitSig, Vote=pvote.Vote,
)
JAX = types.SimpleNamespace(
    name="jax", PrivKey=JPrivKey, abci=jabci, examples=jexamples, proxy=jproxy,
    mempool=jmempool, evpool=jevidence_pool, execution=jexecution, validation=jvalidation,
    txindex=jtxindex, events=jevents, replay=jreplay, state=jstate, kvstore=jkvstore,
    genesis=jgenesis, evidence=jevidence, BlockStore=JBlockStore, Block=jtypes.Block,
    BlockID=jtypes.BlockID, PartSetHeader=jtypes.PartSetHeader, Commit=jtypes.Commit,
    CommitSig=jtypes.CommitSig, Vote=jtypes.Vote,
)
DBS = ("state", "blockstore", "app", "evidence", "txindex")


def sign_commit(ns, vset, key_of, height, bid, ts):
    sigs = [ns.CommitSig(2, v.address, ts + i, b"") for i, v in enumerate(vset.validators)]
    unsigned = ns.Commit(height, 0, bid, sigs)
    return ns.Commit(height, 0, bid, [
        ns.CommitSig(2, cs.validator_address, cs.timestamp_ns,
                     key_of[cs.validator_address].sign(unsigned.vote_sign_bytes(CHAIN, i)))
        for i, cs in enumerate(sigs)])


def chain_keys(ns):
    return [ns.PrivKey.from_secret(f"exec-{i}".encode()) for i in range(N_VALS + ROTATE)]


def genesis(ns, keys):
    gen = ns.genesis.GenesisDoc(CHAIN, genesis_time_ns=T0, validators=[
        ns.genesis.GenesisValidator(k.pub_key().address(), k.pub_key(), 10, f"v{i}")
        for i, k in enumerate(keys[:N_VALS])])
    gen.validate_and_complete()
    return gen


def duplicate_vote(ns, key, height):
    """Two signed precommits of `key` at `height` for different blocks."""
    addr = key.pub_key().address()
    votes = []
    for tag in (b"\x01", b"\x02"):
        bid = ns.BlockID(tag * 32, ns.PartSetHeader(1, tag * 32))
        vote = ns.Vote(PRECOMMIT_TYPE, height, 0, bid, T0 + height * SEC, addr, 0)
        vote.signature = key.sign(vote.sign_bytes(CHAIN))
        votes.append(vote)
    return ns.evidence.DuplicateVoteEvidence.from_votes(key.pub_key(), *votes)


def traffic(ns, keys, h, rng):
    """Height h's txs: kv txs, signed envelopes (the second one's signature
    corrupted) and, at VAL_TX_AT, the rotation's val: txs."""
    txs = [b"k%d-%d=" % (h, i) + rng.bytes(8).hex().encode() for i in range(KV_TXS)]
    for i in range(SIGNED_TXS):
        tx = ns.mempool.make_signed_tx(keys[i], b"s%d-%d=" % (h, i) + rng.bytes(8).hex().encode())
        if i == 1:
            off = len(ns.mempool.SIGNED_TX_PREFIX) + 32
            tx = tx[:off] + bytes([tx[off] ^ 1]) + tx[off + 1:]
        txs.append(tx)
    if h == VAL_TX_AT:
        import base64

        txs += [b"val:" + base64.b64encode(k.pub_key().bytes()) + b"!0" for k in keys[:ROTATE]]
        txs += [b"val:" + base64.b64encode(k.pub_key().bytes()) + b"!10" for k in keys[N_VALS:]]
    return txs


def dump(db):
    return list(db.iterate_prefix(b""))


def memdb(ns, items):
    db = ns.kvstore.MemDB()
    db.write_batch(items)
    return db


def drain(sub):
    out = []
    while not sub.queue.empty():
        msg = sub.queue.get_nowait()
        out.append(msg)
    return out


def event_view(msg):
    """What an event says, without the package's own classes."""
    ev = msg.data
    if ev.type == "NewBlock":
        b = ev.data["block"]
        return ("NewBlock", b.height, b.hash(), msg.events)
    d = ev.data
    return ("Tx", d["height"], d["index"], d["tx"], d["result"], msg.events)


async def run_chain(ns, heights=HEIGHTS, home=None, tip=False, snapshots=False):
    """One package's chain (see the module docstring).  With `home` the
    stores and the app live in sqlite files there; with `tip`, block
    heights + 1 is saved with its seen commit and not applied.  Returns
    per-height records (and, with `snapshots`, each store's items after each
    height, 0 = after the handshake)."""
    keys = chain_keys(ns)
    key_of = {k.pub_key().address(): k for k in keys}
    gen = genesis(ns, keys)
    dbs = {name: ns.kvstore.open_db(name, home) for name in DBS}
    state_store, block_store = ns.state.StateStore(dbs["state"]), ns.BlockStore(dbs["blockstore"])
    state = ns.state.make_genesis_state(gen)
    state_store.save(state)
    app = ns.examples.KVStoreApplication(db=dbs["app"])
    conns = ns.proxy.AppConns(ns.proxy.local_client_creator(app))
    bus = ns.events.EventBus()
    indexer = ns.txindex.TxIndexer(dbs["txindex"])
    svc = ns.txindex.IndexerService(indexer, bus)
    await conns.start()
    await bus.start()
    await svc.start()
    out = {"heights": {}, "snap": {}, "rejected": [], "index": indexer}
    try:
        sub_block = await bus.subscribe("test", ns.events.query_for_event("NewBlock"))
        sub_tx = await bus.subscribe("test", ns.events.query_for_event("Tx"))
        state = await ns.replay.Handshaker(state_store, state, block_store, gen).handshake(conns)
        mempool = ns.mempool.Mempool(conns.mempool(), {"sig_precheck": True})
        mempool.pre_check = ns.execution.tx_pre_check(state)
        evpool = ns.evpool.EvidencePool(dbs["evidence"], state_store, state)
        executor = ns.execution.BlockExecutor(state_store, conns.consensus(), mempool, evpool, bus)
        if snapshots:
            out["snap"][0] = {name: dump(db) for name, db in dbs.items()}
        rng = np.random.default_rng(11)
        last_commit = None
        for h in range(1, heights + 1 + bool(tip)):
            checks = []
            for tx in traffic(ns, keys, h, rng):
                checks.append(await _check(mempool, tx))
            if h == EVIDENCE_AT:
                evpool.add_evidence(duplicate_vote(ns, keys[0], h - 1))
            block = executor.create_proposal_block(h, state, last_commit,
                                                   state.validators.get_proposer().address)
            parts = block.make_part_set(PART)
            bid = ns.BlockID(block.hash(), parts.header())
            commit = sign_commit(ns, state.validators, key_of, h, bid, block.time_ns + SEC)
            block_store.save_block(block, parts, commit)
            if h > heights:
                break
            state, retain = await executor.apply_block(state, bid, block)
            await asyncio.sleep(0)  # the indexer drains its subscription
            await asyncio.sleep(0)
            byz = app.query(ns.abci.RequestQuery(data=b"__byzantine__"))
            out["heights"][h] = {
                "checks": checks,
                "block_txs": list(block.txs),
                "evidence": [ev.hash() for ev in block.evidence],
                "app_hash": app.app_hash,
                "state": state.to_dict(),
                "last_results_hash": state.last_results_hash,
                "responses": state_store.load_abci_responses(h),
                "events": [event_view(m) for m in drain(sub_block) + drain(sub_tx)],
                "byzantine": byz.value,
                "retain": retain,
                "mempool": mempool.size(),
                "pending_evidence": evpool.num_pending(),
            }
            if snapshots:
                out["snap"][h] = {name: dump(db) for name, db in dbs.items()}
            last_commit = commit
        out["state"] = state
        out["search"] = [
            sorted((r["index"], r["tx"]) for r in indexer.search(f"tx.height={h}"))
            for h in range(1, heights + 1)]
    finally:
        await svc.stop()
        await bus.stop()
        await conns.stop()
        for db in dbs.values():
            db.close()
    return out


async def _check(mempool, tx):
    try:
        res = await mempool.check_tx(tx)
        return ("ok", res.code, res.priority)
    except Exception as e:  # noqa: BLE001 - the parity is over any rejection
        return (type(e).__name__, str(e))


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


_chains = {}


def chain(ns):
    if ns.name not in _chains:
        _chains[ns.name] = run(run_chain(ns, snapshots=True))
    return _chains[ns.name]


# ---------------------------------------------------------------------------
# the 6-height chain through BlockExecutor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h", range(1, HEIGHTS + 1))
def test_chain_heights_match_jax(h):
    ours, theirs = chain(PORT)["heights"][h], chain(JAX)["heights"][h]
    for key in ours:
        assert ours[key] == theirs[key], key


def test_chain_exercises_rotation_evidence_and_rejections():
    c = chain(PORT)
    hs = c["heights"]
    # every corrupted envelope rejected, never in a block
    bad = [chk for h in hs for chk in hs[h]["checks"] if chk[0] != "ok"]
    assert bad == [("MempoolError", "invalid tx signature")] * HEIGHTS
    assert all(len(hs[h]["block_txs"]) == KV_TXS + SIGNED_TXS - 1
               + (2 * ROTATE if h == VAL_TX_AT else 0) for h in hs)
    # the rotation: set B from VAL_TX_AT + 2
    keys = chain_keys(PORT)
    vals = [{v["address"] for v in hs[h]["state"]["validators"]["validators"]} for h in hs]
    # vals[i] is the set of height i + 2 (the state after height i + 1)
    assert keys[0].pub_key().address() in vals[VAL_TX_AT - 1]
    assert keys[0].pub_key().address() not in vals[VAL_TX_AT]
    assert hs[VAL_TX_AT]["responses"]["end_block"]["validator_updates"]
    # the evidence: in block EVIDENCE_AT, reported to the app, committed
    assert [len(hs[h]["evidence"]) for h in hs] == [int(h == EVIDENCE_AT) for h in hs]
    assert hs[EVIDENCE_AT]["byzantine"] == keys[0].pub_key().address().hex().encode()
    assert hs[EVIDENCE_AT]["pending_evidence"] == 0
    # one NewBlock per height and one Tx event per delivered tx
    for h in hs:
        kinds = [e[0] for e in hs[h]["events"]]
        assert kinds.count("NewBlock") == 1 and kinds.count("Tx") == len(hs[h]["block_txs"])
    assert c["search"] == chain(JAX)["search"]
    assert [[tx for _, tx in s] for s in c["search"]] == [hs[h]["block_txs"] for h in hs]


# ---------------------------------------------------------------------------
# validate_block's errors
# ---------------------------------------------------------------------------


def _bad_blocks(ns):
    """(name, state, block) cases: each header field, a bad LastCommit and
    bad evidence, built from the chain's block 5 and the state after 4."""
    c = chain(ns)
    state = ns.state.State.from_dict(c["heights"][4]["state"])
    good = ns.BlockStore(memdb(ns, c["snap"][5]["blockstore"])).load_block(5)
    keys = chain_keys(ns)
    cases = [("good", state, good)]

    def with_header(name, **kw):
        b = ns.Block(dataclasses.replace(good.header, **kw), good.txs, good.evidence,
                     good.last_commit)
        cases.append((name, state, b))

    def rebuilt(name, commit, evidence, st=state, base=good):
        header = dataclasses.replace(base.header, last_commit_hash=b"", evidence_hash=b"")
        b = ns.Block(header, base.txs, evidence, commit)
        b.fill_header()
        cases.append((name, st, b))

    with_header("version", version_block=good.header.version_block + 1)
    with_header("chain_id", chain_id="other-chain")
    with_header("height", height=7)
    with_header("last_block_id", last_block_id=ns.BlockID(b"\x07" * 32,
                                                          ns.PartSetHeader(1, b"\x07" * 32)))
    with_header("app_hash", app_hash=b"\x01" * 32)
    with_header("consensus_hash", consensus_hash=b"\x02" * 32)
    with_header("last_results_hash", last_results_hash=b"\x03" * 32)
    with_header("validators_hash", validators_hash=b"\x04" * 32)
    with_header("next_validators_hash", next_validators_hash=b"\x05" * 32)
    with_header("time", time_ns=good.header.time_ns + 1)
    with_header("proposer", proposer_address=keys[N_VALS - 1].pub_key().address()[:19] + b"\x00")
    with_header("data_hash", data_hash=b"\x06" * 32)
    # LastCommit: one flipped signature, and one signature short
    lc = good.last_commit
    sigs = list(lc.signatures)
    flipped = bytearray(sigs[2].signature)
    flipped[5] ^= 1
    sigs[2] = dataclasses.replace(sigs[2], signature=bytes(flipped))
    rebuilt("commit_sig", ns.Commit(lc.height, lc.round, lc.block_id, sigs), [])
    rebuilt("commit_size", ns.Commit(lc.height, lc.round, lc.block_id, list(lc.signatures)[:-1]),
            [])
    # evidence: of a key that was never a validator, of a height with no
    # stored set, and evidence the pool has already committed (block 3's)
    stranger = ns.PrivKey.from_secret(b"stranger")
    rebuilt("evidence_stranger", lc, [duplicate_vote(ns, stranger, 3)])
    rebuilt("evidence_unknown_height", lc, [duplicate_vote(ns, keys[2], 40)])
    rebuilt("evidence_committed", lc, [duplicate_vote(ns, keys[0], EVIDENCE_AT - 1)])
    # height 1 carrying LastCommit signatures
    b1 = ns.BlockStore(memdb(ns, c["snap"][1]["blockstore"])).load_block(1)
    genesis_state = ns.state.make_genesis_state(genesis(ns, keys))
    rebuilt("height1_last_commit", lc, [], st=genesis_state, base=b1)
    return cases


def _validate_all(ns):
    c = chain(ns)
    store = ns.state.StateStore(memdb(ns, c["snap"][4]["state"]))
    pool = ns.evpool.EvidencePool(memdb(ns, c["snap"][4]["evidence"]), store)
    return [(n, outcome(lambda: ns.validation.validate_block(s, b, store, pool)))
            for n, s, b in _bad_blocks(ns)]


def test_validate_block_errors_match_jax():
    ours, theirs = _validate_all(PORT), _validate_all(JAX)
    assert ours == theirs
    assert ours[0] == ("good", ("ok", None))
    # every other case raises InvalidBlockError, each with its own message
    assert all(r[0] == "InvalidBlockError" for _, r in ours[1:]), ours
    assert len({r[1] for _, r in ours[1:]}) == len(ours) - 1, ours


def test_verify_evidence_against_stored_sets_matches_jax():
    def cases(ns):
        c = chain(ns)
        state = ns.state.State.from_dict(c["heights"][5]["state"])
        store = ns.state.StateStore(memdb(ns, c["snap"][5]["state"]))
        keys = chain_keys(ns)
        evs = [duplicate_vote(ns, keys[0], 2), duplicate_vote(ns, keys[0], 5),
               duplicate_vote(ns, keys[N_VALS], 5), duplicate_vote(ns, keys[3], 40)]
        res = [outcome(lambda ev=ev: ns.validation.verify_evidence(state, ev, store)) for ev in evs]
        res.append(outcome(lambda: ns.validation.verify_evidence(state, evs[0], None)))
        return res

    ours, theirs = cases(PORT), cases(JAX)
    assert ours == theirs
    assert ours[0] == ("ok", None) and ours[2] == ("ok", None)
    assert ours[1][0] == "ValueError" and "was not a validator" in ours[1][1]


def test_exec_helpers_match_jax():
    def helpers(ns):
        a = ns.abci
        updates = [a.ValidatorUpdate("ed25519", b"\x11" * 32, 5),
                   a.ValidatorUpdate("ed25519", b"\x12" * 32, 0)]
        params = ns.state.make_genesis_state(genesis(ns, chain_keys(ns))).consensus_params
        return [
            [(v.address, v.voting_power) for v in ns.execution.validator_updates_from_abci(updates)],
            outcome(lambda: ns.execution.validator_updates_from_abci(
                [a.ValidatorUpdate("secp256k1", b"\x13" * 33, 1)])),
            outcome(lambda: ns.execution.validate_validator_updates(
                [a.ValidatorUpdate("ed25519", b"\x11" * 32, -1)], params.validator)),
            outcome(lambda: ns.execution.validate_validator_updates(
                [a.ValidatorUpdate("sr25519", b"\x11" * 32, 3)], params.validator)),
            outcome(lambda: ns.execution.max_data_bytes(22020096, 10_000, 3)),
            outcome(lambda: ns.execution.max_data_bytes(1000, 10, 0)),
            ns.execution.abci_results_hash([a.ResponseDeliverTx(code=0, data=b"x"),
                                            a.ResponseDeliverTx(code=3, log="no")]),
            [ns.execution.tx_pre_check(ns.state.make_genesis_state(genesis(ns, chain_keys(ns))))(tx)
             for tx in (b"a", b"b" * 30_000_000)],
        ]

    assert helpers(PORT) == helpers(JAX)

    # bls12381 updates: admitted with a valid proof of possession, refused
    # without one or with another key's, removals unchecked — as in JAX
    from tendermint_tpu.crypto.bls.keys import BlsPrivKey

    bls, other = BlsPrivKey.from_secret(b"upd-bls"), BlsPrivKey.from_secret(b"upd-other")
    pub = bls.pub_key().bytes()

    def bls_updates(ns):
        a = ns.abci
        out = []
        for vu in (a.ValidatorUpdate("bls12381", pub, 10, pop=bls.pop()),
                   a.ValidatorUpdate("bls12381", pub, 0),
                   a.ValidatorUpdate("bls12381", pub, 10),
                   a.ValidatorUpdate("bls12381", pub, 10, pop=other.pop()),
                   a.ValidatorUpdate("bls12381", b"\x01" * 48, 10, pop=b"\x02" * 96)):
            res = outcome(lambda vu=vu: ns.execution.validator_updates_from_abci([vu]))
            if res[0] == "ok":
                res = [(v.address, v.pub_key.to_dict(), v.voting_power)
                       for v in ns.execution.validator_updates_from_abci([vu])]
            out.append(res)
        return out

    ours = bls_updates(PORT)
    assert ours == bls_updates(JAX)
    assert ours[0][0][0] == bls.pub_key().address() and ours[2][0] == "ValueError"


def test_provisional_next_state_matches_jax():
    def provisional(ns):
        c = chain(ns)
        state = ns.state.State.from_dict(c["heights"][3]["state"])
        block = ns.BlockStore(memdb(ns, c["snap"][4]["blockstore"])).load_block(4)
        bid = ns.BlockID(block.hash(), block.make_part_set(PART).header())
        return ns.execution.provisional_next_state(state, bid, block).to_dict()

    assert provisional(PORT) == provisional(JAX)


# ---------------------------------------------------------------------------
# the Handshaker: every replay_blocks branch
# ---------------------------------------------------------------------------

# (store height, state height, app height): how a node can find itself at start
BRANCHES = {
    "genesis": (0, 0, 0),             # InitChain, nothing stored
    "synced": (4, 4, 4),              # nothing to replay
    "app_behind": (4, 4, 2),          # exec-commit 3..4
    "app_fresh": (4, 4, 0),           # InitChain, then exec-commit 1..4
    "apply_last": (5, 4, 4),          # ApplyBlock 5
    "replay_then_apply": (5, 4, 2),   # exec-commit 3..4, ApplyBlock 5
    "stored_responses": (5, 4, 5),    # the app has 5: replay its saved responses
    "app_ahead": (3, 3, 5),           # error
    "state_ahead": (3, 4, 3),         # error
    "store_far_ahead": (5, 3, 3),     # error
}


async def _handshake(ns, store_h, state_h, app_h):
    c = chain(ns)
    snap = c["snap"]
    state_db = memdb(ns, snap[state_h]["state"])
    state_store = ns.state.StateStore(state_db)
    if store_h == state_h + 1 and app_h == store_h:
        # crashed after the app committed and the responses were saved
        later = ns.state.StateStore(memdb(ns, snap[store_h]["state"]))
        state_store.save_abci_responses(store_h, later.load_abci_responses(store_h))
    block_store = ns.BlockStore(memdb(ns, snap[store_h]["blockstore"]))
    app = ns.examples.KVStoreApplication(db=memdb(ns, snap[app_h]["app"]))
    conns = ns.proxy.AppConns(ns.proxy.local_client_creator(app))
    await conns.start()
    try:
        gen = genesis(ns, chain_keys(ns))
        state = state_store.load_from_db_or_genesis(gen)
        hs = ns.replay.Handshaker(state_store, state, block_store, gen)
        try:
            state = await hs.handshake(conns)
        except Exception as e:  # noqa: BLE001 - the parity is over the error
            return (type(e).__name__, str(e))
        return ("ok", hs.n_blocks, state.to_dict(), app.app_hash, app.height,
                state_store.load().to_dict())
    finally:
        await conns.stop()


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_handshake_branches_match_jax(branch):
    store_h, state_h, app_h = BRANCHES[branch]
    chain(PORT), chain(JAX)
    ours = run(_handshake(PORT, store_h, state_h, app_h))
    theirs = run(_handshake(JAX, store_h, state_h, app_h))
    assert ours == theirs
    if branch in ("app_ahead", "state_ahead", "store_far_ahead"):
        assert ours[0] == "RuntimeError"
        return
    assert ours[0] == "ok"
    _, n_blocks, state, app_hash, app_height, saved = ours
    replayed = {"genesis": 0, "synced": 0, "app_behind": 2, "app_fresh": 4, "apply_last": 1,
                "replay_then_apply": 3, "stored_responses": 1}[branch]
    assert n_blocks == replayed
    want = chain(PORT)["heights"].get(store_h)
    if want is not None:
        # wherever the node lands, it is the producer's state at that height
        assert state == want["state"] and app_hash == want["app_hash"] and app_height == store_h


# ---------------------------------------------------------------------------
# state carried across: one package writes, the other resumes
# ---------------------------------------------------------------------------


async def _resume(ns, home):
    """Open the stores and the app in `home`, handshake twice: the first
    applies the saved tip block (store one ahead of the state and the app),
    the second finds everything in step."""
    results = []
    for _ in range(2):
        dbs = {name: ns.kvstore.open_db(name, home) for name in ("state", "blockstore", "app")}
        app = ns.examples.KVStoreApplication(db=dbs["app"])
        conns = ns.proxy.AppConns(ns.proxy.local_client_creator(app))
        await conns.start()
        try:
            state_store = ns.state.StateStore(dbs["state"])
            block_store = ns.BlockStore(dbs["blockstore"])
            gen = genesis(ns, chain_keys(ns))
            hs = ns.replay.Handshaker(state_store, state_store.load_from_db_or_genesis(gen),
                                      block_store, gen)
            state = await hs.handshake(conns)
            results.append((hs.n_blocks, block_store.height(), state.to_dict(), app.app_hash,
                            state_store.load_abci_responses(state.last_block_height)))
        finally:
            await conns.stop()
            for db in dbs.values():
                db.close()
    return results


@pytest.mark.parametrize("writer", ["jax", "port"])
async def test_chain_written_by_one_package_resumes_in_the_other(writer, tmp_path):
    src, dst = (JAX, PORT) if writer == "jax" else (PORT, JAX)
    home = str(tmp_path / "a")
    written = await run_chain(src, home=home, tip=True)
    assert written["state"].last_block_height == HEIGHTS
    shutil.copytree(home, str(tmp_path / "b"))
    theirs = await _resume(src, str(tmp_path / "b"))
    ours = await _resume(dst, home)
    assert ours == theirs
    (n1, store1, state1, hash1, _), (n2, store2, state2, hash2, _) = ours
    assert (n1, n2, store1, store2) == (1, 0, HEIGHTS + 1, HEIGHTS + 1)
    assert state1 == state2 and hash1 == hash2
    assert state1["last_block_height"] == HEIGHTS + 1 and state1["app_hash"] == hash1
    assert os.path.exists(os.path.join(home, "data", "state.db"))


# ---------------------------------------------------------------------------
# chip_smoke.py phase 7's chain: its states now come from update_state
# ---------------------------------------------------------------------------


def _next_state_without_app(state, block_id, block, changes=None):
    """Phase 7's former private copy of update_state (no app: code-0
    results, no param updates), the reference for the chain's bytes."""
    from tendermint_tpu_torch.types.tx import ABCIResult, results_hash

    nxt = state.next_validators.copy()
    changed = state.last_height_validators_changed
    if changes:
        nxt.update_with_change_set(changes)
        changed = block.height + 2
    nxt.increment_proposer_priority(1)
    return dataclasses.replace(
        state, last_block_height=block.height, last_block_id=block_id,
        last_block_time_ns=block.time_ns, next_validators=nxt,
        validators=state.next_validators.copy(), last_validators=state.validators.copy(),
        last_height_validators_changed=changed,
        last_results_hash=results_hash([ABCIResult(0, b"") for _ in block.txs]), app_hash=b"")


def test_phase7_chain_is_byte_equal_on_update_state(monkeypatch, tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "REPLAY_ROTATE", 2)
    monkeypatch.setattr(cs, "REPLAY_TXS", 5)
    keys, new_keys = cs.make_keys(7), cs.make_keys(2, prefix="replay")

    def build(home):
        blocks, _, _ = cs.build_replay_chain(keys, new_keys, str(home))
        store = PORT.state.StateStore(PORT.kvstore.open_db("state", str(home)))
        try:
            return ([blocks[h].serialize() for h in sorted(blocks)],
                    store.load().bytes(), [store.load_validators(h).hash()
                                           for h in range(1, cs.REPLAY_TOP + 2)])
        finally:
            store.db.close()

    ours = build(tmp_path / "update_state")
    monkeypatch.setattr(cs, "next_state", _next_state_without_app)
    theirs = build(tmp_path / "reference")
    assert ours == theirs
    assert len(set(ours[2])) == 2  # the rotation: two sets
