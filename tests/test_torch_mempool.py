"""The port's mempool and evidence pool (tendermint_tpu_torch/mempool.py,
evidence.py) against the JAX package's.

The same seeded check_tx / reap / update sequences give the same outcomes,
pool contents, priorities, evictions, rechecks and versions.  The
signed-tx lane runs on the port's AsyncBatchVerifier (device="cpu", the
ladder's plain version) against the JAX package's host path: the same
verdicts.  Where the engine itself fails, the port raises and the JAX
package reads the failure as "invalid tx signature" (a deliberate
deviation).  Every service started here is stopped.
"""

import asyncio
import dataclasses
import types

import pytest
import torch

import tendermint_tpu.abci.examples as jexamples
import tendermint_tpu.crypto.batch_verifier as jbvm
import tendermint_tpu.libs.tracing as jtracing
import tendermint_tpu.evidence as jevpool
import tendermint_tpu.libs.kvstore as jkvstore
import tendermint_tpu.mempool as jmempool
import tendermint_tpu.proxy as jproxy
import tendermint_tpu.state as jstate
import tendermint_tpu.types as jtypes
import tendermint_tpu.types.evidence as jevidence
import tendermint_tpu.types.genesis as jgenesis
from tendermint_tpu.crypto.keys import Ed25519PrivKey as JPrivKey
from tendermint_tpu_torch import evidence as pevpool
from tendermint_tpu_torch import mempool as pmempool
from tendermint_tpu_torch import proxy as pproxy
from tendermint_tpu_torch import state as pstate
from tendermint_tpu_torch.abci import examples as pexamples
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.libs import kvstore as pkvstore
from tendermint_tpu_torch.libs.tracing import FlightRecorder
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import evidence as pevidence
from tendermint_tpu_torch.types import genesis as pgenesis
from tendermint_tpu_torch.types import vote as pvote
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE

torch.set_num_threads(1)

PORT = types.SimpleNamespace(
    mempool=pmempool, examples=pexamples, proxy=pproxy, kvstore=pkvstore, evpool=pevpool,
    state=pstate, genesis=pgenesis, evidence=pevidence, PrivKey=Ed25519PrivKey,
    BlockID=pblock.BlockID, PartSetHeader=pblock.PartSetHeader, Vote=pvote.Vote)
JAX = types.SimpleNamespace(
    mempool=jmempool, examples=jexamples, proxy=jproxy, kvstore=jkvstore, evpool=jevpool,
    state=jstate, genesis=jgenesis, evidence=jevidence, PrivKey=JPrivKey,
    BlockID=jtypes.BlockID, PartSetHeader=jtypes.PartSetHeader, Vote=jtypes.Vote)
SEC = 1_000_000_000
T0 = 1_700_000_000 * SEC
CHAIN = "mempool-parity"


async def _try(coro):
    try:
        res = await coro
        return ("ok", res.code, res.log, res.priority)
    except Exception as e:  # noqa: BLE001 - the parity is over any rejection
        return (type(e).__name__, str(e))


def pool_view(mp):
    return (mp.size(), mp.txs_bytes, mp.version, mp.height,
            [(m.tx, m.priority, m.seq, m.height, m.gas_wanted, sorted(m.senders))
             for m in mp.txs.values()])


async def _priority_trace(ns):
    """Admission, dedup, pre-check, eviction, reaps and a commit update on
    the kvstore app (fee:<n>: payloads set priorities)."""
    conns = ns.proxy.AppConns(ns.proxy.default_client_creator("kvstore"))
    await conns.start()
    trace = []
    try:
        mp = ns.mempool.Mempool(conns.mempool(), {"size": 5, "max_txs_bytes": 60,
                                                  "max_tx_bytes": 20, "cache_size": 8})
        mp.enable_txs_available()
        mp.pre_check = lambda tx: "contains bad" if b"bad" in tx else None
        check = [b"val:!!x", b"fee:5:a", b"plain1", b"fee:1:b", b"fee:9:c", b"plain2",
                 b"plain3", b"fee:3:d", b"fee:5:a", b"x" * 21, b"bad-tx", b"bad-tx",
                 b"fee:2:eeeeeeeeee", b"fee:99:f"]
        for i, tx in enumerate(check):
            trace.append((tx, await _try(mp.check_tx(tx, sender=f"peer{i % 2}"))))
            trace.append(pool_view(mp))
        trace.append(("available", mp.txs_available().is_set(), mp.notified_txs_available))
        for max_bytes, max_gas in ((-1, -1), (30, -1), (-1, 2), (0, -1)):
            trace.append(("reap", max_bytes, max_gas, mp.reap_max_bytes_max_gas(max_bytes, max_gas)))
        trace.append(("reap_max_txs", mp.reap_max_txs(2), mp.reap_max_txs(-1)))
        trace.append(("after", [m.tx for m in await mp.next_txs_after(2)]))
        committed = mp.reap_max_bytes_max_gas(-1, 2)
        responses = [ns.examples.t.ResponseDeliverTx(code=i % 2) for i in range(len(committed))]
        async with mp.lock():
            await mp.flush_app_conn()
            await mp.update(1, committed, responses, lambda tx: None, None)
        trace.append(("updated", committed, pool_view(mp), mp.txs_available().is_set()))
        for tx in committed:  # a committed ok tx stays cached; a failed one may come back
            trace.append((tx, await _try(mp.check_tx(tx))))
        trace.append(pool_view(mp))
        await mp.flush()
        trace.append(("flushed", pool_view(mp), mp.cache.contains(b"fee:9:c")))
    finally:
        await conns.stop()
    return trace


async def test_priority_admission_eviction_and_reap_match_jax():
    ours, theirs = await _priority_trace(PORT), await _priority_trace(JAX)
    assert ours == theirs
    outcomes = dict(ours[:28:2])  # the first submission of each tx
    assert outcomes[b"plain3"][0] == "MempoolFullError"
    assert outcomes[b"x" * 21] == ("MempoolError", "tx too large: 21 > 20")
    assert outcomes[b"bad-tx"] == ("MempoolError", "pre-check failed: contains bad")
    assert outcomes[b"val:!!x"][:3] == ("ok", 1, "invalid validator tx")
    # a full pool evicts its lowest-priority, newest tx for a better one
    assert outcomes[b"fee:3:d"][0] == "ok" and outcomes[b"fee:99:f"][0] == "ok"


async def _recheck_trace(ns):
    """The counter app (serial nonces): after a commit, the recheck drops
    the pool's txs whose nonce went stale."""
    conns = ns.proxy.AppConns(ns.proxy.default_client_creator("counter_serial"))
    await conns.start()
    trace = []
    try:
        mp = ns.mempool.Mempool(conns.mempool())
        for tx in (b"\x00", b"\x01", b"\x02", b"\x00\x02", b"\x03", b"\x04", b"\x01"):
            trace.append((tx, await _try(mp.check_tx(tx))))
        block = [b"\x00", b"\x01", b"\x02"]
        c = conns.consensus()
        responses = [await c.deliver_tx(ns.examples.t.RequestDeliverTx(tx=tx)) for tx in block]
        async with mp.lock():
            await c.commit()
            await mp.update(1, block, responses)
        trace.append(pool_view(mp))
        mp.recheck = False
        async with mp.lock():
            await mp.update(2, [b"\x03"], [responses[0]])
        trace.append(pool_view(mp))
    finally:
        await conns.stop()
    return trace


async def test_recheck_drops_stale_txs_as_jax():
    ours, theirs = await _recheck_trace(PORT), await _recheck_trace(JAX)
    assert ours == theirs
    after = ours[-2]
    assert [t[0] for t in after[4]] == [b"\x03", b"\x04"]  # the stale b"\x00\x02" went


def _lane_txs(ns):
    """Envelopes: 6 valid, 2 with a flipped signature byte, one truncated
    after the prefix, and a plain tx."""
    keys = [ns.PrivKey.from_secret(b"lane-%d" % i) for i in range(4)]
    txs = [ns.mempool.make_signed_tx(keys[i % 4], b"pay-%d=%d" % (i, i * 7)) for i in range(8)]
    off = len(ns.mempool.SIGNED_TX_PREFIX) + 32
    for i in (2, 5):
        txs[i] = txs[i][:off] + bytes([txs[i][off] ^ 1]) + txs[i][off + 1:]
    txs.append(ns.mempool.SIGNED_TX_PREFIX + b"short")
    txs.append(b"plain=tx")
    return txs


async def _lane_trace(ns, sig_verifier=None):
    conns = ns.proxy.AppConns(ns.proxy.default_client_creator("kvstore"))
    await conns.start()
    try:
        mp = ns.mempool.Mempool(conns.mempool(), {"sig_precheck": True})
        mp.sig_verifier = sig_verifier
        txs = _lane_txs(ns)
        first = await asyncio.gather(*(_try(mp.check_tx(tx)) for tx in txs))
        again = [await _try(mp.check_tx(tx)) for tx in txs]  # every resubmission is cached
        return first, again, pool_view(mp)
    finally:
        await conns.stop()


async def test_signed_tx_lane_on_the_engine_matches_jax_host_path():
    """The port's lane on its engine (the ladder's plain version) against the
    JAX package's lane on its host path: the same verdicts, the same pool in
    the same order (the plain tx is admitted while the envelopes await their
    flush), one flush of the 8 well-formed envelopes."""
    rec, jrec = FlightRecorder(size=1 << 10), jtracing.FlightRecorder(size=1 << 10)
    lane = bvm.AsyncBatchVerifier(bvm.BatchVerifier(device="cpu", recorder=rec))
    jlane = jbvm.AsyncBatchVerifier(jbvm.BatchVerifier(min_device_batch=1 << 20, recorder=jrec))
    await lane.start()
    await jlane.start()
    try:
        ours = await _lane_trace(PORT, lane)
        theirs = await _lane_trace(JAX, jlane)
    finally:
        await lane.stop()
        await jlane.stop()
    assert ours == theirs
    # without a verifier both verify each envelope inline on the host
    host, jhost = await _lane_trace(PORT), await _lane_trace(JAX)
    assert host == jhost
    assert host[:2] == ours[:2] and sorted(host[2][4]) != [] and \
        sorted(t[0] for t in host[2][4]) == sorted(t[0] for t in ours[2][4])
    first, again, _ = ours
    assert [r[0] for r in first] == ["ok", "ok", "MempoolError", "ok", "ok", "MempoolError",
                                     "ok", "ok", "MempoolError", "ok"]
    assert first[2] == ("MempoolError", "invalid tx signature")
    assert first[8] == ("MempoolError", "malformed signed-tx envelope")
    # resubmissions are free: cached, or (malformed) rejected before the cache
    assert again == [("TxInCacheError", "tx already exists in cache")] * 8 + [first[8]] + \
        [("TxInCacheError", "tx already exists in cache")]
    assert [e["batch"] for e in rec.events(kinds=["verify.flush"])] == \
        [e["batch"] for e in jrec.events(kinds=["verify.flush"])] == [8]


def test_envelope_helpers_match_jax():
    for ns_tx in (_lane_txs(PORT), _lane_txs(JAX)):
        assert ns_tx == _lane_txs(PORT)
    samples = _lane_txs(PORT) + [b"fee:12:x", b"fee:x:y", b"fee:" + b"9" * 20 + b":z", b"fee::",
                                 PORT.mempool.make_signed_tx(Ed25519PrivKey.from_secret(b"f"),
                                                             b"fee:77:inside")]
    for tx in samples:
        assert PORT.mempool.parse_signed_tx(tx) == JAX.mempool.parse_signed_tx(tx)
        assert PORT.mempool.tx_payload(tx) == JAX.mempool.tx_payload(tx)
        assert PORT.mempool.tx_priority(tx) == JAX.mempool.tx_priority(tx)
    assert [PORT.mempool.tx_priority(t) for t in samples[-5:]] == [12, 0, 0, 0, 77]


def test_tx_cache_matches_jax():
    def trace(ns):
        cache = ns.mempool.TxCache(3)
        out = [cache.push(tx) for tx in (b"a", b"b", b"a", b"c", b"d", b"b", b"a")]
        out += [cache.contains(tx) for tx in (b"a", b"b", b"c", b"d")]
        cache.remove(b"d")
        out += [cache.contains(b"d"), cache.push(b"d")]
        cache.reset()
        return out + [cache.contains(b"a")]

    assert trace(PORT) == trace(JAX)


class _FailingEngine:
    """verify_one that raises, as an engine whose kernel failed would."""

    def verify_one(self, pubkey, msg, sig):
        raise RuntimeError("kernel launch failed")


async def test_an_engine_error_propagates_where_jax_reads_invalid_signature():
    tx = _lane_txs(PORT)[0]
    # the port's engine failing inside a flush: the batch's futures carry it
    lane = bvm.AsyncBatchVerifier(bvm.BatchVerifier(device="cpu"))
    lane.verifier.verify = _FailingEngine().verify_one
    await lane.start()
    conns = pproxy.AppConns(pproxy.default_client_creator("kvstore"))
    await conns.start()
    try:
        mp = pmempool.Mempool(conns.mempool(), {"sig_precheck": True})
        mp.sig_verifier = lane
        for _ in range(2):  # not cached: the resubmission reaches the engine again
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                await mp.check_tx(tx)
            assert not mp.cache.contains(tx) and mp.size() == 0
        mp.sig_verifier = _FailingEngine()
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            await mp.check_tx(tx)
    finally:
        await conns.stop()
        await lane.stop()
    # the JAX package reads the same failure as a bad signature
    jconns = jproxy.AppConns(jproxy.default_client_creator("kvstore"))
    await jconns.start()
    try:
        jmp = jmempool.Mempool(jconns.mempool(), {"sig_precheck": True})
        jmp.sig_verifier = _FailingEngine()
        with pytest.raises(jmempool.MempoolError, match="invalid tx signature"):
            await jmp.check_tx(_lane_txs(JAX)[0])
    finally:
        await jconns.stop()


async def test_nop_mempool_and_deferred_wal(tmp_path):
    async def trace(ns):
        nop = ns.mempool.NopMempool()
        async with nop.lock():
            await nop.flush_app_conn()
            await nop.update(1, [b"x"], [])
        try:
            await nop.check_tx(b"x")
        except ns.mempool.MempoolError as e:
            err = str(e)
        nop.enable_txs_available()
        return (err, nop.reap_max_bytes_max_gas(-1, -1), nop.reap_max_txs(3), nop.size(),
                nop.txs_available())

    assert await trace(PORT) == await trace(JAX)

    async def journal(ns, name):
        """The tx journal, no longer deferred: the accepted txs replay from
        the same file bytes in both packages."""
        conns = ns.proxy.AppConns(ns.proxy.default_client_creator("kvstore"))
        await conns.start()
        try:
            mp = ns.mempool.Mempool(conns.mempool())
            mp.init_wal(str(tmp_path / name))
            for tx in (b"a=1", b"b=2", b"a=1"):
                await _try(mp.check_tx(tx))
            replay = mp.wal_txs()
            mp.close_wal()
            return replay, (tmp_path / name / "wal").read_bytes()
        finally:
            await conns.stop()

    ours = await journal(PORT, "port")
    assert ours == await journal(JAX, "jax")
    assert ours[0] == [b"a=1", b"b=2"]


# ---------------------------------------------------------------------------
# the evidence pool
# ---------------------------------------------------------------------------


def _duplicate_vote(ns, key, height, ts=None):
    addr = key.pub_key().address()
    votes = []
    for tag in (b"\x01", b"\x02"):
        bid = ns.BlockID(tag * 32, ns.PartSetHeader(1, tag * 32))
        vote = ns.Vote(PRECOMMIT_TYPE, height, 0, bid, ts or T0 + height * SEC, addr, 0)
        vote.signature = key.sign(vote.sign_bytes(CHAIN))
        votes.append(vote)
    return ns.evidence.DuplicateVoteEvidence.from_votes(key.pub_key(), *votes)


def _evidence_trace(ns):
    keys = [ns.PrivKey.from_secret(b"ev-%d" % i) for i in range(4)]
    gen = ns.genesis.GenesisDoc(CHAIN, genesis_time_ns=T0, validators=[
        ns.genesis.GenesisValidator(k.pub_key().address(), k.pub_key(), 10, f"v{i}")
        for i, k in enumerate(keys)])
    state = ns.state.make_genesis_state(gen)
    store = ns.state.StateStore(ns.kvstore.MemDB())
    store.save(state)
    state = dataclasses.replace(state, last_block_height=1, last_block_time_ns=T0 + SEC)
    db = ns.kvstore.MemDB()
    pool = ns.evpool.EvidencePool(db, store, state)
    seen = []
    pool.on_evidence.append(lambda ev: seen.append(ev.hash()))
    evs = [_duplicate_vote(ns, keys[i], 1) for i in range(3)]
    trace = []
    for ev in evs + [evs[0]]:
        pool.add_evidence(ev)
        trace.append((pool.num_pending(), pool.is_pending(ev), pool.is_committed(ev)))
    stranger = _duplicate_vote(ns, ns.PrivKey.from_secret(b"stranger"), 1)
    try:
        pool.add_evidence(stranger)
    except ValueError as e:
        trace.append(("stranger", str(e)))
    trace.append([ev.hash() for ev in pool.pending_evidence()])
    trace.append([ev.hash() for ev in pool.pending_evidence(2)])
    pool.update(types.SimpleNamespace(evidence=[evs[1]]), state)
    trace.append((pool.num_pending(), pool.is_pending(evs[1]), pool.is_committed(evs[1])))
    pool.mark_committed(evs[1])  # again: no double count
    trace.append(pool.num_pending())
    # far later, in blocks and in time: the pending evidence expires
    params = state.consensus_params.evidence
    later = dataclasses.replace(state, last_block_height=2 + params.max_age_num_blocks,
                                last_block_time_ns=T0 + params.max_age_duration_ns + 9 * SEC)
    pool.update(types.SimpleNamespace(evidence=[]), later)
    trace.append((pool.num_pending(), [ev.hash() for ev in pool.pending_evidence()]))
    reopened = ns.evpool.EvidencePool(db, store, later)
    trace.append((reopened.num_pending(), reopened.is_committed(evs[1]), seen))
    nop = ns.evpool.NopEvidencePool()
    nop.add_evidence(evs[0])
    nop.update(None, state)
    trace.append((nop.pending_evidence(), nop.is_committed(evs[0]), nop.is_pending(evs[0])))
    return trace


def test_evidence_pool_matches_jax():
    ours, theirs = _evidence_trace(PORT), _evidence_trace(JAX)
    assert ours == theirs
    assert ours[:4] == [(1, True, False), (2, True, False), (3, True, False), (3, True, False)]
    assert ours[4][0] == "stranger" and "was not a validator" in ours[4][1]
    assert ours[7] == (2, False, True) and ours[8] == 2
    assert ours[9] == (0, [])
