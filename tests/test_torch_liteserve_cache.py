"""The port's shared verification cache (tendermint_tpu_torch/liteserve/
cache.py VerifyCache) and statesync's engine lane
(tendermint_tpu_torch/statesync/syncer.py EngineCommitPreverify) against
the JAX package's, on the chain of tests/test_torch_lite2.py.

Tenants are lite2 clients bisecting through one cache.  Both packages run
the same tenants concurrently on one loop; stats() (hits, misses,
coalesced, evictions, ratios), the persisted heights and every verdict
must be identical.  The engine lane runs through each package's
AsyncBatchVerifier: the JAX one on its host path (no XLA compile), the
port's on its kernels' plain versions on the CPU.  Every test stops its
service.
"""

import asyncio
import types

import pytest
import torch

from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import batch_verifier as jbvm
from tendermint_tpu.liteserve.cache import VerifyCache as JVerifyCache
from tendermint_tpu.statesync.syncer import EngineCommitPreverify as JEngineCommitPreverify
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.libs import tracing
from tendermint_tpu_torch.liteserve import VerifyCache
from tendermint_tpu_torch.statesync import EngineCommitPreverify
from tests.test_torch_lite2 import CHAIN, HEIGHTS, JAX, NOW, PORT, chain

torch.set_num_threads(1)

JAX_HOST_ONLY = 1 << 20  # the JAX verifier serves every batch on its host path

PORT_LANE = types.SimpleNamespace(
    pkg=PORT, VerifyCache=VerifyCache, Preverify=EngineCommitPreverify,
    async_verifier=lambda: bvm.AsyncBatchVerifier(bvm.BatchVerifier(device="cpu")),
)
JAX_LANE = types.SimpleNamespace(
    pkg=JAX, VerifyCache=JVerifyCache, Preverify=JEngineCommitPreverify,
    async_verifier=lambda: jbvm.AsyncBatchVerifier(
        jbvm.BatchVerifier(min_device_batch=JAX_HOST_ONLY)),
)


@pytest.fixture(autouse=True)
def hooks():
    """No process-wide hook in either package unless a test installs one."""
    saved = jbatch._verifier, jbatch._indexed_verifier
    for hook in (jbatch, batch_hook):
        hook.set_verifier(None)
        hook.set_indexed_verifier(None)
    try:
        yield
    finally:
        batch_hook.set_verifier(None)
        batch_hook.set_indexed_verifier(None)
        jbatch.set_verifier(saved[0])
        jbatch.set_indexed_verifier(saved[1])


async def with_engine(lane, body):
    """Start the lane's AsyncBatchVerifier, run body(abv), stop it."""
    abv = lane.async_verifier()
    await abv.start()
    try:
        return await body(abv)
    finally:
        await abv.stop()


async def parity(scenario):
    ours = await scenario(PORT_LANE)
    theirs = await scenario(JAX_LANE)
    assert ours == theirs
    return ours


async def tenants_bisect(lane, cache, n):
    """n fresh clients bisect 1 -> HEIGHTS concurrently through cache."""
    c = chain(lane.pkg)
    clients = [c.client(1, commit_preverify=cache.preverify()) for _ in range(n)]
    got = await asyncio.gather(*(cl.verify_header_at_height(HEIGHTS, NOW) for cl in clients))
    primary = c.headers[HEIGHTS].hash()
    return [sh.hash() == primary for sh in got], [cl.store.heights() for cl in clients]


@pytest.mark.parametrize("n_tenants", [1, 4])
async def test_concurrent_tenants_share_one_verification(n_tenants):
    """Single flight: each tenant makes 4 preverify calls (init + the
    three bisection steps) over 3 distinct headers, so 3 misses and the
    rest hits or coalesced joins, the same split in both packages."""

    async def scenario(lane):
        async def body(abv):
            cache = lane.VerifyCache(async_verifier=abv)
            agree, heights = await tenants_bisect(lane, cache, n_tenants)
            return agree, heights, cache.stats()

        return await with_engine(lane, body)

    agree, heights, stats = await parity(scenario)
    assert agree == [True] * n_tenants
    assert heights == [[40, 20, 1]] * n_tenants
    assert stats["misses"] == 3
    assert stats["hits"] + stats["coalesced"] == 4 * n_tenants - 3
    if n_tenants > 1:
        assert stats["coalesced"] > 0


async def test_digest_guard_misses_on_a_different_commit():
    """The same header with a different commit (one signature absent) is
    verified for real, never served the first commit's verdicts; the entry
    then holds the newer commit."""

    async def scenario(lane):
        c = chain(lane.pkg)
        sh, vals = c.headers[12], c.vals[12]
        sigs = list(sh.commit.signatures)
        sigs[3] = type(sigs[3]).absent()
        other = c.ns.SignedHeader(sh.header, c.ns.Commit(12, 0, sh.commit.block_id, sigs))
        cache = lane.VerifyCache()
        hook = cache.preverify()
        for s in (sh, sh, other, other, sh):
            lookup = await hook(s, [vals])
            vals.verify_commit(CHAIN, s.commit.block_id, 12, s.commit, batch_verify=lookup)
        return cache.stats()

    stats = await parity(scenario)
    assert (stats["misses"], stats["hits"], stats["size"]) == (3, 2, 1)


async def test_eviction_at_capacity():
    async def scenario(lane):
        c = chain(lane.pkg)
        cache = lane.VerifyCache(capacity=2)
        hook = cache.preverify()
        for h in (5, 15, 25, 5, 25):
            await hook(c.headers[h], [c.vals[h]])
        return cache.stats()

    stats = await parity(scenario)
    assert (stats["misses"], stats["hits"], stats["evictions"], stats["size"]) == (4, 1, 2, 2)
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        VerifyCache(capacity=0)


async def test_executor_lane_through_the_installed_hook():
    """No async_verifier: misses verify on the default executor through
    the process-wide hook (the port's BatchVerifier on the CPU)."""
    rec = tracing.FlightRecorder(size=256)
    bv = bvm.BatchVerifier(device="cpu", recorder=rec)

    async def scenario(lane):
        if lane is PORT_LANE:
            batch_hook.set_verifier(bv.verify)
        cache = lane.VerifyCache()
        agree, heights = await tenants_bisect(lane, cache, 2)
        return agree, heights, cache.stats()

    agree, heights, stats = await parity(scenario)
    assert agree == [True, True] and heights == [[40, 20, 1]] * 2
    assert stats["misses"] == 3
    dispatches = rec.events(kinds=["verify.dispatch"])
    assert [e["n"] for e in dispatches] == [16] * 3
    assert {e["path"] for e in dispatches} == {"device"}


async def test_lookup_verifies_triples_outside_the_entry():
    """A triple the entry lacks verifies through the hook and is kept."""

    async def scenario(lane):
        c = chain(lane.pkg)
        sh, vals = c.headers[7], c.vals[7]
        lookup = await lane.VerifyCache().preverify()(sh, [vals])
        pk = vals.validators[0].pub_key.bytes()
        msg = sh.commit.vote_sign_bytes(CHAIN, 0)
        sig = sh.commit.signatures[0].signature
        bad = bytes([sig[0] ^ 1]) + sig[1:]
        return lookup([pk, pk, pk], [msg, msg, msg + b"!"], [sig, bad, sig])

    assert await parity(scenario) == [True, False, False]


async def test_engine_commit_preverify_matches_jax():
    """Statesync's lane: each commit arrives at the AsyncBatchVerifier as
    one verify_many; a second client over the same lane enqueues nothing
    new, and a lookup miss falls back to the process-wide hook."""

    async def scenario(lane):
        async def body(abv):
            enqueued = []
            verify_many = abv.verify_many

            def counting(items):
                enqueued.append(len(items))
                return verify_many(items)

            abv.verify_many = counting
            pre = lane.Preverify(abv)
            c = chain(lane.pkg)
            first = c.client(1, commit_preverify=pre)
            sh = await first.verify_header_at_height(HEIGHTS, NOW)
            before = list(enqueued)
            second = c.client(1, commit_preverify=pre)
            await second.verify_header_at_height(HEIGHTS, NOW)
            # malformed shape: the hook declines and verify_commit raises its own error
            declined = await pre(c.headers[5], [c.ns.ValidatorSet(c.vals[5].validators[:8])])
            v = c.vals[5].validators[0]
            other = c.key_of[v.address].sign(b"not a vote")
            miss = pre._lookup([v.pub_key.bytes()] * 2, [b"not a vote"] * 2,
                               [other, c.headers[5].commit.signatures[0].signature])
            return (sh.hash() == c.headers[HEIGHTS].hash(), first.store.heights(),
                    second.store.heights(), before, enqueued, declined, miss)

        return await with_engine(lane, body)

    ok, first, second, before, after, declined, miss = await parity(scenario)
    assert ok and first == second == [40, 20, 1]
    assert before == after == [16, 16, 16]
    assert declined is None and miss == [True, False]
