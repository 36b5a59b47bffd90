"""The port's vote-ingress batcher (tendermint_tpu_torch/crypto/
batch_verifier.py AsyncBatchVerifier) and its libs (Service, FlightRecorder,
VerifyMetrics) against the JAX package's, on the CPU.

The JAX package's TestAsyncBatchVerifier, TestWarmup's overflow case and
TestAdaptiveFlush (tests/test_batch_verifier.py) run here on the port with
the same expectations; where both packages take the same inputs (arrivals
under a fake clock, a storm, a batch, relay frames, a failing engine) the
verdicts, flush sizes, EWMA and quiet windows, and error messages must be
identical.  The JAX side routes to its host path (min_device_batch past any
batch), so no XLA compile runs; the port's side runs its kernels' plain
versions.  Every test stops its service.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import batch_verifier as jbvm
from tendermint_tpu.libs import metrics as jmetrics
from tendermint_tpu.libs import tracing as jtracing
from tendermint_tpu_torch.crypto import batch_verifier as bvm
from tendermint_tpu_torch.crypto.keys import Ed25519PrivKey
from tendermint_tpu_torch.libs import metrics, service, tracing

torch.set_num_threads(1)

CPU = "cpu"
JAX_HOST_ONLY = 1 << 20  # the JAX verifier serves every batch on its host path


def make_sigs(n, seed=0, bad=()):
    """n valid (pubkey, msg, sig) triples; rows in `bad` get a flipped bit."""
    rng = np.random.default_rng(seed)
    keys = [Ed25519PrivKey.from_secret(f"abv-{seed}-{i}".encode()) for i in range(n)]
    pks = [k.pub_key().bytes() for k in keys]
    msgs = [f"vote-{i}-{int(rng.integers(1 << 30))}".encode() for i in range(n)]
    sigs = []
    for i, (k, m) in enumerate(zip(keys, msgs)):
        sig = bytearray(k.sign(m))
        if i in bad:
            sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        sigs.append(bytes(sig))
    return pks, msgs, sigs


def port_svc(**kw):
    rec = tracing.FlightRecorder(size=4096)
    return bvm.AsyncBatchVerifier(bvm.BatchVerifier(device=CPU, recorder=rec), **kw), rec


def jax_svc(**kw):
    rec = jtracing.FlightRecorder(size=4096)
    return jbvm.AsyncBatchVerifier(
        jbvm.BatchVerifier(min_device_batch=JAX_HOST_ONLY, recorder=rec), **kw), rec


async def run(make, body, **kw):
    """Start a service, run body(svc), stop it; (result, recorder)."""
    svc, rec = make(**kw)
    await svc.start()
    try:
        return await body(svc), rec
    finally:
        await svc.stop()


def flushes(rec):
    return [e["batch"] for e in rec.events(kinds=["verify.flush"])]


# ---------------------------------------------------------------------------
# TestAsyncBatchVerifier / TestWarmup overflow, port vs JAX
# ---------------------------------------------------------------------------


async def test_futures_resolve_matches_jax():
    pks, msgs, sigs = make_sigs(4)

    async def body(svc):
        futs = [svc.verify_one(pk, m, s) for pk, m, s in zip(pks, msgs, sigs)]
        bad = svc.verify_one(pks[0], b"other", sigs[0])
        return await asyncio.gather(*futs, bad)

    ours, _ = await run(port_svc, body, flush_interval=0.01)
    theirs, _ = await run(jax_svc, body, flush_interval=0.01)
    assert ours == theirs == [True, True, True, True, False]


async def test_overflow_falls_back_inline():
    pks, msgs, sigs = make_sigs(2)

    async def body(svc):
        f1 = svc.verify_one(pks[0], msgs[0], sigs[0])
        f2 = svc.verify_one(pks[1], msgs[1], sigs[1])  # over cap: inline host
        assert f2.done() and f2.result() is True
        return await asyncio.wait_for(f1, 30)

    assert (await run(port_svc, body, flush_interval=0.01, max_pending=1))[0] is True


@pytest.mark.parametrize("max_pending", [3, 100])
async def test_verify_many_matches_jax(max_pending):
    """One batch as one arrival: flushes cut at max_batch; past max_pending
    the overflow verifies on the host path through the flush executor."""
    pks, msgs, sigs = make_sigs(10, seed=1, bad=(2, 7))

    async def body(svc):
        return await asyncio.gather(*svc.verify_many(list(zip(pks, msgs, sigs))))

    ours, rec = await run(port_svc, body, max_batch=4, max_pending=max_pending)
    theirs, jrec = await run(jax_svc, body, max_batch=4, max_pending=max_pending)
    assert ours == theirs == [i not in (2, 7) for i in range(10)]
    assert flushes(rec) == flushes(jrec) == ([4, 4, 2] if max_pending == 100 else [3])
    paths = {e["path"] for e in rec.events(kinds=["verify.dispatch"])}
    assert paths == {"device"}


async def test_storm_flush_sizes_match_jax():
    """A storm enqueued by verify_one in one loop tick flushes in batches
    of max_batch and then the rest, in both packages."""
    pks, msgs, sigs = make_sigs(11, seed=2, bad=(0, 5))

    async def body(svc):
        futs = [svc.verify_one(pk, m, s) for pk, m, s in zip(pks, msgs, sigs)]
        return await asyncio.gather(*futs)

    ours, rec = await run(port_svc, body, max_batch=4)
    theirs, jrec = await run(jax_svc, body, max_batch=4)
    assert ours == theirs == [i not in (0, 5) for i in range(11)]
    assert flushes(rec) == flushes(jrec) == [4, 4, 3]
    assert len(rec.events(kinds=["verify.enqueue"])) == 11


async def test_verify_direct_matches_jax():
    """Relay frames from concurrent senders go straight to the engine, one
    dispatch per frame, serialized on the flush executor."""
    pks, msgs, sigs = make_sigs(12, seed=3, bad=(4,))
    triples = list(zip(pks, msgs, sigs))
    frames = [triples[i:i + 3] for i in range(0, 12, 3)]

    async def body(svc):
        async def sender(k):
            return [await svc.verify_direct(f) for f in frames[k::2]]

        assert await svc.verify_direct([]) == []
        return await asyncio.gather(sender(0), sender(1))

    ours, rec = await run(port_svc, body)
    theirs, jrec = await run(jax_svc, body)
    assert ours == theirs
    flat = [ok for pair in zip(*ours) for frame in pair for ok in frame]
    assert flat == [i != 4 for i in range(12)]
    assert flushes(rec) == []
    assert [e["n"] for e in rec.events(kinds=["verify.direct_batch"])] == [3, 3, 3, 3]
    assert [e["n"] for e in rec.events(kinds=["verify.dispatch"])] == [3, 3, 3, 3]


class _Failing:
    """A stand-in engine whose first batch raises."""

    def __init__(self, inner):
        self.inner = inner
        self.metrics, self.recorder, self.shards = inner.metrics, inner.recorder, 1
        self.calls = 0

    def start_warmup(self):
        return self

    def verify(self, pks, msgs, sigs):
        self.calls += 1
        if self.calls == 1:
            raise ValueError("device fell over")
        return self.inner.verify(pks, msgs, sigs)


@pytest.mark.parametrize("pkg", ["port", "jax"])
async def test_failed_flush_fails_its_futures_and_keeps_the_loop(pkg):
    pks, msgs, sigs = make_sigs(3, seed=4)
    inner = (bvm.BatchVerifier(device=CPU) if pkg == "port"
             else jbvm.BatchVerifier(min_device_batch=JAX_HOST_ONLY))
    cls = bvm.AsyncBatchVerifier if pkg == "port" else jbvm.AsyncBatchVerifier
    svc = cls(_Failing(inner))
    await svc.start()
    try:
        first = svc.verify_one(pks[0], msgs[0], sigs[0])
        with pytest.raises(RuntimeError) as ei:
            await first
        assert str(ei.value) == "batch verify failed: ValueError('device fell over')"
        futs = [svc.verify_one(pk, m, s) for pk, m, s in zip(pks, msgs, sigs)]
        assert await asyncio.gather(*futs) == [True, True, True]
    finally:
        await svc.stop()


async def test_stop_cancels_pending_futures():
    pks, msgs, sigs = make_sigs(2, seed=5)
    svc, _ = port_svc(flush_interval=30.0, adaptive=False)
    await svc.start()
    futs = [svc.verify_one(pk, m, s) for pk, m, s in zip(pks, msgs, sigs)]
    await asyncio.sleep(0)
    await svc.stop()
    assert all(f.cancelled() for f in futs)
    assert svc._pending == []


# ---------------------------------------------------------------------------
# TestAdaptiveFlush
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", [bvm.AsyncBatchVerifier, jbvm.AsyncBatchVerifier],
                         ids=["port", "jax"])
def test_quiet_window_policy(cls):
    svc = cls(bvm.BatchVerifier(device=CPU), flush_interval=0.002, flush_min=0.0002)
    # no history: floor (flush as soon as the first window is quiet)
    assert svc._quiet_window() == svc.flush_min
    # sparse regime (next vote far beyond the deadline): floor
    svc._ewma_gap = 0.1
    assert svc._quiet_window() == svc.flush_min
    # trickle regime (more votes imminent): wait ~4 gaps for them
    svc._ewma_gap = 0.0003
    assert svc._quiet_window() == pytest.approx(0.0012)
    # storm regime: gaps tiny, floor again (arrivals re-extend anyway)
    svc._ewma_gap = 0.00001
    assert svc._quiet_window() == svc.flush_min


@pytest.mark.parametrize("flush_interval,flush_min,adaptive", [
    (0.002, 0.0002, True), (0.01, 0.001, True), (0.002, 0.005, False),
])
def test_arrivals_under_a_fake_clock_match_jax(flush_interval, flush_min, adaptive):
    """The same arrival sequence through both packages' _note_arrival and
    _quiet_window: the EWMA gap and the quiet window are equal after every
    arrival (the same float arithmetic in the same order)."""
    rng = np.random.default_rng(11)
    kw = dict(flush_interval=flush_interval, flush_min=flush_min, adaptive=adaptive)
    ours = bvm.AsyncBatchVerifier(bvm.BatchVerifier(device=CPU), **kw)
    theirs = jbvm.AsyncBatchVerifier(jbvm.BatchVerifier(min_device_batch=JAX_HOST_ONLY), **kw)
    # storm, trickle, a long idle gap, sparse traffic
    gaps = np.concatenate([rng.exponential(2e-5, 40), rng.exponential(3e-4, 40), [5.0],
                           rng.exponential(0.05, 20)])
    now = 100.0
    for gap, accepted in zip(gaps, rng.integers(1, 5, len(gaps))):
        now += float(gap)
        ours._note_arrival(now, int(accepted))
        theirs._note_arrival(now, int(accepted))
        assert ours._ewma_gap == theirs._ewma_gap
        assert ours._quiet_window() == theirs._quiet_window()
        assert ours._enqueued == theirs._enqueued
    assert ours.flush_min == theirs.flush_min == min(flush_min, flush_interval)


async def test_sparse_and_burst_resolve():
    pks, msgs, sigs = make_sigs(16, seed=6)
    # 500 ms cap: the fixed-quantum behavior would park a lone vote for the
    # whole cap; adaptive must flush it in about a quiet window.  A lone
    # vote takes the host path (min_device_batch=2): the plain ladder on the
    # CPU would time the kernel, not the flusher.
    svc = bvm.AsyncBatchVerifier(bvm.BatchVerifier(device=CPU, min_device_batch=2),
                                 flush_interval=0.5)
    await svc.start()
    try:
        assert await svc.verify_one(pks[0], msgs[0], sigs[0]) is True  # warm
        t0 = time.perf_counter()
        assert await svc.verify_one(pks[0], msgs[0], sigs[0]) is True
        assert time.perf_counter() - t0 < 0.25
        # burst: everything lands in one coalesced batch, all correct
        futs = [svc.verify_one(pk, m, s) for pk, m, s in zip(pks, msgs, sigs)]
        bad = svc.verify_one(pks[0], msgs[1], sigs[0])
        assert await asyncio.gather(*futs) == [True] * 16
        assert await bad is False
    finally:
        await svc.stop()


async def test_fixed_interval_mode_still_works():
    pks, msgs, sigs = make_sigs(3, seed=7)
    svc, _ = port_svc(flush_interval=0.002, adaptive=False)
    await svc.start()
    try:
        futs = [svc.verify_one(pk, m, s) for pk, m, s in zip(pks, msgs, sigs)]
        assert await asyncio.gather(*futs) == [True, True, True]
    finally:
        await svc.stop()


async def test_small_flushes_take_the_host_path():
    """Below min_device_batch a flush verifies on the host path."""
    pks, msgs, sigs = make_sigs(3, seed=8, bad=(1,))
    rec = tracing.FlightRecorder()
    svc = bvm.AsyncBatchVerifier(bvm.BatchVerifier(device=CPU, min_device_batch=16, recorder=rec))
    await svc.start()
    try:
        futs = [svc.verify_one(pk, m, s) for pk, m, s in zip(pks, msgs, sigs)]
        assert await asyncio.gather(*futs) == [True, False, True]
    finally:
        await svc.stop()
    assert [e["path"] for e in rec.events(kinds=["verify.dispatch"])] == ["host"]


# ---------------------------------------------------------------------------
# libs: Service, FlightRecorder, VerifyMetrics
# ---------------------------------------------------------------------------


async def test_service_lifecycle():
    svc = service.Service("svc")
    await svc.start()
    assert svc.is_running and svc.name == "svc"
    with pytest.raises(service.AlreadyStartedError):
        await svc.start()

    async def forever():
        await asyncio.sleep(3600)

    task = svc.spawn(forever(), "forever")
    await svc.stop()
    assert task.cancelled() and not svc.is_running
    await svc.stop()  # a second stop waits for the first, then returns
    await asyncio.wait_for(svc.wait_stopped(), 1)
    with pytest.raises(service.AlreadyStartedError):
        await svc.start()
    late = svc.spawn(forever(), "late")  # spawned after stop: cancelled at once
    await asyncio.sleep(0)
    assert late.cancelled()
    never = service.Service()
    await never.stop()
    with pytest.raises(service.AlreadyStoppedError):
        await never.start()


async def test_wait_event():
    ev = asyncio.Event()
    assert await service.wait_event(ev, 0.01) is False
    asyncio.get_running_loop().call_later(0.01, ev.set)
    assert await service.wait_event(ev, 5) is True


def test_flight_recorder_matches_jax():
    def drive(mod):
        rec = mod.FlightRecorder(size=4, sample_high_rate=2)
        for i in range(6):
            rec.record("verify.flush", batch=i)
        for i in range(3):
            rec.record_sampled("gossip.wakeup", i=i)
        events = [{k: v for k, v in e.items() if k != "t_ns"} for e in rec.events()]
        snap = rec.snapshot(since=5, kinds=["verify."])
        return (events, rec.dropped, sorted(snap), snap["next_seq"], snap["dropped"],
                [e["seq"] for e in snap["events"]], mod.NOP.snapshot(), mod.NOP.events())

    assert drive(tracing) == drive(jtracing)
    with pytest.raises(ValueError):
        tracing.FlightRecorder(size=0)
    off = tracing.FlightRecorder(enabled=False)
    off.record("x")
    assert off.events() == []


def test_verify_metrics_names_match_jax():
    ours, theirs = metrics.VerifyMetrics(), jmetrics.VerifyMetrics()
    assert vars(ours).keys() == vars(theirs).keys()
    for m in vars(ours).values():
        assert m.labels(chain_id="x") is m
        m.inc(), m.set(1), m.observe(0.1), m.dec()
