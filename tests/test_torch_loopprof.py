"""The port's scheduler profiler (tendermint_tpu_torch/libs/loopprof.py and
the spawn hook in libs/service.py) against the JAX package's: the category
table, the resume-timing trampoline (values, exceptions and cancellation
pass through unchanged), process-hook ownership, spawn and GC accounting,
the lag histogram and the attribution math.  Every case runs on both
packages; the deterministic ones also compare the two packages' results.
Tolerance: exact, except busy times, which are only required to be > 0.
"""

import asyncio
import gc
import time
import types

import pytest

from tendermint_tpu.libs import loopprof as jloopprof
from tendermint_tpu.libs import service as jservice
from tendermint_tpu.libs import tracing as jtracing
from tendermint_tpu_torch.libs import loopprof as ploopprof
from tendermint_tpu_torch.libs import service as pservice
from tendermint_tpu_torch.libs import tracing as ptracing

JAX = types.SimpleNamespace(name="jax", loopprof=jloopprof, Service=jservice.Service,
                            FlightRecorder=jtracing.FlightRecorder)
PORT = types.SimpleNamespace(name="port", loopprof=ploopprof, Service=pservice.Service,
                             FlightRecorder=ptracing.FlightRecorder)
PKGS = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])


@pytest.fixture(autouse=True)
def _port_hook_guard():
    """The port's spawn and GC hooks are process-wide like the JAX ones:
    never let one leak into a later test."""
    yield
    prof = ploopprof._ACTIVE
    if prof is not None:
        ploopprof._ACTIVE = None
        if prof._gc_cb is not None and prof._gc_cb in gc.callbacks:
            gc.callbacks.remove(prof._gc_cb)


SITES = [("ConsensusState", "recv-routine"), ("ConsensusReactor", "gossip-data-ab12"),
         ("ConsensusReactor", "maj23-queries"), ("batch-verifier", "flush-loop"),
         ("MConnection", "send-routine"), ("Switch", "accept-routine"),
         ("MempoolReactor", "broadcast"), ("RPCServer", ""), ("SomethingElse", ""),
         ("node", "valset-watch"), ("watchdog", "watchdog-tick"), ("consensus", "ticker"),
         ("proxy-app-conns", ""), ("wal", "")]


def test_categorize_table_equals_jax():
    assert ploopprof.CATEGORIES == jloopprof.CATEGORIES
    assert ploopprof._RULES == jloopprof._RULES
    for svc, task in SITES:
        assert ploopprof.categorize(svc, task) == jloopprof.categorize(svc, task), (svc, task)


@PKGS
def test_spawn_sites_map_to_their_subsystem(pkg):
    c = pkg.loopprof.categorize
    assert c("ConsensusState", "recv-routine") == "consensus"
    assert c("ConsensusReactor", "gossip-data-ab12") == "gossip"
    assert c("batch-verifier", "flush-loop") == "verify"
    assert c("MempoolReactor", "broadcast") == "mempool"
    assert c("RPCServer") == "rpc"
    assert c("SomethingElse") == "other"
    for _, cat in pkg.loopprof._RULES:
        assert cat in pkg.loopprof.CATEGORIES


class _Yield:
    """Awaitable that yields once to whatever drives the coroutine."""

    def __await__(self):
        yield None


def _drive_to_completion(coro):
    steps = 0
    try:
        while True:
            coro.send(None)
            steps += 1
    except StopIteration as stop:
        return stop.value, steps


@PKGS
def test_return_value_passes_through(pkg):
    prof = pkg.loopprof.LoopProfiler()

    async def work():
        await _Yield()
        await _Yield()
        return 42

    value, steps = _drive_to_completion(prof.wrap(work(), "consensus"))
    assert (value, steps, prof.steps["consensus"]) == (42, 2, 3)
    assert prof.busy_ns["consensus"] > 0


@PKGS
def test_exception_passes_through_and_is_accounted(pkg):
    prof = pkg.loopprof.LoopProfiler()

    async def boom():
        await _Yield()
        raise ValueError("boom")

    coro = prof.wrap(boom(), "verify")
    coro.send(None)
    with pytest.raises(ValueError, match="boom"):
        coro.send(None)
    assert prof.steps["verify"] == 2


@PKGS
async def test_cancellation_and_sent_values_pass_through(pkg):
    prof = pkg.loopprof.LoopProfiler()
    loop = asyncio.get_event_loop()
    cleaned = asyncio.Event()
    fut = loop.create_future()

    async def forever():
        try:
            await asyncio.sleep(3600)
        except asyncio.CancelledError:
            cleaned.set()
            raise

    async def waiter():
        return await fut

    task = loop.create_task(prof.wrap(forever(), "gossip"))
    got = loop.create_task(prof.wrap(waiter(), "other"))
    await asyncio.sleep(0.01)
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task
    assert cleaned.is_set()
    fut.set_result("payload")
    assert await got == "payload"


@PKGS
async def test_first_profiler_owns_process_hooks(pkg):
    lp = pkg.loopprof
    assert lp.active() is None
    a, b = lp.LoopProfiler(interval=0.05), lp.LoopProfiler(interval=0.05)
    n_cb = len(gc.callbacks)
    await a.start()
    await b.start()
    try:
        assert lp.active() is a
        assert a._owns_hooks and not b._owns_hooks
        assert len(gc.callbacks) == n_cb + 1
    finally:
        await b.stop()
        assert lp.active() is a  # a non-owner's stop releases nothing
        await a.stop()
    assert lp.active() is None
    assert len(gc.callbacks) == n_cb


@PKGS
async def test_spawn_accounts_to_category_when_active(pkg):
    prof = pkg.loopprof.LoopProfiler(interval=0.05)
    await prof.start()
    svc = pkg.Service("MempoolReactor")
    done = asyncio.Event()

    async def job():
        await asyncio.sleep(0)
        done.set()
        return "ok"

    try:
        task = svc.spawn(job(), "broadcast")
        await asyncio.wait_for(done.wait(), 5)
        assert await task == "ok"
        assert prof.busy_ns["mempool"] > 0
        assert prof.steps["mempool"] >= 2
        assert prof.steps["consensus"] == 0
    finally:
        await svc.stop()
        await prof.stop()


@PKGS
async def test_spawn_untouched_without_profiler(pkg):
    assert pkg.loopprof.active() is None
    svc = pkg.Service("ConsensusState")
    done = asyncio.Event()

    async def job():
        done.set()

    try:
        task = svc.spawn(job(), "recv-routine")
        assert task.get_coro().__qualname__.endswith("job")  # not the trampoline
        await asyncio.wait_for(done.wait(), 5)
    finally:
        await svc.stop()


@PKGS
async def test_probe_emits_lag_busy_queue_and_gc_events(pkg):
    rec = pkg.FlightRecorder(size=512)
    prof = pkg.loopprof.LoopProfiler(interval=0.02, recorder=rec)
    prof.add_queue_probe("stub_queue", lambda: 7)
    prof.add_queue_probe("dead_probe", lambda: 1 // 0)  # raises -> -1
    await prof.start()
    try:
        async def spin():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.01:
                await asyncio.sleep(0)

        await prof.wrap(spin(), "consensus")
        gc.collect()
        await asyncio.sleep(0.08)
        snap = prof.snapshot()
    finally:
        await prof.stop()
    kinds = {e["kind"] for e in rec.events()}
    assert {"loop.lag", "loop.busy", "loop.gc_pause", "loop.queue"} <= kinds
    q = next(e for e in rec.events() if e["kind"] == "loop.queue")
    assert (q["stub_queue"], q["dead_probe"]) == (7, -1)
    busy = next(e for e in rec.events() if e["kind"] == "loop.busy")
    assert pkg.loopprof.busy_categories(busy).get("consensus", 0) > 0
    gc_ev = next(e for e in rec.events() if e["kind"] == "loop.gc_pause")
    assert gc_ev["n"] >= 1
    assert snap["lag_samples"] > 0 and snap["owns_hooks"] is True
    assert set(snap) == {"interval_s", "lag_p90_ms", "lag_max_ms", "lag_samples", "busy_ms",
                         "gc_total_ms", "owns_hooks"}


def _lag_profile(lp):
    prof = lp.LoopProfiler()
    for ms in [0.05] * 30 + [0.2] * 60 + [3.0] * 5 + [200.0] * 5:
        prof._observe_lag(ms / 1000)
    return prof.lag_samples, prof.lag_p90_ms(), prof.lag_max_ms, list(prof._lag_counts)


@PKGS
def test_lag_histogram_p90(pkg):
    samples, p90, mx, _ = _lag_profile(pkg.loopprof)
    assert (samples, p90) == (100, 0.25)
    assert mx == pytest.approx(200.0)
    with pytest.raises(ValueError):
        pkg.loopprof.LoopProfiler(interval=0)


def test_lag_histogram_equals_jax():
    assert _lag_profile(ploopprof) == _lag_profile(jloopprof)


ATTRIBUTION_CASES = {
    # 1000 ms: 400 consensus + 100 verify busy, 50 GC, 600 lag capped at
    # the 450 ms unaccounted remainder
    "capped_lag": ([{"t_ns": 500_000_000, "kind": "loop.busy", "interval_ms": 250.0,
                     "consensus_ms": 400.0, "verify_ms": 100.0},
                    {"t_ns": 600_000_000, "kind": "loop.gc_pause", "n": 2, "ms": 50.0},
                    {"t_ns": 700_000_000, "kind": "loop.lag", "lag_ms": 600.0}],
                   0, 1_000_000_000),
    "idle_remainder": ([{"t_ns": 100, "kind": "loop.busy", "interval_ms": 250.0,
                         "gossip_ms": 100.0}], 0, 1_000_000_000),
    "outside_excluded": ([{"t_ns": 0, "kind": "loop.busy", "interval_ms": 1.0, "rpc_ms": 99.0},
                          {"t_ns": 500, "kind": "loop.busy", "interval_ms": 1.0, "rpc_ms": 1.0},
                          {"t_ns": 2_000, "kind": "loop.busy", "interval_ms": 1.0,
                           "rpc_ms": 99.0}], 0, 1_000),
    "no_profiler_events": ([{"t_ns": 5, "kind": "commit"}], 0, 10),
    "empty_interval": ([], 10, 10),
}


@pytest.mark.parametrize("case", sorted(ATTRIBUTION_CASES))
def test_attribution_equals_jax(case):
    events, t0, t1 = ATTRIBUTION_CASES[case]
    got = ploopprof.attribution(events, t0, t1)
    assert got == jloopprof.attribution(events, t0, t1)
    if case == "capped_lag":
        assert got == {"consensus_pct": 40.0, "verify_pct": 10.0, "wall_ms": 1000.0,
                       "gc_pct": 5.0, "loop_lag_pct": 45.0, "idle_pct": 0.0}
    if case in ("no_profiler_events", "empty_interval"):
        assert got is None
