"""Asyncio scheduler profiler (the port's copy of tendermint_tpu/libs/loopprof.py):
where do the event loop's seconds go?

No reference counterpart — the reference runs one goroutine per concern
and the Go scheduler is preemptive; here EVERY subsystem (consensus,
gossip routines, p2p connections, the verify engine's batcher, mempool,
RPC) shares one cooperative event loop, and at committee scale the loop
itself becomes the bottleneck, and without a profiler its seconds can
only be attributed by narrative ("Python-loop-bound").  This module turns
that narrative into numbers, per node, from the same flight-recorder
stream production telemetry uses:

  loop lag       a probe task sleeps a fixed interval and measures the
                 scheduled-vs-actual wakeup delta — the scheduling delay
                 every timeout, ping and gossip wakeup on this loop pays.
                 `tendermint_loop_lag_seconds` histogram + `loop.lag`
                 recorder events + a bucketed p90 the rigs report as
                 `loop_lag_ms_p90_100val`.

  task time      every task spawned through `Service.spawn` is wrapped in
                 a resume-timing trampoline and accounted to a CATEGORY
                 (consensus / gossip / p2p-conn / verify / mempool / rpc /
                 other) derived from its service + task name — the spawn
                 path already names everything, so categorization is free.
                 Per-interval deltas are emitted as `loop.busy` events and
                 `tendermint_loop_task_busy_seconds{category=...}`.

  GC pauses      gc.callbacks hooks accumulate collection pause time;
                 the probe tick emits `loop.gc_pause` (count, total, max)
                 and observes `tendermint_loop_gc_pause_seconds`.  The
                 callback itself only does integer math — it may fire
                 inside ANY allocation, including under the recorder's
                 lock, so it must never take locks or allocate its way
                 into recursion.

  queue depths   registered probes are sampled every tick into one
                 `loop.queue` event and `tendermint_loop_queue_depth
                 {queue=...}` gauges — the known choke points (consensus
                 receive queue, MConnection send queues, AsyncBatchVerifier
                 pending, flush-executor backlog) wired by the node.

Process-wide vs per-node: the task-accounting spawn hook and the GC hooks
are PROCESS-global (one event loop, one GC), so the first profiler to
start owns them — on a multi-node in-proc rig (scale_smoke runs 100 nodes
on one loop) node0's profiler accounts the whole process, which is the
only attribution that means anything there.  The lag probe and queue
probes are per-profiler, so every enabled node still measures its own
view.  Multi-process rigs (run_localnet) get true per-node attribution.

Overhead contract: disabled ([instrumentation] loop_profiler = false, or
simply no profiler installed) the spawn path pays ONE module-global None
check and zero wrapping.  Enabled, the trampoline pays one
perf_counter_ns pair + a dict update per task RESUME (not per await of a
completed future).
"""

from __future__ import annotations

import asyncio
import gc
import time
import types
from typing import Callable, Dict, List, Optional

#: Attribution categories, in reporting order.  `other` catches tasks the
#: rules below don't place (cli helpers, tests) so shares still sum.
CATEGORIES = ("consensus", "gossip", "p2p-conn", "verify", "mempool", "rpc", "other")

# (substring of "<service>/<task>" lowercased) -> category; first match
# wins, so the more specific gossip rules precede the consensus ones.
_RULES = (
    ("gossip-", "gossip"),
    ("maj23-", "gossip"),
    ("bcast-", "gossip"),
    ("batch-verifier", "verify"),
    ("mconn", "p2p-conn"),
    ("peer", "p2p-conn"),
    ("switch", "p2p-conn"),
    ("transport", "p2p-conn"),
    ("pex", "p2p-conn"),
    ("secret", "p2p-conn"),
    ("mempool", "mempool"),
    ("rpc", "rpc"),
    ("http", "rpc"),
    ("grpc", "rpc"),
    ("consensus", "consensus"),
    ("ticker", "consensus"),
    ("wal", "consensus"),
)


def categorize(service_name: str, task_name: str = "") -> str:
    """Map a Service.spawn call site to an attribution category."""
    key = f"{service_name}/{task_name}".lower()
    for needle, cat in _RULES:
        if needle in key:
            return cat
    return "other"


# -- the process-wide spawn hook (consulted by Service.spawn) ---------------

_ACTIVE: Optional["LoopProfiler"] = None


def active() -> Optional["LoopProfiler"]:
    return _ACTIVE


@types.coroutine
def _drive(it, acct: Callable[[int], None]):
    """Generator trampoline: forward every send/throw between the event
    loop and the wrapped coroutine's __await__ iterator, timing each
    RESUME (the on-CPU slice between two yields to the loop).  Values,
    exceptions and cancellation all pass through unchanged."""
    value = None
    exc = None
    while True:
        t0 = time.perf_counter_ns()
        try:
            if exc is not None:
                e, exc = exc, None
                yielded = it.throw(e)
            else:
                yielded = it.send(value)
        except StopIteration as stop:
            acct(time.perf_counter_ns() - t0)
            return stop.value
        except BaseException:
            acct(time.perf_counter_ns() - t0)
            raise
        acct(time.perf_counter_ns() - t0)
        try:
            value = yield yielded
        except BaseException as e:  # noqa: BLE001 — must forward CancelledError
            value = None
            exc = e


class LoopProfiler:
    """One per node ([instrumentation] loop_profiler); the first to start
    in a process additionally owns the spawn + GC hooks (see module doc).
    `metrics` is a libs.metrics.LoopMetrics (or None), `recorder` a
    FlightRecorder (or None)."""

    # bucketed lag histogram (ms upper edges) — fixed memory, p90 readable
    # without keeping every sample
    LAG_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, float("inf"))

    def __init__(self, interval: float = 0.25, metrics=None, recorder=None):
        if interval <= 0:
            raise ValueError("loop_probe_interval must be > 0")
        self.interval = interval
        self.metrics = metrics
        self.recorder = recorder
        # task accounting (written from the trampoline, read by the probe)
        self.busy_ns: Dict[str, int] = {c: 0 for c in CATEGORIES}
        self.steps: Dict[str, int] = {c: 0 for c in CATEGORIES}
        self._busy_last: Dict[str, int] = dict(self.busy_ns)
        # lag histogram
        self._lag_counts = [0] * len(self.LAG_BUCKETS_MS)
        self.lag_samples = 0
        self.lag_max_ms = 0.0
        # most recent probe's lag — the health watchdog's "is the loop
        # wedged RIGHT NOW" feed (max/p90 are cumulative, not current)
        self.last_lag_ms = 0.0
        # gc accounting (ints only — the callback runs inside collections)
        self._gc_t0 = 0
        self._gc_pause_ns = 0
        self._gc_pauses = 0
        self._gc_max_ns = 0
        self.gc_total_ms = 0.0
        self._queue_probes: Dict[str, Callable[[], int]] = {}
        self._task: Optional[asyncio.Task] = None
        self._owns_hooks = False
        self._gc_cb = None

    # -- task accounting ---------------------------------------------------
    def wrap(self, coro, category: str):
        """Wrap a coroutine so every resume is timed into `category`."""
        busy = self.busy_ns
        steps = self.steps

        def acct(ns: int, _cat: str = category) -> None:
            busy[_cat] = busy.get(_cat, 0) + ns
            steps[_cat] = steps.get(_cat, 0) + 1

        async def runner():
            return await _drive(coro.__await__(), acct)

        return runner()

    def add_queue_probe(self, name: str, fn: Callable[[], int]) -> None:
        """Register a queue-depth sampler, read every probe tick.  `fn`
        must be cheap and exception-safe is not required — a raising probe
        samples as -1 (the wired object died; that is itself signal)."""
        self._queue_probes[name] = fn

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        global _ACTIVE
        if _ACTIVE is None:
            _ACTIVE = self
            self._owns_hooks = True
            self._gc_cb = self._on_gc
            gc.callbacks.append(self._gc_cb)
        self._task = asyncio.get_event_loop().create_task(
            self._probe_loop(), name="loop-profiler"
        )

    async def stop(self) -> None:
        global _ACTIVE
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._owns_hooks:
            if _ACTIVE is self:
                _ACTIVE = None
            if self._gc_cb is not None:
                try:
                    gc.callbacks.remove(self._gc_cb)
                except ValueError:
                    pass
            self._owns_hooks = False

    # -- gc hooks ----------------------------------------------------------
    def _on_gc(self, phase: str, info: dict) -> None:
        # integer math only: this fires inside arbitrary allocations —
        # taking a lock or allocating here can deadlock or recurse
        if phase == "start":
            self._gc_t0 = time.perf_counter_ns()
        elif phase == "stop" and self._gc_t0:
            d = time.perf_counter_ns() - self._gc_t0
            self._gc_pause_ns += d
            self._gc_pauses += 1
            if d > self._gc_max_ns:
                self._gc_max_ns = d

    # -- the probe ---------------------------------------------------------
    def lag_p90_ms(self) -> float:
        """p90 from the bucketed histogram (upper-edge estimate)."""
        if self.lag_samples == 0:
            return 0.0
        target = 0.9 * self.lag_samples
        acc = 0
        for count, edge in zip(self._lag_counts, self.LAG_BUCKETS_MS):
            acc += count
            if acc >= target:
                return min(edge, self.lag_max_ms) if edge != float("inf") else self.lag_max_ms
        return self.lag_max_ms

    def _observe_lag(self, lag_s: float) -> None:
        ms = max(0.0, lag_s * 1000.0)
        for i, edge in enumerate(self.LAG_BUCKETS_MS):
            if ms <= edge:
                self._lag_counts[i] += 1
                break
        self.lag_samples += 1
        self.last_lag_ms = ms
        if ms > self.lag_max_ms:
            self.lag_max_ms = ms
        if self.metrics is not None:
            self.metrics.lag_seconds.observe(max(0.0, lag_s))

    async def _probe_loop(self) -> None:
        loop = asyncio.get_event_loop()
        rec = self.recorder
        while True:
            scheduled = loop.time() + self.interval
            await asyncio.sleep(self.interval)
            lag = loop.time() - scheduled
            self._observe_lag(lag)
            if rec is not None:
                rec.record("loop.lag", lag_ms=round(max(0.0, lag) * 1000, 3))
            # per-category busy deltas since the last tick
            deltas = {}
            for cat, total in self.busy_ns.items():
                d = total - self._busy_last.get(cat, 0)
                if d > 0:
                    deltas[cat] = d
                self._busy_last[cat] = total
            if self.metrics is not None:
                for cat, total in self.busy_ns.items():
                    self.metrics.task_busy_seconds.labels(category=cat).set(total / 1e9)
            if rec is not None and deltas:
                rec.record(
                    "loop.busy",
                    interval_ms=round(self.interval * 1000, 1),
                    **{f"{c}_ms": round(ns / 1e6, 3) for c, ns in deltas.items()},
                )
            # gc pauses accumulated since the last tick
            pauses, self._gc_pauses = self._gc_pauses, 0
            pause_ns, self._gc_pause_ns = self._gc_pause_ns, 0
            max_ns, self._gc_max_ns = self._gc_max_ns, 0
            if pauses:
                self.gc_total_ms += pause_ns / 1e6
                if self.metrics is not None:
                    self.metrics.gc_pause_seconds.observe(pause_ns / 1e9)
                if rec is not None:
                    rec.record(
                        "loop.gc_pause", n=pauses,
                        ms=round(pause_ns / 1e6, 3), max_ms=round(max_ns / 1e6, 3),
                    )
            # queue depths
            if self._queue_probes:
                depths = {}
                for name, fn in self._queue_probes.items():
                    try:
                        depths[name] = int(fn())
                    except Exception:
                        depths[name] = -1
                if self.metrics is not None:
                    for name, depth in depths.items():
                        self.metrics.queue_depth.labels(queue=name).set(depth)
                if rec is not None:
                    rec.record("loop.queue", **depths)

    # -- summaries (rig/bench surface) -------------------------------------
    def snapshot(self) -> dict:
        return {
            "interval_s": self.interval,
            "lag_p90_ms": round(self.lag_p90_ms(), 3),
            "lag_max_ms": round(self.lag_max_ms, 3),
            "lag_samples": self.lag_samples,
            "busy_ms": {c: round(ns / 1e6, 1) for c, ns in self.busy_ns.items() if ns},
            "gc_total_ms": round(self.gc_total_ms, 1),
            "owns_hooks": self._owns_hooks,
        }


def busy_categories(event: dict) -> Dict[str, float]:
    """Per-category busy ms out of one `loop.busy` event."""
    return {
        k[:-3]: v for k, v in event.items()
        if k.endswith("_ms") and k != "interval_ms" and isinstance(v, (int, float))
    }


def attribution(events: List[dict], t0_ns: int, t1_ns: int) -> Optional[dict]:
    """Decompose the wall interval [t0_ns, t1_ns] (recorder-local
    monotonic ns) into measured shares that sum to ~100%:

      per-category task busy time (loop.busy deltas)
      gc      — collector pauses (loop.gc_pause)
      loop_lag — probe-measured scheduling delay NOT already attributed to
                 a wrapped task: uninstrumented callbacks, loop
                 bookkeeping, C extensions holding the GIL.  Capped at the
                 unaccounted remainder so double counting (lag caused by a
                 wrapped task's long resume) can't push the sum past 100.
      idle    — whatever remains.

    Returns None when the interval contains no loop.busy/loop.lag events
    (profiler off, or the interval predates it)."""
    wall_ms = (t1_ns - t0_ns) / 1e6
    if wall_ms <= 0:
        return None
    busy: Dict[str, float] = {}
    gc_ms = 0.0
    lag_ms = 0.0
    seen = False
    for ev in events:
        t = ev.get("t_ns", 0)
        if not (t0_ns < t <= t1_ns):
            continue
        k = ev.get("kind")
        if k == "loop.busy":
            seen = True
            for cat, ms in busy_categories(ev).items():
                busy[cat] = busy.get(cat, 0.0) + ms
        elif k == "loop.gc_pause":
            gc_ms += ev.get("ms", 0.0)
        elif k == "loop.lag":
            seen = True
            lag_ms += ev.get("lag_ms", 0.0)
    if not seen:
        return None
    busy_total = sum(busy.values())
    unaccounted = max(0.0, wall_ms - busy_total - gc_ms)
    lag_share_ms = min(lag_ms, unaccounted)
    idle_ms = max(0.0, wall_ms - busy_total - gc_ms - lag_share_ms)

    def pct(x: float) -> float:
        return round(100.0 * x / wall_ms, 1)

    out = {f"{c}_pct": pct(ms) for c, ms in sorted(busy.items()) if ms > 0}
    out.update({
        "wall_ms": round(wall_ms, 1),
        "gc_pct": pct(gc_ms),
        "loop_lag_pct": pct(lag_share_ms),
        "idle_pct": pct(idle_ms),
    })
    return out
