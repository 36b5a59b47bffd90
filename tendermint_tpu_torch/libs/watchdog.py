"""Health watchdog: the node notices its own degradation (the port's copy
of tendermint_tpu/libs/watchdog.py, with StorageHealth, the sink its disk
detectors read).

No reference counterpart — the reference node serves `/health` as a bare
`{}` and relies on operators (or a Jepsen harness) to notice that it has
stopped committing.  A node must self-report health so traffic can be
routed away from it and evidence captured while it degrades, not after.

A Watchdog is a Service ticking every `[instrumentation]
watchdog_interval` seconds over a fixed detector inventory:

  consensus_stall    tip not advancing for watchdog_stall_seconds while
                     the node believes it is caught up.  CRITICAL.
  verify_stall       the AsyncBatchVerifier holds a pending entry older
                     than watchdog_verify_stall_seconds — the flusher is
                     wedged and every vote behind it.  CRITICAL.
  round_churn        consensus round >= watchdog_round_churn: the net is
                     live-locked re-voting one height.
  peer_collapse      live peer count fell below HALF the peak this node
                     has seen (peak >= watchdog_min_peers).
  loop_lag           the scheduler profiler's probe missed its wakeup by
                     more than watchdog_lag_ms on two consecutive probes
                     (one breach is a burst; two is a wedged loop).
  mempool_saturation pool size >= watchdog_mempool_ratio of its cap.
  clock_drift        wall-vs-monotonic divergence since watchdog start
                     exceeds watchdog_clock_drift_seconds.

Clock discipline: every *interval*
("unchanged for N seconds") is measured on the MONOTONIC clock, so an
injected wall skew (chaos SkewedClock) can neither fake nor mask a
stall.  The drift detector is the one reader of the wall clock — through
`consensus.clock`, so it sees exactly the wall time consensus signs with
— and it alarms on *divergence from its own baseline*: a constant offset
(NTP being late since boot, `[chaos] clock_skew` from config) is a
correct clock that happens to disagree with the host, not drift; a
runtime skew step IS drift and trips it.

Each detector exports `tendermint_health_alarm{alarm=...}` plus raise
counters; the aggregate verdict (ok / degraded / critical — critical iff
a critical-severity alarm is active) is `tendermint_health_verdict`, the
`/health` RPC route and the `health` block in `/status`.  Transitions
emit `health.alarm` / `health.clear` recorder events (so the flight
spool preserves the node's self-diagnosis across a crash), and the
transition INTO critical writes a rate-bounded forensics bundle under
`<home>/data/forensics/` — evidence captured at the moment of
degradation, not after an operator notices.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Callable, Dict, Optional

from .log import get_logger
from .service import Service

#: alarm -> severity; critical alarms drive the verdict to `critical`,
#: everything else to `degraded`.
ALARM_SEVERITY = {
    "consensus_stall": "critical",
    "verify_stall": "critical",
    "disk_fault": "critical",
    "round_churn": "degraded",
    "peer_collapse": "degraded",
    "loop_lag": "degraded",
    "mempool_saturation": "degraded",
    "ingress_shedding": "degraded",
    "clock_drift": "degraded",
    "disk_pressure": "degraded",
}

VERDICT_LEVEL = {"ok": 0, "degraded": 1, "critical": 2}


class StorageHealth:
    """One sink for every storage-fault observation in the node — the WAL,
    block store, state store, mempool journal, privval and the consensus
    halt path all report here — plus the free-space probe.  The watchdog's
    `disk_fault` / `disk_pressure` detectors read it; `storage_info` and
    debug bundles serve its summary.  Thread-light: counters only, safe to
    bump from executor threads."""

    def __init__(self, data_dir: Optional[str] = None, metrics=None):
        self.data_dir = data_dir
        self.metrics = metrics  # StorageMetrics (node wires after provider)
        self.write_errors: Dict[str, int] = {}
        self.corruptions: Dict[str, int] = {}
        self.halts: Dict[str, str] = {}  # component -> reason (sticky)
        self.quarantined: Dict[str, int] = {}  # store -> live count
        self.refills = 0
        self.last_error: Optional[dict] = None  # {mono, store, err}
        self.last_scan: Optional[dict] = None

    # -- observation sinks ---------------------------------------------------
    def note_write_error(self, store: str, err: BaseException) -> None:
        self.write_errors[store] = self.write_errors.get(store, 0) + 1
        self.last_error = {"mono": time.monotonic(), "store": store, "err": repr(err)}
        if self.metrics is not None:
            self.metrics.write_errors.labels(store=store).inc()

    def note_corruption(self, store: str, detail: str) -> None:
        self.corruptions[store] = self.corruptions.get(store, 0) + 1
        self.last_error = {"mono": time.monotonic(), "store": store, "err": detail}
        if self.metrics is not None:
            self.metrics.corruptions.labels(store=store).inc()

    def set_quarantined(self, store: str, total: int) -> None:
        """Single source of truth for the quarantine gauge: callers pass
        the store's CURRENT quarantine-set size (prune can silently drop
        entries, so an incremental counter would drift into phantoms)."""
        self.quarantined[store] = total
        if self.metrics is not None:
            self.metrics.quarantined.set(total)

    def note_quarantine(
        self, store: str, height: int, reason: str, total: Optional[int] = None
    ) -> None:
        self.set_quarantined(
            store, total if total is not None else self.quarantined.get(store, 0) + 1
        )
        self.note_corruption(store, f"height {height} quarantined: {reason}")

    def note_refill(
        self, store: str, height: int, total: Optional[int] = None
    ) -> None:
        self.refills += 1
        self.set_quarantined(
            store,
            total if total is not None else max(0, self.quarantined.get(store, 0) - 1),
        )
        if self.metrics is not None:
            self.metrics.refills.inc()

    def note_halt(self, component: str, reason: str) -> None:
        self.halts[component] = reason

    def note_scan(self, report: dict) -> None:
        self.last_scan = report
        if self.metrics is not None:
            self.metrics.integrity_scan_seconds.set(report.get("ms", 0.0) / 1000.0)
            self.metrics.quarantined.set(len(report.get("quarantined", ())))

    # -- read surface --------------------------------------------------------
    def total_faults(self) -> int:
        return sum(self.write_errors.values()) + sum(self.corruptions.values())

    def free_bytes(self) -> Optional[int]:
        """statvfs headroom of the data dir (None: memdb node / probe
        failed — and a probe failing on a real dir is itself suspicious,
        but not enough signal to alarm on)."""
        if not self.data_dir:
            return None
        try:
            st = os.statvfs(self.data_dir)
        except OSError:
            return None
        free = st.f_bavail * st.f_frsize
        if self.metrics is not None:
            self.metrics.free_bytes.set(free)
        return free

    def summary(self) -> dict:
        return {
            "write_errors": dict(self.write_errors),
            "corruptions": dict(self.corruptions),
            "halts": dict(self.halts),
            "quarantined": dict(self.quarantined),
            "refills": self.refills,
            "last_error": dict(self.last_error) if self.last_error else None,
            "last_scan": dict(self.last_scan) if self.last_scan else None,
            "free_bytes": self.free_bytes(),
        }


class Watchdog(Service):
    """Periodic self-diagnosis over a Node (or anything duck-typing the
    probed surface — tests drive it with stubs).  `check()` is callable
    directly (the tick just calls it), so detectors are unit-testable
    without wall-clock sleeps: pass `now` (monotonic seconds) explicitly.
    """

    def __init__(
        self,
        node,
        interval: float = 2.0,
        stall_seconds: float = 30.0,
        round_churn: int = 4,
        verify_stall_seconds: float = 5.0,
        lag_ms: float = 1000.0,
        mempool_ratio: float = 0.9,
        shed_rate: float = 5.0,
        clock_drift_seconds: float = 2.0,
        min_peers: int = 2,
        disk_free_bytes: int = 128 * 1024 * 1024,
        disk_fault_hold: float = 30.0,
        metrics=None,
        recorder=None,
        autodump_fn: Optional[Callable[[dict], Optional[str]]] = None,
        autodump_min_interval: float = 60.0,
    ):
        super().__init__("watchdog")
        self.node = node
        self.interval = interval
        self.stall_seconds = stall_seconds
        self.round_churn = round_churn
        self.verify_stall_seconds = verify_stall_seconds
        self.lag_ms = lag_ms
        self.mempool_ratio = mempool_ratio
        self.shed_rate = shed_rate
        self.clock_drift_seconds = clock_drift_seconds
        self.min_peers = min_peers
        self.disk_free_bytes = disk_free_bytes
        self.disk_fault_hold = disk_fault_hold
        from .metrics import HealthMetrics
        from .tracing import NOP as _NOP_RECORDER

        self.metrics = metrics if metrics is not None else HealthMetrics()
        self.recorder = recorder if recorder is not None else _NOP_RECORDER
        self.autodump_fn = autodump_fn
        self.autodump_min_interval = autodump_min_interval
        self.log = get_logger("watchdog")

        self.verdict = "ok"
        self.active: Dict[str, dict] = {}  # alarm -> {severity, reason, since}
        self.ticks = 0
        self.autodumps = 0
        self._tip: Optional[int] = None
        self._tip_changed: Optional[float] = None
        self._peer_peak = 0
        self._drift_base_ns: Optional[int] = None
        self._lag_breaches = 0
        self._shed_last: Optional[tuple] = None  # (throttled_total, now)
        self._shed_breaches = 0
        self._last_autodump: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    async def on_start(self) -> None:
        self.spawn(self._run(), name="watchdog-tick")

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                self.check()
            except Exception as e:  # noqa: BLE001 — the watchdog must outlive
                # any probed object dying mid-teardown; a crashed watchdog
                # is a node that can no longer notice anything
                self.log.error("watchdog tick failed", err=repr(e))

    # -- detectors ---------------------------------------------------------

    def _caught_up(self) -> bool:
        """Mirror of the /status sync-phase logic: a node mid-statesync or
        mid-fastsync legitimately is not advancing its own tip."""
        node = self.node
        ss = getattr(node, "statesync_reactor", None)
        if ss is not None and getattr(ss, "syncing", False):
            return False
        br = getattr(node, "blockchain_reactor", None)
        if br is not None and (
            getattr(br, "fast_sync", False) or getattr(br, "wait_statesync", False)
        ):
            return False
        return True

    def check(self, now: Optional[float] = None) -> dict:
        """Run every detector once and apply transitions; returns the
        health dict `/health` serves.  `now` is monotonic seconds
        (injectable for tests); wall time is read ONLY by the drift
        detector, via consensus' pluggable clock."""
        if now is None:
            now = time.monotonic()
        self.ticks += 1
        node = self.node
        alarms: Dict[str, str] = {}

        # consensus stall + round churn
        cs = getattr(node, "consensus", None)
        bs = getattr(node, "block_store", None)
        if cs is not None and bs is not None:
            tip = bs.height()
            if tip != self._tip:
                self._tip = tip
                self._tip_changed = now
            elif self._tip_changed is None:
                self._tip_changed = now
            running = getattr(cs, "is_running", False)
            # a wait-for-txs node ([consensus] create_empty_blocks=false)
            # with an empty mempool legitimately parks between heights —
            # an idle tip is its healthy state, not a stall
            waiting_for_txs = False
            ccfg = getattr(cs, "config", None)
            if ccfg is not None and getattr(ccfg, "wait_for_txs", None) is not None:
                mp = getattr(node, "mempool", None)
                waiting_for_txs = bool(
                    ccfg.wait_for_txs() and (mp is None or mp.size() == 0)
                )
            if not (running and self._caught_up() and not waiting_for_txs):
                # detector suppressed: re-baseline so the stall clock
                # starts when it re-arms — a tx arriving after 10 idle
                # minutes must get stall_seconds to commit, not an
                # instant "tip unchanged for 600s" critical
                self._tip_changed = now
            else:
                # explicit None check: 0.0 is a legitimate monotonic stamp
                last = self._tip_changed if self._tip_changed is not None else now
                stalled_for = now - last
                if stalled_for > self.stall_seconds:
                    alarms["consensus_stall"] = (
                        f"tip {tip} unchanged for {stalled_for:.1f}s "
                        f"(bound {self.stall_seconds:g}s)"
                    )
                rs = getattr(cs, "rs", None)
                if rs is not None and getattr(rs, "round", 0) >= self.round_churn:
                    alarms["round_churn"] = (
                        f"height {getattr(rs, 'height', '?')} at round {rs.round} "
                        f"(bound {self.round_churn})"
                    )

        # peer collapse (relative to this node's own peak)
        sw = getattr(node, "switch", None)
        if sw is not None:
            try:
                n_peers = sw.num_peers()
            except Exception:  # switch mid-teardown
                n_peers = None
            if n_peers is not None:
                self._peer_peak = max(self._peer_peak, n_peers)
                if self._peer_peak >= self.min_peers and n_peers * 2 < self._peer_peak:
                    alarms["peer_collapse"] = (
                        f"{n_peers} peers, down from peak {self._peer_peak}"
                    )
            # link backpressure telemetry: per-peer per-channel send-queue
            # occupancy, published from the live MConnection channels — the
            # backed-up queue that PRECEDES a gossip stall, which the
            # connection-count detector above cannot see
            try:
                self._publish_link_telemetry(sw)
            except Exception:  # noqa: BLE001 — switch/peer mid-teardown
                pass

        # verify-engine queue stall (pending timestamps are loop.time())
        av = getattr(node, "async_verifier", None)
        pending = getattr(av, "_pending", None) if av is not None else None
        if pending:
            try:
                age = asyncio.get_event_loop().time() - pending[0][4]
            except RuntimeError:  # no loop (sync test context)
                age = 0.0
            if age > self.verify_stall_seconds:
                alarms["verify_stall"] = (
                    f"oldest of {len(pending)} pending verifies waited {age:.1f}s "
                    f"(bound {self.verify_stall_seconds:g}s)"
                )

        # event-loop lag: two consecutive probe breaches = wedged, one =
        # a burst (startup compile, GC storm) that should not flap alarms
        prof = getattr(node, "loop_profiler", None)
        if prof is not None and getattr(prof, "lag_samples", 0) > 0:
            if prof.last_lag_ms > self.lag_ms:
                self._lag_breaches += 1
            else:
                self._lag_breaches = 0
            if self._lag_breaches >= 2:
                alarms["loop_lag"] = (
                    f"loop lag {prof.last_lag_ms:.0f}ms over "
                    f"{self.lag_ms:g}ms on {self._lag_breaches} probes"
                )

        # mempool saturation
        mp = getattr(node, "mempool", None)
        if mp is not None:
            cap = getattr(mp, "size_limit", 0)
            if cap > 0:
                size = mp.size()
                if size >= self.mempool_ratio * cap:
                    alarms["mempool_saturation"] = (
                        f"{size}/{cap} txs ({100 * size / cap:.0f}% of cap)"
                    )

        # ingress shedding: sustained explicit overload rejections.  The
        # QoS layer shedding correctly is still a node that cannot serve
        # its offered load — a load balancer should know.  Rate over the
        # tick window, two consecutive breaches (one burst from a single
        # misbehaving client should not flap the fleet's health).
        core = getattr(getattr(node, "rpc_server", None), "core", None)
        total = getattr(core, "throttled_total", None) if core is not None else None
        if total is not None:
            if self._shed_last is not None:
                d_count = total - self._shed_last[0]
                d_t = now - self._shed_last[1]
                rate = d_count / d_t if d_t > 0 else 0.0
                if self.shed_rate > 0 and rate > self.shed_rate:
                    self._shed_breaches += 1
                else:
                    self._shed_breaches = 0
                if self._shed_breaches >= 2:
                    alarms["ingress_shedding"] = (
                        f"rejecting {rate:.0f} req/s with overload errors "
                        f"(bound {self.shed_rate:g}/s)"
                    )
            self._shed_last = (total, now)

        # disk faults: sticky while a component is HALTED on persistence
        # (only a restart clears that), else held disk_fault_hold seconds
        # past the last write error / detected corruption so a single
        # transient EIO is visible for at least a scrape or two without
        # alarming forever.  disk_pressure fires on low free space BEFORE
        # the first ENOSPC — the operator's head start.
        sh = getattr(node, "storage_health", None)
        if sh is not None:
            if sh.halts:
                comp, reason = next(iter(sh.halts.items()))
                alarms["disk_fault"] = f"{comp} halted: {reason}"
            elif (
                sh.last_error is not None
                and now - sh.last_error["mono"] < self.disk_fault_hold
            ):
                alarms["disk_fault"] = (
                    f"{sh.total_faults()} storage fault(s), last on "
                    f"{sh.last_error['store']}: {sh.last_error['err']}"
                )
            free = sh.free_bytes()
            if (
                free is not None
                and self.disk_free_bytes > 0
                and free < self.disk_free_bytes
            ):
                alarms["disk_pressure"] = (
                    f"{free / 1e6:.0f} MB free on data dir "
                    f"(bound {self.disk_free_bytes / 1e6:.0f} MB)"
                )

        # wall-vs-monotonic clock drift, read through consensus' clock so
        # injected skew is visible exactly where consensus would sign it
        clock = getattr(cs, "clock", None) if cs is not None else None
        if clock is not None:
            base_ns = clock.time_ns() - time.monotonic_ns()
            if self._drift_base_ns is None:
                self._drift_base_ns = base_ns
            drift_s = (base_ns - self._drift_base_ns) / 1e9
            if abs(drift_s) > self.clock_drift_seconds:
                alarms["clock_drift"] = (
                    f"wall clock drifted {drift_s:+.2f}s from monotonic "
                    f"(bound ±{self.clock_drift_seconds:g}s)"
                )

        self._apply(alarms, now)
        return self.health(now)

    def _publish_link_telemetry(self, sw) -> None:
        """Export each peer's per-channel send-queue occupancy as
        `tendermint_p2p_peer_send_queue_depth` (frames) and
        `tendermint_p2p_peer_pending_send_bytes` (queued + in-flight
        bytes), labeled like the existing byte counters.  Gauges for a
        departed peer simply stop updating (the scrape shows the last
        value until restart — same staleness story as the reference's
        per-peer counters)."""
        p2p = getattr(getattr(self.node, "metrics_provider", None), "p2p", None)
        if p2p is None:
            return
        for peer in list(getattr(sw, "peers", {}).values()):
            mconn = getattr(peer, "mconn", None)
            if mconn is None:
                continue
            for chan_id, ch in mconn.channels.items():
                labels = {"peer_id": peer.id, "chID": str(chan_id)}
                p2p.peer_send_queue_depth.labels(**labels).set(
                    ch.send_queue.qsize()
                )
                # queued full frames plus the partially-sent remainder —
                # the byte-accurate backlog the flow scheduler is draining
                pending = len(ch.sending) + sum(
                    len(m) for m in ch.send_queue._queue
                )
                p2p.peer_pending_send_bytes.labels(**labels).set(pending)

    # -- transitions -------------------------------------------------------

    def _apply(self, alarms: Dict[str, str], now: float) -> None:
        for name, reason in alarms.items():
            if name not in self.active:
                sev = ALARM_SEVERITY.get(name, "degraded")
                self.active[name] = {"severity": sev, "reason": reason, "since": now}
                self.recorder.record(
                    "health.alarm", alarm=name, severity=sev, reason=reason
                )
                self.metrics.alarms.labels(alarm=name).inc()
                self.metrics.alarm.labels(alarm=name).set(1)
                self.log.warn("health alarm", alarm=name, reason=reason)
            else:
                self.active[name]["reason"] = reason
        for name in [n for n in self.active if n not in alarms]:
            held = now - self.active[name]["since"]
            del self.active[name]
            self.recorder.record("health.clear", alarm=name, held_s=round(held, 1))
            self.metrics.alarm.labels(alarm=name).set(0)
            self.log.info("health alarm cleared", alarm=name)
        prev = self.verdict
        if any(a["severity"] == "critical" for a in self.active.values()):
            self.verdict = "critical"
        elif self.active:
            self.verdict = "degraded"
        else:
            self.verdict = "ok"
        self.metrics.verdict.set(VERDICT_LEVEL[self.verdict])
        self.metrics.recorder_dropped.set(getattr(self.recorder, "dropped", 0))
        if self.verdict == "critical" and prev != "critical":
            self._maybe_autodump(now)

    def _maybe_autodump(self, now: float) -> None:
        if self.autodump_fn is None:
            return
        if (
            self._last_autodump is not None
            and now - self._last_autodump < self.autodump_min_interval
        ):
            return  # rate bound: a flapping critical must not fill the disk
        self._last_autodump = now
        health = self.health(now)

        def _write() -> None:
            try:
                path = self.autodump_fn(health)
                self.autodumps += 1
                if path:
                    self.log.warn("forensics auto-bundle written", path=path)
            except Exception as e:  # noqa: BLE001 — diagnosis must not kill the node
                self.log.error("forensics auto-bundle failed", err=repr(e))

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            _write()  # sync context (tests drive check() directly)
            return
        # off the event loop: serializing + gzipping the full recorder
        # snapshot costs tens of ms of blocking I/O — exactly what a node
        # that just turned CRITICAL cannot afford (it would even trip the
        # loop_lag detector with evidence-capture of its own making)
        loop.run_in_executor(None, _write)

    # -- the served surface ------------------------------------------------

    def health(self, now: Optional[float] = None) -> dict:
        """The `/health` payload: aggregate verdict + active alarms with
        severity, operator-readable reason and how long each has held."""
        if now is None:
            now = time.monotonic()
        return {
            "verdict": self.verdict,
            "ok": self.verdict == "ok",
            "alarms": {
                name: {
                    "severity": a["severity"],
                    "reason": a["reason"],
                    "for_s": round(max(0.0, now - a["since"]), 1),
                }
                for name, a in self.active.items()
            },
            "ticks": self.ticks,
        }


def write_autodump_bundle(node, health: dict, out_dir: str) -> str:
    """The critical-transition forensics snapshot: recorder dump, health
    state and a compact round-state summary tarred under `out_dir` —
    built from live in-process objects (no RPC round trip; the node may
    be exactly too wedged to serve one).  The on-disk flight spool (when
    enabled) already persists independently; `debug dump` picks both up."""
    import io
    import json
    import os
    import tarfile

    os.makedirs(out_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    path = os.path.join(out_dir, f"auto_{stamp}_{int(time.monotonic_ns() % 1000)}.tar.gz")
    sections = {"health.json": health}
    rec = getattr(node, "flight_recorder", None)
    if rec is not None:
        sections["recorder.json"] = rec.snapshot()
    cs = getattr(node, "consensus", None)
    rs = getattr(cs, "rs", None) if cs is not None else None
    if rs is not None:
        sections["consensus.json"] = {
            "height": getattr(rs, "height", None),
            "round": getattr(rs, "round", None),
            "step": str(getattr(rs, "step", "")),
        }
    with tarfile.open(path, "w:gz") as tar:
        for name, obj in sections.items():
            data = json.dumps(obj, default=repr).encode()
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(data))
    return path
