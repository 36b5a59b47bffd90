"""The port's health watchdog (tendermint_tpu_torch/libs/watchdog.py)
against the JAX package's: each detector's transitions on stub nodes with
an explicit monotonic `now`, the clock discipline under a SkewedClock,
the severity table, the rate-bounded autodump and the autodump bundle.

Each scenario drives both packages' Watchdog through the same sequence of
checks and returns every health dict; the two sequences must be equal
(reasons, severities, `for_s` and verdicts: tolerance exact), and the
port's must show the transitions the scenario is about.
"""

import asyncio
import os
import tarfile
import types

import pytest

from tendermint_tpu.chaos import clock as jclock
from tendermint_tpu.libs import tracing as jtracing
from tendermint_tpu.libs import watchdog as jwatchdog
from tendermint_tpu_torch.chaos import clock as pclock
from tendermint_tpu_torch.libs import tracing as ptracing
from tendermint_tpu_torch.libs import watchdog as pwatchdog

JAX = types.SimpleNamespace(clock=jclock, tracing=jtracing, wd=jwatchdog)
PORT = types.SimpleNamespace(clock=pclock, tracing=ptracing, wd=pwatchdog)


class _BlockStore:
    def __init__(self, h=1):
        self.h = h

    def height(self):
        return self.h


class _CS:
    def __init__(self, clock):
        self.is_running = True
        self.rs = types.SimpleNamespace(height=1, round=0)
        self.clock = clock


class _Switch:
    def __init__(self, n=0):
        self.n = n

    def num_peers(self):
        return self.n


class _Mempool:
    def __init__(self, size=0, cap=100):
        self._size = size
        self.size_limit = cap

    def size(self):
        return self._size


def _node(pkg):
    """The exact surface the watchdog probes, nothing else."""
    return types.SimpleNamespace(
        consensus=_CS(pkg.clock.Clock()), block_store=_BlockStore(), switch=None,
        async_verifier=None, loop_profiler=None, mempool=None, statesync_reactor=None,
        blockchain_reactor=None)


def stall(pkg, trace):
    node = _node(pkg)
    rec = pkg.tracing.FlightRecorder(size=128)
    wd = pkg.wd.Watchdog(node, stall_seconds=5.0, recorder=rec)
    for now in (1000.0, 1004.9, 1005.1):
        trace.append(wd.check(now=now))
    node.block_store.h = 2
    trace.append(wd.check(now=1006.0))
    trace.append([(e["kind"], e.get("alarm")) for e in rec.events()])


def stall_idle_wait_for_txs(pkg, trace):
    node = _node(pkg)
    node.consensus.config = types.SimpleNamespace(wait_for_txs=lambda: True)
    node.mempool = _Mempool(size=0, cap=100)
    wd = pkg.wd.Watchdog(node, stall_seconds=5.0)
    trace += [wd.check(now=0.0), wd.check(now=600.0)]
    node.mempool._size = 1  # a tx lands: the stall clock starts now
    trace += [wd.check(now=601.0), wd.check(now=605.0), wd.check(now=607.0)]


def stall_while_syncing(pkg, trace):
    node = _node(pkg)
    node.blockchain_reactor = types.SimpleNamespace(fast_sync=True, wait_statesync=False)
    wd = pkg.wd.Watchdog(node, stall_seconds=1.0)
    trace += [wd.check(now=0.0), wd.check(now=100.0)]


def round_churn(pkg, trace):
    node = _node(pkg)
    wd = pkg.wd.Watchdog(node, stall_seconds=1e9, round_churn=4)
    node.consensus.rs.round = 3
    trace.append(wd.check(now=1.0))
    node.consensus.rs.round = 4
    trace.append(wd.check(now=2.0))


def peer_collapse(pkg, trace):
    node = _node(pkg)
    node.switch = _Switch(0)
    wd = pkg.wd.Watchdog(node, stall_seconds=1e9, min_peers=2)
    for now, n in ((1.0, 0), (2.0, 6), (3.0, 3), (4.0, 2), (5.0, 5)):
        node.switch.n = n
        trace.append(wd.check(now=now))


def mempool_saturation(pkg, trace):
    node = _node(pkg)
    node.mempool = _Mempool(size=89, cap=100)
    wd = pkg.wd.Watchdog(node, stall_seconds=1e9, mempool_ratio=0.9)
    for now, size in ((1.0, 89), (2.0, 90), (3.0, 10)):
        node.mempool._size = size
        trace.append(wd.check(now=now))


def loop_lag(pkg, trace):
    node = _node(pkg)
    node.loop_profiler = types.SimpleNamespace(lag_samples=1, last_lag_ms=0.0)
    wd = pkg.wd.Watchdog(node, stall_seconds=1e9, lag_ms=100.0)
    for now, lag in ((1.0, 500.0), (2.0, 40.0), (3.0, 500.0), (4.0, 500.0), (5.0, 10.0)):
        node.loop_profiler.last_lag_ms = lag
        trace.append(wd.check(now=now))


def ingress_shedding(pkg, trace):
    node = _node(pkg)
    core = types.SimpleNamespace(throttled_total=0)
    node.rpc_server = types.SimpleNamespace(core=core)
    wd = pkg.wd.Watchdog(node, stall_seconds=1e9, shed_rate=5.0)
    for now, total in ((0.0, 0), (1.0, 100), (2.0, 200), (3.0, 201), (4.0, 203), (5.0, 205)):
        core.throttled_total = total
        trace.append(wd.check(now=now))


def disk_fault_and_pressure(pkg, trace):
    node = _node(pkg)
    node.storage_health = pkg.wd.StorageHealth()
    wd = pkg.wd.Watchdog(node, stall_seconds=1e9, disk_fault_hold=30.0)
    trace.append(wd.check(now=1.0))
    node.storage_health.note_corruption("blockstore", "crc mismatch")
    node.storage_health.last_error["mono"] = 2.0  # the fault's monotonic stamp
    trace += [wd.check(now=3.0), wd.check(now=40.0)]
    node.storage_health.note_halt("wal", "ENOSPC")
    trace.append(wd.check(now=41.0))
    node.storage_health.free_bytes = lambda: 1 << 20  # 1 MB left
    node.storage_health.halts.clear()
    trace.append(wd.check(now=42.0))


def constant_skew(pkg, trace):
    node = _node(pkg)
    node.consensus.clock = pkg.clock.SkewedClock(3600.0)  # an hour wrong since boot
    wd = pkg.wd.Watchdog(node, stall_seconds=1e9, clock_drift_seconds=2.0)
    trace += [wd.check(now=float(i)) for i in range(5)]


def skew_step(pkg, trace):
    node = _node(pkg)
    clock = pkg.clock.SkewedClock(0.0)
    node.consensus.clock = clock
    wd = pkg.wd.Watchdog(node, stall_seconds=1e9, clock_drift_seconds=2.0)
    trace.append(sorted(wd.check(now=0.0)["alarms"]))
    clock.set_skew(5.0)  # the clock moved under a running node
    h = wd.check(now=1.0)
    trace.append((sorted(h["alarms"]), h["verdict"]))
    clock.set_skew(0.0)
    trace.append(sorted(wd.check(now=2.0)["alarms"]))


def skew_cannot_fake_a_stall(pkg, trace):
    node = _node(pkg)
    node.consensus.clock = pkg.clock.SkewedClock(-86400.0)
    wd = pkg.wd.Watchdog(node, stall_seconds=5.0, clock_drift_seconds=1e18)
    trace.append(wd.check(now=0.0))
    node.block_store.h += 1
    trace.append(wd.check(now=4.0))
    node.consensus.clock.set_skew(86400.0)
    trace += [wd.check(now=8.9), wd.check(now=9.2)]


def autodump_rate_bound(pkg, trace):
    node = _node(pkg)
    dumps = []
    wd = pkg.wd.Watchdog(node, stall_seconds=5.0, autodump_min_interval=60.0,
                         autodump_fn=lambda health: dumps.append(health) or "x")
    for now in (0.0, 6.0):
        trace.append(wd.check(now=now))
    node.block_store.h += 1
    trace += [wd.check(now=7.0), wd.check(now=20.0)]
    node.block_store.h += 1
    trace += [wd.check(now=21.0), wd.check(now=90.0)]
    trace.append(dumps)


def autodump_failure(pkg, trace):
    node = _node(pkg)

    def boom(health):
        raise OSError("disk full")

    wd = pkg.wd.Watchdog(node, stall_seconds=5.0, autodump_fn=boom)
    trace += [wd.check(now=0.0), wd.check(now=6.0), wd.autodumps]


SCENARIOS = {f.__name__: f for f in (
    stall, stall_idle_wait_for_txs, stall_while_syncing, round_churn, peer_collapse,
    mempool_saturation, loop_lag, ingress_shedding, disk_fault_and_pressure, constant_skew,
    skew_step, skew_cannot_fake_a_stall, autodump_rate_bound, autodump_failure)}


def _verdicts(trace):
    return [(h["verdict"], sorted(h["alarms"])) for h in trace if isinstance(h, dict)]


EXPECTED = {
    "stall": [("ok", []), ("ok", []), ("critical", ["consensus_stall"]), ("ok", [])],
    "stall_idle_wait_for_txs": [("ok", [])] * 4 + [("critical", ["consensus_stall"])],
    "stall_while_syncing": [("ok", [])] * 2,
    "round_churn": [("ok", []), ("degraded", ["round_churn"])],
    "peer_collapse": [("ok", [])] * 3 + [("degraded", ["peer_collapse"]), ("ok", [])],
    "mempool_saturation": [("ok", []), ("degraded", ["mempool_saturation"]), ("ok", [])],
    "loop_lag": [("ok", [])] * 3 + [("degraded", ["loop_lag"]), ("ok", [])],
    "ingress_shedding": [("ok", [])] * 2 + [("degraded", ["ingress_shedding"])]
    + [("ok", [])] * 3,
    "disk_fault_and_pressure": [("ok", []), ("critical", ["disk_fault"]), ("ok", []),
                                ("critical", ["disk_fault"]), ("degraded", ["disk_pressure"])],
    "constant_skew": [("ok", [])] * 5,
    "skew_cannot_fake_a_stall": [("ok", [])] * 3 + [("critical", ["consensus_stall"])],
    "autodump_rate_bound": [("ok", []), ("critical", ["consensus_stall"]), ("ok", []),
                            ("critical", ["consensus_stall"]), ("ok", []),
                            ("critical", ["consensus_stall"])],
    "autodump_failure": [("ok", []), ("critical", ["consensus_stall"])],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_detector_transitions_equal_jax(name):
    traces = {}
    for label, pkg in (("jax", JAX), ("port", PORT)):
        trace = []
        SCENARIOS[name](pkg, trace)
        traces[label] = trace
    assert traces["port"] == traces["jax"]
    port = traces["port"]
    if name in EXPECTED:
        assert _verdicts(port) == EXPECTED[name]
    if name == "stall":
        assert port[-1] == [("health.alarm", "consensus_stall"),
                            ("health.clear", "consensus_stall")]
    if name == "skew_step":
        assert port == [[], (["clock_drift"], "degraded"), []]
    if name == "autodump_rate_bound":
        assert [d["verdict"] for d in port[-1]] == ["critical", "critical"]
    if name == "autodump_failure":
        assert port[-1] == 0


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
async def test_verify_stall_from_pending_queue_age(pkg):
    node = _node(pkg)
    loop = asyncio.get_event_loop()
    # the AsyncBatchVerifier's pending tuple: (pubkey, msg, sig, future, t_enqueued)
    node.async_verifier = types.SimpleNamespace(
        _pending=[(b"", b"", b"", None, loop.time() - 10.0)])
    wd = pkg.wd.Watchdog(node, stall_seconds=1e9, verify_stall_seconds=5.0)
    h = wd.check(now=1.0)
    assert (h["verdict"], sorted(h["alarms"])) == ("critical", ["verify_stall"])
    node.async_verifier._pending = []
    assert wd.check(now=2.0)["verdict"] == "ok"


def test_severity_table_equals_jax():
    assert pwatchdog.ALARM_SEVERITY == jwatchdog.ALARM_SEVERITY
    assert pwatchdog.VERDICT_LEVEL == jwatchdog.VERDICT_LEVEL
    assert {a for a, s in pwatchdog.ALARM_SEVERITY.items() if s == "critical"} == {
        "consensus_stall", "verify_stall", "disk_fault"}


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_write_autodump_bundle_contents(pkg, tmp_path):
    node = _node(pkg)
    node.consensus.rs.round = 2
    node.flight_recorder = pkg.tracing.FlightRecorder(size=32)
    node.flight_recorder.record("step", height=1, step="Propose")
    path = pkg.wd.write_autodump_bundle(node, {"verdict": "critical"}, str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path) and path.endswith(".tar.gz")
    with tarfile.open(path) as tar:
        files = {os.path.basename(m.name): tar.extractfile(m).read() for m in tar.getmembers()}
    assert set(files) == {"health.json", "recorder.json", "consensus.json"}
    assert files["health.json"] == b'{"verdict": "critical"}'
    assert files["consensus.json"] == b'{"height": 1, "round": 2, "step": ""}'
