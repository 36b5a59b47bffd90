"""Prometheus metrics, per subsystem, and the node's MetricsProvider (the
port's copy of tendermint_tpu/libs/metrics.py, same metric names).

Without a registry every metric is a no-op.  `prometheus_client` is
imported only when a registry is passed (a provider built enabled), so the
node runs where that package is not installed.  The /metrics listener
(MetricsServer) serves the exposition over the port's rpc/http.py.
"""

from __future__ import annotations

from typing import Optional

NAMESPACE = "tendermint"


class _Nop:
    """Accepts the whole prometheus surface and does nothing."""

    def labels(self, *a, **k):
        return self

    def set(self, *a):
        pass

    def inc(self, *a):
        pass

    def dec(self, *a):
        pass

    def observe(self, *a):
        pass


_NOP = _Nop()


class _BoundLabels:
    """Partially-bound labeled metric: fixes some label values (chain_id)
    so call sites only supply their own dimension (category, queue) —
    prometheus_client's .labels() demands every label at once."""

    def __init__(self, metric, **bound):
        self._metric = metric
        self._bound = bound

    def labels(self, **kw):
        return self._metric.labels(**self._bound, **kw)




class _ObservableGauge:
    """Gauge with an `observe` alias — callers use histogram-style
    .observe() while the exposed series stays a plain gauge, matching the
    reference's go-kit Gauge semantics for e.g. block_interval_seconds."""

    def __init__(self, gauge):
        self._g = gauge

    def observe(self, v) -> None:
        self._g.set(v)

    def set(self, v) -> None:
        self._g.set(v)


class ConsensusMetrics:
    """consensus/metrics.go:18."""

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            for name in (
                "height", "rounds", "validators", "validators_power",
                "missing_validators", "missing_validators_power",
                "byzantine_validators", "byzantine_validators_power",
                "block_interval_seconds", "num_txs", "block_size_bytes",
                "total_txs", "committed_height", "fast_syncing", "block_parts",
                "gossip_wakeups", "vote_batch_size", "parts_per_burst",
                "vote_summaries", "vote_pulls", "trace_clamps",
            ):
                setattr(self, name, _NOP)
            return
        from prometheus_client import Gauge, Histogram

        sub = "consensus"
        kw = dict(namespace=NAMESPACE, subsystem=sub, registry=registry,
                  labelnames=("chain_id",))

        def g(name, doc):
            return Gauge(name, doc, **kw).labels(chain_id=chain_id)

        self.height = g("height", "Height of the chain.")
        self.rounds = g("rounds", "Number of rounds.")
        self.validators = g("validators", "Number of validators.")
        self.validators_power = g("validators_power", "Total power of all validators.")
        self.missing_validators = g("missing_validators", "Number of validators who did not sign.")
        self.missing_validators_power = g(
            "missing_validators_power", "Total power of the missing validators."
        )
        self.byzantine_validators = g(
            "byzantine_validators", "Number of validators who tried to double sign."
        )
        self.byzantine_validators_power = g(
            "byzantine_validators_power", "Total power of the byzantine validators."
        )
        # Gauge in the reference too (consensus/metrics.go:46, v0.33.x);
        # a python Histogram would also rename the series (_bucket/_count)
        self.block_interval_seconds = _ObservableGauge(
            g("block_interval_seconds", "Time between this and the last block.")
        )
        self.num_txs = g("num_txs", "Number of transactions.")
        self.block_size_bytes = g("block_size_bytes", "Size of the block.")
        self.total_txs = g("total_txs", "Total number of transactions.")
        self.committed_height = g("latest_block_height", "The latest block height.")
        self.fast_syncing = g("fast_syncing", "Whether or not a node is fast syncing. 1 if yes, 0 if no.")
        # counters modeled as Gauges: prometheus_client appends `_total` to
        # Counter names, which would break the reference's exact series name
        self.block_parts = Gauge(
            "block_parts", "Number of blockparts transmitted by peer.",
            namespace=NAMESPACE, subsystem=sub, registry=registry,
            labelnames=("chain_id", "peer_id"),
        )
        # Event-driven gossip series (no reference counterpart — the
        # reference's gossip is a poll loop with nothing to count).
        # Counter-like Gauge, same convention as above (no `_total` rename).
        self.gossip_wakeups = g(
            "gossip_wakeups",
            "Gossip routine wakeups triggered by consensus events "
            "(vs the fixed-sleep fallback).",
        )
        self.vote_batch_size = Histogram(
            "vote_batch_size", "Votes per sent vote_batch gossip frame.",
            namespace=NAMESPACE, subsystem=sub, registry=registry,
            labelnames=("chain_id",), buckets=[2**i for i in range(0, 14)],
        ).labels(chain_id=chain_id)
        self.parts_per_burst = Histogram(
            "parts_per_burst", "Block parts sent per gossip wakeup burst.",
            namespace=NAMESPACE, subsystem=sub, registry=registry,
            labelnames=("chain_id",), buckets=[1, 2, 4, 8, 16, 32, 64],
        ).labels(chain_id=chain_id)
        # maj23 aggregation exchange (relay topology, gossip_version >= 2)
        self.vote_summaries = g(
            "vote_summaries",
            "have-maj23 vote summaries sent instead of streaming votes.",
        )
        self.vote_pulls = g(
            "vote_pulls",
            "vote_pull requests served with a targeted vote_batch.",
        )
        # wire-level trace context (gossip_version >= 3): received frames
        # whose hop count / origin timestamp failed the sanity clamps —
        # byzantine or badly skewed senders; the sample is discarded from
        # skew estimation, so this series is the only place it shows up
        self.trace_clamps = g(
            "trace_clamps",
            "Received trace-context fields clamped as implausible "
            "(hop out of range or origin timestamp outside the sanity window).",
        )


class VerifyMetrics:
    """The batch-verify engine (subsystem `verify`): batch sizes, queue
    wait, host-prep vs device split, the adaptive flush quantum, background
    kernel builds, table-cache hit rate, and the JAX package's remaining
    gauges under the same names."""

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            for name in (
                "batch_size", "queue_wait_seconds", "host_prep_seconds",
                "device_seconds", "flush_quantum_seconds", "bucket_compiles",
                "table_cache_hits", "table_cache_misses", "table_rebuilds",
                "backend_tier",
                "shards", "bls_agg_seconds", "bls_agg_checks", "bls_tier",
            ):
                setattr(self, name, _NOP)
            return
        from prometheus_client import Counter, Gauge, Histogram

        sub = "verify"
        kw = dict(namespace=NAMESPACE, subsystem=sub, registry=registry,
                  labelnames=("chain_id",))

        def h(name, doc, buckets):
            return Histogram(name, doc, buckets=buckets, **kw).labels(chain_id=chain_id)

        def g(name, doc):
            return Gauge(name, doc, **kw).labels(chain_id=chain_id)

        def c(name, doc):
            return Counter(name, doc, **kw).labels(chain_id=chain_id)

        self.batch_size = h(
            "batch_size", "Signatures per verify dispatch.",
            [2**i for i in range(0, 14)],
        )
        time_buckets = [1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                        2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0]
        self.queue_wait_seconds = h(
            "queue_wait_seconds",
            "Oldest enqueue-to-flush wait per batcher flush.", time_buckets,
        )
        self.host_prep_seconds = h(
            "host_prep_seconds", "Host prep (hash/reduce/pack) per batch.",
            time_buckets,
        )
        self.device_seconds = h(
            "device_seconds", "Device dispatch + fetch per batch.", time_buckets,
        )
        self.flush_quantum_seconds = g(
            "flush_quantum_seconds",
            "Current adaptive coalescing window of the vote batcher.",
        )
        self.bucket_compiles = c(
            "bucket_compiles", "Background builds of the CUDA kernel library."
        )
        self.table_cache_hits = c(
            "table_cache_hits", "Indexed verifies served from a cached pubkey table."
        )
        self.table_cache_misses = c(
            "table_cache_misses", "Indexed verifies that had to build (or decline to) a table."
        )
        self.table_rebuilds = c(
            "table_rebuilds",
            "Proactive pubkey-table (re)builds triggered by validator-set updates.",
        )
        self.backend_tier = g(
            "backend_tier",
            "Active host crypto backend: 1=cryptography, 2=C extension, 3=pure python.",
        )
        self.shards = g(
            "shards",
            "Devices the verify batch axis is sharded over (1 = single device).",
        )
        self.bls_agg_seconds = h(
            "bls_agg_seconds",
            "Wall time per BLS aggregate-commit pairing batch.", time_buckets,
        )
        self.bls_agg_checks = c(
            "bls_agg_checks", "Aggregate-commit claims verified (pairing or memo)."
        )
        self.bls_tier = g(
            "bls_tier",
            "Active BLS pairing tier: 1=C extension, 2=pure python reference.",
        )


class MempoolMetrics:
    """mempool/metrics.go + the priority-QoS series (no reference
    counterpart: the reference mempool has no priority lane to observe).
    `priority_evicted` counts txs displaced by better-paying arrivals when
    the pool is full; `priority_floor` is the priority of the most recent
    eviction victim — the going rate a tx must beat to enter a full pool."""

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            self.size = _NOP
            self.tx_size_bytes = _NOP
            self.failed_txs = _NOP
            self.recheck_times = _NOP
            self.priority_evicted = _NOP
            self.priority_floor = _NOP
            return
        from prometheus_client import Counter, Gauge, Histogram

        sub = "mempool"
        kw = dict(namespace=NAMESPACE, subsystem=sub, registry=registry,
                  labelnames=("chain_id",))
        self.size = Gauge("size", "Size of the mempool (number of uncommitted transactions).", **kw).labels(chain_id=chain_id)
        self.tx_size_bytes = Histogram(
            "tx_size_bytes", "Transaction sizes in bytes.",
            namespace=NAMESPACE, subsystem=sub, registry=registry,
            labelnames=("chain_id",), buckets=[2**i for i in range(4, 21)],
        ).labels(chain_id=chain_id)
        # Gauges (not Counters) to keep the reference's exact series names —
        # prometheus_client appends `_total` to Counter names
        self.failed_txs = Gauge("failed_txs", "Number of failed transactions.", **kw).labels(chain_id=chain_id)
        self.recheck_times = Gauge("recheck_times", "Number of times transactions are rechecked in the mempool.", **kw).labels(chain_id=chain_id)
        # tendermint_mempool_priority_evicted_total / _priority_floor
        self.priority_evicted = Counter(
            "priority_evicted",
            "Txs evicted from a full mempool to admit a higher-priority tx.",
            **kw,
        ).labels(chain_id=chain_id)
        self.priority_floor = Gauge(
            "priority_floor",
            "Priority of the most recent eviction victim (the bar a tx "
            "must clear to enter a full pool).",
            **kw,
        ).labels(chain_id=chain_id)


class StateMetrics:
    """state/metrics.go."""

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            self.block_processing_time = _NOP
            self.valset_updates = _NOP
            self.valset_size = _NOP
            return
        from prometheus_client import Counter, Gauge, Histogram

        self.block_processing_time = Histogram(
            "block_processing_time", "Time between BeginBlock and EndBlock in ms.",
            namespace=NAMESPACE, subsystem="state", registry=registry,
            labelnames=("chain_id",), buckets=[1 * i for i in range(1, 11)] + [20, 50, 100, 500],
        ).labels(chain_id=chain_id)
        kw = dict(namespace=NAMESPACE, subsystem="state", registry=registry,
                  labelnames=("chain_id",))
        self.valset_updates = Counter(
            "valset_updates",
            "ABCI validator-set update events applied (end_block → update_state).",
            **kw,
        ).labels(chain_id=chain_id)
        self.valset_size = Gauge(
            "valset_size", "Validators in the upcoming (next) validator set.", **kw
        ).labels(chain_id=chain_id)


class EvidenceMetrics:
    """Evidence pool observability (subsystem `evidence`; the reference
    has none — its pool is invisible).  `pending` tracks the number of
    uncommitted evidence items in the pool; `committed` counts evidence
    that made it into a block (the accountability pipeline's terminal
    proof) — exposed as `tendermint_evidence_committed_total`."""

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            self.pending = _NOP
            self.committed = _NOP
            return
        from prometheus_client import Counter, Gauge

        kw = dict(namespace=NAMESPACE, subsystem="evidence", registry=registry,
                  labelnames=("chain_id",))
        self.pending = Gauge(
            "pending", "Uncommitted evidence items in the pool.", **kw
        ).labels(chain_id=chain_id)
        self.committed = Counter(
            "committed", "Evidence items committed into blocks.", **kw
        ).labels(chain_id=chain_id)


class P2PMetrics:
    """p2p/metrics.go."""

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            self.peers = _NOP
            self.peer_receive_bytes_total = _NOP
            self.peer_send_bytes_total = _NOP
            self.peer_pending_send_bytes = _NOP
            self.peer_send_queue_depth = _NOP
            return
        from prometheus_client import Counter, Gauge

        sub = "p2p"
        self.peers = Gauge(
            "peers", "Number of peers.", namespace=NAMESPACE, subsystem=sub,
            registry=registry, labelnames=("chain_id",),
        ).labels(chain_id=chain_id)
        self.peer_receive_bytes_total = Counter(
            "peer_receive_bytes_total", "Number of bytes received from a given peer.",
            namespace=NAMESPACE, subsystem=sub, registry=registry,
            labelnames=("chain_id", "peer_id", "chID"),
        )
        self.peer_send_bytes_total = Counter(
            "peer_send_bytes_total", "Number of bytes sent to a given peer.",
            namespace=NAMESPACE, subsystem=sub, registry=registry,
            labelnames=("chain_id", "peer_id", "chID"),
        )
        # Link-backpressure telemetry (no reference counterpart — the
        # reference exposes connection COUNT, not a backed-up queue, which
        # is the thing that actually precedes a gossip stall).  Published
        # by the watchdog tick from live MConnection channel queues;
        # `peer_pending_send_bytes` mirrors the reference's name for the
        # analogous mconn gauge so dashboards can converge on it.
        self.peer_pending_send_bytes = _BoundLabels(
            Gauge(
                "peer_pending_send_bytes",
                "Bytes sitting in a peer's per-channel send queue.",
                namespace=NAMESPACE, subsystem=sub, registry=registry,
                labelnames=("chain_id", "peer_id", "chID"),
            ),
            chain_id=chain_id,
        )
        self.peer_send_queue_depth = _BoundLabels(
            Gauge(
                "peer_send_queue_depth",
                "Frames queued (occupancy) in a peer's per-channel send queue.",
                namespace=NAMESPACE, subsystem=sub, registry=registry,
                labelnames=("chain_id", "peer_id", "chID"),
            ),
            chain_id=chain_id,
        )


class RPCMetrics:
    """RPC ingress admission control (subsystem `rpc`; no reference
    counterpart — the reference RPC server sheds nothing).  `throttled`
    counts EXPLICIT overload rejections by reason (rate | inflight |
    mempool_full | commit_waiters) — the `tendermint_rpc_throttled_total`
    series the load rig asserts is nonzero under a firehose; the gauges
    expose the two bounded queues admission control maintains."""

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            self.throttled = _NOP
            self.broadcast_inflight = _NOP
            self.commit_waiters = _NOP
            return
        from prometheus_client import Counter, Gauge

        sub = "rpc"
        self.throttled = _BoundLabels(
            Counter(
                "throttled",
                "Broadcast requests rejected with an explicit overload error.",
                namespace=NAMESPACE, subsystem=sub, registry=registry,
                labelnames=("chain_id", "reason"),
            ),
            chain_id=chain_id,
        )
        kw = dict(namespace=NAMESPACE, subsystem=sub, registry=registry,
                  labelnames=("chain_id",))
        self.broadcast_inflight = Gauge(
            "broadcast_inflight", "Broadcast CheckTx calls currently in flight.", **kw
        ).labels(chain_id=chain_id)
        self.commit_waiters = Gauge(
            "commit_waiters",
            "broadcast_tx_commit calls currently holding an event-bus subscription.",
            **kw,
        ).labels(chain_id=chain_id)


class LoopMetrics:
    """Asyncio scheduler profiler (subsystem `loop`; libs/loopprof.py —
    no reference counterpart: Go's preemptive scheduler has no shared
    cooperative loop to saturate).  Exposes the quantities that decide
    whether a slow net is loop-bound: scheduled-vs-actual wakeup lag,
    GC pause time, per-category task busy time and the depths of the
    known choke-point queues."""

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            self.lag_seconds = _NOP
            self.gc_pause_seconds = _NOP
            self.task_busy_seconds = _NOP
            self.queue_depth = _NOP
            return
        from prometheus_client import Gauge, Histogram

        sub = "loop"
        time_buckets = [1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                        2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5]
        self.lag_seconds = Histogram(
            "lag_seconds",
            "Scheduled-vs-actual wakeup delta of the loop-lag probe.",
            namespace=NAMESPACE, subsystem=sub, registry=registry,
            labelnames=("chain_id",), buckets=time_buckets,
        ).labels(chain_id=chain_id)
        self.gc_pause_seconds = Histogram(
            "gc_pause_seconds",
            "Garbage-collector pause time accumulated per probe interval.",
            namespace=NAMESPACE, subsystem=sub, registry=registry,
            labelnames=("chain_id",), buckets=time_buckets,
        ).labels(chain_id=chain_id)
        # labeled children resolved at use (.labels(category=...) /
        # .labels(queue=...)) with chain_id pre-bound
        self.task_busy_seconds = _BoundLabels(
            Gauge(
                "task_busy_seconds",
                "Cumulative on-CPU task time per attribution category.",
                namespace=NAMESPACE, subsystem=sub, registry=registry,
                labelnames=("chain_id", "category"),
            ),
            chain_id=chain_id,
        )
        self.queue_depth = _BoundLabels(
            Gauge(
                "queue_depth",
                "Sampled depth of a known choke-point queue.",
                namespace=NAMESPACE, subsystem=sub, registry=registry,
                labelnames=("chain_id", "queue"),
            ),
            chain_id=chain_id,
        )


class StateSyncMetrics:
    """Snapshot bootstrap (subsystem `statesync`): discovery and chunk
    transfer counters, restore-duration histogram, and the node's sync
    phase (2=statesync, 1=fastsync, 0=caught_up) — the `tendermint_
    statesync_*` series the statesync-smoke rig and dashboards read."""

    PHASE_CAUGHT_UP = 0
    PHASE_FASTSYNC = 1
    PHASE_STATESYNC = 2

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            for name in (
                "snapshots_discovered", "snapshots_offered", "chunks_fetched",
                "chunks_failed", "chunks_refetched", "restore_duration_seconds",
                "sync_phase",
            ):
                setattr(self, name, _NOP)
            return
        from prometheus_client import Counter, Gauge, Histogram

        kw = dict(namespace=NAMESPACE, subsystem="statesync", registry=registry,
                  labelnames=("chain_id",))

        def c(name, doc):
            return Counter(name, doc, **kw).labels(chain_id=chain_id)

        self.snapshots_discovered = c(
            "snapshots_discovered", "Distinct snapshots advertised by peers."
        )
        self.snapshots_offered = c(
            "snapshots_offered", "Snapshots offered to the local app."
        )
        self.chunks_fetched = c(
            "chunks_fetched", "Snapshot chunks fetched and hash-verified."
        )
        self.chunks_failed = c(
            "chunks_failed", "Snapshot chunks that failed hash verification."
        )
        self.chunks_refetched = c(
            "chunks_refetched", "Snapshot chunks refetched (bad hash, timeout or app retry)."
        )
        self.restore_duration_seconds = Histogram(
            "restore_duration_seconds",
            "Wall time from snapshot offer to verified restore.",
            buckets=[0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0],
            **kw,
        ).labels(chain_id=chain_id)
        self.sync_phase = Gauge(
            "sync_phase",
            "Current sync phase: 2=statesync, 1=fastsync, 0=caught_up.",
            **kw,
        ).labels(chain_id=chain_id)


class ChaosMetrics:
    """Fault-injection telemetry (subsystem `chaos`; only populated when
    `[chaos] enabled`).  The injected-fault counters make a chaos run
    diagnosable from the same scrape as production telemetry: a stalled
    net with `links_degraded` > 0 is a staged partition, with 0 it's a
    real bug."""

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            for name in (
                "links_degraded", "msgs_dropped", "msgs_delayed",
                "clock_skew_seconds", "twin_votes", "disk_faults",
            ):
                setattr(self, name, _NOP)
            return
        from prometheus_client import Counter, Gauge

        kw = dict(namespace=NAMESPACE, subsystem="chaos", registry=registry,
                  labelnames=("chain_id",))

        def g(name, doc):
            return Gauge(name, doc, **kw).labels(chain_id=chain_id)

        def c(name, doc):
            return Counter(name, doc, **kw).labels(chain_id=chain_id)

        self.links_degraded = g(
            "links_degraded", "Outbound links with an active fault policy."
        )
        self.msgs_dropped = c(
            "msgs_dropped", "Messages refused by an injected drop policy."
        )
        self.msgs_delayed = c(
            "msgs_delayed", "Messages delayed or throttled by a link policy."
        )
        self.clock_skew_seconds = g(
            "clock_skew_seconds", "Injected consensus wall-clock skew."
        )
        self.twin_votes = c(
            "twin_votes", "Conflicting votes signed by the twin double-signer."
        )
        self.disk_faults = _BoundLabels(
            Counter(
                "disk_faults",
                "Injected disk faults (chaos/disk.py) by kind.",
                namespace=NAMESPACE, subsystem="chaos", registry=registry,
                labelnames=("chain_id", "kind"),
            ),
            chain_id=chain_id,
        )


class StorageMetrics:
    """Store integrity + disk-fault telemetry (subsystem `storage`; no
    reference counterpart — goleveldb's CRCs are invisible to operators).
    `write_errors`/`corruptions` are counters per store name (blockstore,
    state, wal, mempool-wal, privval, sign, consensus); `quarantined` is
    the live count of block heights answering None pending a peer refill;
    `integrity_scan_seconds` is the last sweep's duration and `free_bytes`
    the data-dir headroom the disk_pressure alarm watches."""

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            for name in (
                "write_errors", "corruptions", "quarantined", "refills",
                "integrity_scan_seconds", "free_bytes",
            ):
                setattr(self, name, _NOP)
            return
        from prometheus_client import Counter, Gauge

        kw = dict(namespace=NAMESPACE, subsystem="storage", registry=registry)
        self.write_errors = _BoundLabels(
            Counter(
                "write_errors",
                "Persistence write/fsync failures (ENOSPC, EIO) by store.",
                labelnames=("chain_id", "store"), **kw,
            ),
            chain_id=chain_id,
        )
        self.corruptions = _BoundLabels(
            Counter(
                "corruptions",
                "Detected corrupt entries (seal/crc/hash mismatch) by store.",
                labelnames=("chain_id", "store"), **kw,
            ),
            chain_id=chain_id,
        )
        self.quarantined = Gauge(
            "quarantined_blocks",
            "Block heights quarantined as corrupt, pending peer refill.",
            labelnames=("chain_id",), **kw,
        ).labels(chain_id=chain_id)
        self.refills = Counter(
            "refills",
            "Quarantined blocks restored from verified peer copies.",
            labelnames=("chain_id",), **kw,
        ).labels(chain_id=chain_id)
        self.integrity_scan_seconds = Gauge(
            "integrity_scan_seconds",
            "Duration of the last block-store integrity scan.",
            labelnames=("chain_id",), **kw,
        ).labels(chain_id=chain_id)
        self.free_bytes = Gauge(
            "free_bytes",
            "Free bytes on the data directory's filesystem (watchdog probe).",
            labelnames=("chain_id",), **kw,
        ).labels(chain_id=chain_id)


class HealthMetrics:
    """Node self-diagnosis (subsystem `health`; libs/watchdog.py — no
    reference counterpart: the reference node cannot notice its own
    degradation).  `verdict` is the aggregate 0=ok / 1=degraded /
    2=critical the /health RPC route serves to load balancers; `alarm`
    is a 0/1 gauge per detector (consensus_stall, round_churn,
    peer_collapse, verify_stall, loop_lag, mempool_saturation,
    clock_drift); `alarms` counts raise transitions per detector
    (`tendermint_health_alarms_total`).  `recorder_dropped` exposes the
    flight recorder's ring-eviction count
    (`tendermint_recorder_dropped_total`) — silent span loss was only
    visible inside dump snapshots before."""

    def __init__(self, registry=None, chain_id: str = ""):
        if registry is None:
            self.verdict = _NOP
            self.alarm = _NOP
            self.alarms = _NOP
            self.recorder_dropped = _NOP
            return
        from prometheus_client import Counter, Gauge

        sub = "health"
        self.verdict = Gauge(
            "verdict", "Aggregate health verdict: 0=ok, 1=degraded, 2=critical.",
            namespace=NAMESPACE, subsystem=sub, registry=registry,
            labelnames=("chain_id",),
        ).labels(chain_id=chain_id)
        self.alarm = _BoundLabels(
            Gauge(
                "alarm", "Whether a watchdog detector is currently alarming (0/1).",
                namespace=NAMESPACE, subsystem=sub, registry=registry,
                labelnames=("chain_id", "alarm"),
            ),
            chain_id=chain_id,
        )
        self.alarms = _BoundLabels(
            Counter(
                "alarms", "Watchdog alarm raise transitions.",
                namespace=NAMESPACE, subsystem=sub, registry=registry,
                labelnames=("chain_id", "alarm"),
            ),
            chain_id=chain_id,
        )
        # different subsystem on purpose: the series belongs to the
        # recorder, the watchdog tick merely publishes it
        self.recorder_dropped = Gauge(
            "dropped_total",
            "Flight-recorder events evicted from the ring before any dump "
            "or spool flush read them.",
            namespace=NAMESPACE, subsystem="recorder", registry=registry,
            labelnames=("chain_id",),
        ).labels(chain_id=chain_id)


class LiteServeMetrics:
    """Multi-tenant light-client gateway (subsystem `liteserve`;
    liteserve/service.py — no reference counterpart: the reference light
    client is strictly single-tenant).  `cache_hits` / `cache_misses` /
    `coalesced_verifies` are the request-level shared-store counters the
    `lite_cache_hit_ratio` and `lite_verify_coalesce_ratio` bench keys
    derive from; `bisections_total` counts verification passes that
    actually walked the chain; `diverged_headers`, `witness_demotions`
    and `primary_replacements` expose the adversarial-primary recovery
    path (a nonzero `primary_replacements` in production is an incident,
    not noise)."""

    def __init__(self, registry=None, chain_id: str = ""):
        names = (
            "sessions", "cache_hits", "cache_misses", "coalesced_verifies",
            "bisections_total", "diverged_headers", "witness_demotions",
            "primary_replacements",
        )
        if registry is None:
            for n in names:
                setattr(self, n, _NOP)
            return
        from prometheus_client import Gauge

        kw = dict(
            namespace=NAMESPACE, subsystem="liteserve", registry=registry,
            labelnames=("chain_id",),
        )
        descriptions = {
            "sessions": "Live tenant sessions in the bounded session table.",
            "cache_hits": "Tenant lookups served straight from the shared light store.",
            "cache_misses": "Tenant lookups that required a verification pass.",
            "coalesced_verifies":
                "Tenant lookups that joined an in-flight verification "
                "(single-flight coalescing).",
            "bisections_total": "Verification passes run by the shared engine.",
            "diverged_headers": "Conflicting headers detected via witness cross-check.",
            "witness_demotions": "Witnesses demoted out of the rotation pool.",
            "primary_replacements":
                "Primaries demoted and replaced by a promoted witness.",
        }
        for n in names:
            setattr(
                self, n,
                Gauge(n, descriptions[n], **kw).labels(chain_id=chain_id),
            )


class MetricsProvider:
    """node/node.go:128 DefaultMetricsProvider — one registry per node."""

    def __init__(self, enabled: bool, chain_id: str):
        self.enabled = enabled
        self.chain_id = chain_id
        self.registry = None
        if enabled:
            from prometheus_client import CollectorRegistry

            self.registry = CollectorRegistry()
        self.consensus = ConsensusMetrics(self.registry, chain_id)
        self.p2p = P2PMetrics(self.registry, chain_id)
        self.mempool = MempoolMetrics(self.registry, chain_id)
        self.rpc = RPCMetrics(self.registry, chain_id)
        self.state = StateMetrics(self.registry, chain_id)
        self.verify = VerifyMetrics(self.registry, chain_id)
        self.loop = LoopMetrics(self.registry, chain_id)
        self.statesync = StateSyncMetrics(self.registry, chain_id)
        self.evidence = EvidenceMetrics(self.registry, chain_id)
        self.chaos = ChaosMetrics(self.registry, chain_id)
        self.health = HealthMetrics(self.registry, chain_id)
        self.storage = StorageMetrics(self.registry, chain_id)
        self.liteserve = LiteServeMetrics(self.registry, chain_id)

    def exposition(self) -> bytes:
        if self.registry is None:
            return b""
        from prometheus_client import generate_latest

        return generate_latest(self.registry)


def nop_provider(chain_id: str = "") -> MetricsProvider:
    return MetricsProvider(False, chain_id)


class MetricsServer:
    """Standalone /metrics HTTP listener (node/node.go:1121
    startPrometheusServer flavor) on rpc/http.py: the JAX server's status,
    body and Content-Type for each request."""

    # the exposition content type Prometheus scrapers negotiate for (text
    # format version 0.0.4), set verbatim as the JAX server sets it
    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self, provider: MetricsProvider, listen_addr: str):
        self.provider = provider
        self.listen_addr = listen_addr
        self._http = None
        self.bound_addr: Optional[str] = None

    async def _route(self, req):
        from ..rpc import http

        if req.path != "/metrics":
            return http.NOT_FOUND
        if req.method not in ("GET", "HEAD"):
            return http.NOT_ALLOWED
        return 200, self.provider.exposition(), self.CONTENT_TYPE

    async def start(self) -> None:
        from ..rpc.http import HTTPServer

        server = HTTPServer(self._route, logger="metrics")
        try:
            self.bound_addr = await server.start(self.listen_addr)
        except OSError as e:
            # a bare EADDRINUSE without the address sends the operator
            # hunting through every listener the node opens
            raise OSError(f"metrics server failed to bind {self.listen_addr!r}: {e}") from e
        self._http = server

    async def stop(self) -> None:
        # idempotent: node teardown paths may stop twice (error unwind +
        # on_stop sweep); the second call must be a no-op
        server, self._http = self._http, None
        if server is not None:
            await server.stop()
