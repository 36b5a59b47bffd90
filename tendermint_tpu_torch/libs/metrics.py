"""Prometheus metrics of the ported subsystems (the `consensus`, `verify`,
`mempool`, `state` and `evidence` subsystems of
tendermint_tpu/libs/metrics.py, same metric names).

Without a registry every metric is a no-op.  `prometheus_client` is
imported only when a registry is passed, so the engine runs where that
package is not installed.
"""

from __future__ import annotations

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
