"""The verify engine's Prometheus metrics (the `verify` subsystem of
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
