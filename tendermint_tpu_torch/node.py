"""Node: dependency-injection assembly of the full node, without p2p (the
port's copy of tendermint_tpu/node.py).

Reference parity: node/node.go (NewNode:556, DefaultNewNode:90,
OnStart:752; createAndStartProxyAppConns:578, doHandshake:601,
createMempool:634, NewBlockExecutor:643, onlyValidatorIsUs:314).

The node builds what the JAX node builds, in its order, with the port's
engine where the JAX node builds its own: one BatchVerifier on the card
(installed as the flat hook), a TableCache on it (the indexed hook) and the
AsyncBatchVerifier on it, whose start puts the verifier in warmup mode, so
a validator set's first commit check declines while its table builds in
the background, and `_valset_watch` builds a rotated set's table before
its first commit.  `device=None` means the card; without one the node
raises at construction unless the caller passes device="cpu".

A configuration that needs a part the port does not carry yet raises
NotImplementedError at construction, before anything is opened, naming
the ROADMAP item that ports it (see `check_ported`).  The JAX defaults turn
p2p and RPC on, so a port node runs with `p2p.laddr = "none"` and
`rpc.laddr = ""`.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from .config import Config
from .consensus import ConsensusState, Handshaker
from .consensus.wal import WAL
from .libs.kvstore import open_db
from .libs.log import get_logger
from .libs.service import Service
from .mempool import Mempool
from .proxy import AppConns, default_client_creator
from .state import StateStore
from .state.execution import BlockExecutor
from .state.txindex import IndexerService, NullTxIndexer, TxIndexer
from .store import BlockStore
from .types.events import EventBus
from .types.genesis import GenesisDoc


def check_ported(config: Config) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a setting
    whose subsystem the port does not carry yet."""
    cfg = config
    unported = (
        (cfg.p2p.laddr not in ("", "none"),
         f"p2p.laddr = {cfg.p2p.laddr!r}: the p2p stack and its reactors", "1.7",
         'p2p.laddr = "none"'),
        (bool(cfg.rpc.laddr), f"rpc.laddr = {cfg.rpc.laddr!r}: the RPC server", "1.7",
         'rpc.laddr = ""'),
        (bool(cfg.rpc.grpc_laddr), f"rpc.grpc_laddr = {cfg.rpc.grpc_laddr!r}: the gRPC server",
         "1.7", 'rpc.grpc_laddr = ""'),
        (bool(cfg.base.priv_validator_laddr),
         f"priv_validator_laddr = {cfg.base.priv_validator_laddr!r}: the remote signer", "1.7",
         'priv_validator_laddr = ""'),
        (cfg.instrumentation.prometheus, "instrumentation.prometheus: the /metrics listener",
         "1.7", "prometheus = false"),
        (cfg.liteserve.enable, "liteserve.enable: the light-client gateway", "1.7",
         "liteserve.enable = false"),
        (cfg.chaos.enabled, "chaos.enabled: disk faults, the twin signer and link policies",
         "1.8", "chaos.enabled = false"),
        (cfg.instrumentation.flight_spool,
         "instrumentation.flight_spool: the crash-persistent flight spool", "1.8",
         "flight_spool = false"),
        (cfg.tpu.mesh == "on", 'tpu.mesh = "on": the multi-card verify mesh', "2.2",
         'tpu.mesh = "auto"'),
        (cfg.tpu.bls_jax_aggregation,
         "tpu.bls_jax_aggregation: the batched BLS aggregation kernel", "2.1",
         "bls_jax_aggregation = false"),
    )
    for on, what, item, fix in unported:
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP {item}); set {fix}"
            )


def engine_device(config: Config, device=None):
    """The verify engine's device: None for `tpu.enabled = false` (no
    engine), else the card (device=None), which raises where there is none
    unless the caller asked for the CPU."""
    if not config.tpu.enabled:
        return None
    from .crypto.batch_verifier import resolve_device

    return resolve_device(device)


def only_validator_is_us(state, priv_val) -> bool:
    """node/node.go:314 — a solo validator can skip fast sync."""
    if priv_val is None or state.validators.size() > 1:
        return False
    addr, _ = state.validators.get_by_index(0)
    return addr == priv_val.get_pub_key().address()


def default_new_node(
    config: Config, genesis_doc: Optional[GenesisDoc] = None, device=None
) -> "Node":
    """node/node.go:90 DefaultNewNode — genesis from the config tree, FilePV
    for signing (the remote signer is ROADMAP 1.7)."""
    check_ported(config)
    device = engine_device(config, device)
    if genesis_doc is None:
        genesis_doc = GenesisDoc.from_file(config.genesis_file())
    from .privval.file import load_or_gen_file_pv

    config.ensure_dirs()
    pv = load_or_gen_file_pv(config)
    return Node(config, genesis_doc, priv_validator=pv, device=device)


class Node(Service):
    def __init__(
        self,
        config: Config,
        genesis_doc: GenesisDoc,
        priv_validator=None,
        client_creator=None,
        db_backend: Optional[str] = None,
        device=None,
    ):
        check_ported(config)
        super().__init__("node")
        self.config = config
        # the engine's card, resolved before anything is opened
        self.device = engine_device(config, device)
        genesis_doc.validate_and_complete()
        self.genesis_doc = genesis_doc
        self.priv_validator = priv_validator
        self.log = get_logger("node")

        backend = db_backend or config.base.db_backend
        home = None if backend == "memdb" else config.home
        # one sink for every storage-fault observation (write errors,
        # detected corruption, quarantines, persistence halts) + the
        # free-space probe — the watchdog's disk_fault/disk_pressure
        # detectors read it
        from .libs.watchdog import StorageHealth

        self.storage_health = StorageHealth(
            data_dir=config.db_dir() if home is not None else None
        )
        self.block_store = BlockStore(open_db("blockstore", home, backend))
        self.block_store.storage_health = self.storage_health
        self.state_db = open_db("state", home, backend)
        self.state_store = StateStore(self.state_db)

        self.event_bus = EventBus()
        # builtin kvstore rides a DURABLE db under home/data (app_db) so a
        # restart finds the app state it committed
        creator = client_creator or default_client_creator(
            config.base.proxy_app,
            config.base.abci,
            app_db=(
                open_db("app", home, backend)
                if config.base.proxy_app in ("kvstore", "bank", "staking")
                else None
            ),
            snapshot_interval=config.statesync.snapshot_interval,
            snapshot_chunk_bytes=config.statesync.snapshot_chunk_bytes,
            snapshot_keep_recent=config.statesync.snapshot_keep_recent,
        )
        self.proxy_app = AppConns(creator)

        self.state = self.state_store.load_from_db_or_genesis(genesis_doc)

        # tx indexer
        if config.tx_index.indexer == "kv":
            self.tx_indexer = TxIndexer(open_db("tx_index", home, backend))
        else:
            self.tx_indexer = NullTxIndexer()
        self.indexer_service = IndexerService(self.tx_indexer, self.event_bus)

        self.mempool: Optional[Mempool] = None
        self.consensus: Optional[ConsensusState] = None
        self.evidence_pool = None
        self.batch_verifier = None
        self.async_verifier = None
        self.table_cache = None
        self.metrics_provider = None
        self.loop_profiler = None
        self.watchdog = None
        # flight recorder: always constructed (cheap); enabled/size/
        # high-rate sampling from the [instrumentation] config section
        from .libs.tracing import FlightRecorder

        self.flight_recorder = FlightRecorder(
            size=config.instrumentation.flight_recorder_size,
            enabled=config.instrumentation.flight_recorder,
            sample_high_rate=config.instrumentation.trace_sample_high_rate,
        )

    async def on_start(self) -> None:
        cfg = self.config
        # metrics provider (node/node.go:128) — per-node registry; built
        # before the verify engine so the engine reports through it
        from .libs.metrics import MetricsProvider

        self.metrics_provider = MetricsProvider(
            cfg.instrumentation.prometheus, self.genesis_doc.chain_id
        )
        self.storage_health.metrics = self.metrics_provider.storage
        # boot-time store integrity sweep: turn latent bit-rot into
        # quarantine entries BEFORE anything reads the store as truth.
        # Off the event loop — an archive-node sweep is real IO+hashing.
        if cfg.storage.integrity_scan_on_boot and self.block_store.height() > 0:
            limit = cfg.storage.integrity_scan_limit
            report = await asyncio.get_event_loop().run_in_executor(
                None, lambda: self.block_store.integrity_scan(limit)
            )
            if report["corrupt"] or report["quarantined"]:
                self.log.warn(
                    "boot integrity scan found corruption",
                    corrupt=report["corrupt"],
                    quarantined=report["quarantined"],
                    checked=report["checked"],
                    ms=report["ms"],
                )
            else:
                self.log.info(
                    "boot integrity scan clean",
                    checked=report["checked"], ms=report["ms"],
                )
        from .crypto import backend as _crypto_backend

        self.metrics_provider.verify.backend_tier.set(_crypto_backend.active_tier())
        # scheduler profiler, started BEFORE any service spawns tasks so
        # the spawn-path accounting trampoline covers them all.  The spawn
        # and GC hooks are process-wide first-wins (libs/loopprof.py).
        if cfg.instrumentation.loop_profiler:
            from .libs.loopprof import LoopProfiler

            self.loop_profiler = LoopProfiler(
                interval=cfg.instrumentation.loop_probe_interval,
                metrics=self.metrics_provider.loop,
                recorder=self.flight_recorder,
            )
            await self.loop_profiler.start()
        # the verify engine first: every downstream consumer of the
        # crypto.batch hooks (handshake replay, verify_commit in block
        # validation) must already see the device path
        if cfg.tpu.enabled:
            from .crypto.batch_verifier import AsyncBatchVerifier, BatchVerifier, TableCache

            # one card: [tpu] mesh "auto" and "off" give one shard ("on"
            # raised at construction)
            self.metrics_provider.verify.shards.set(1)
            self.log.info(
                "verify engine",
                shards=1,
                mesh=f"{cfg.tpu.mesh}: one card",
                device=self.device,
                host_tier=_crypto_backend.active_tier(),
            )
            self.batch_verifier = BatchVerifier(
                device=self.device,
                min_device_batch=cfg.tpu.min_device_batch,
                metrics=self.metrics_provider.verify,
                recorder=self.flight_recorder,
                chunk_size=cfg.tpu.chunk_size,
                chunk_depth=cfg.tpu.chunk_depth,
            ).install()
            # steady-state commit path: per-valset device tables (tabulated
            # windows auto-profiled on the card)
            self.table_cache = TableCache(
                self.batch_verifier,
                tabulated={"auto": None, "on": True, "off": False}[cfg.tpu.tabulated],
            ).install()
            self.async_verifier = AsyncBatchVerifier(
                self.batch_verifier,
                max_batch=cfg.tpu.max_batch,
                flush_interval=cfg.tpu.flush_interval,
                flush_min=cfg.tpu.flush_min,
                adaptive=cfg.tpu.flush_adaptive,
            )
            await self.async_verifier.start()
        await self.event_bus.start()
        await self.indexer_service.start()
        await self.proxy_app.start()

        # handshake: sync app with block store (node/node.go:601)
        handshaker = Handshaker(
            self.state_store, self.state, self.block_store, self.genesis_doc
        )
        self.state = await handshaker.handshake(self.proxy_app)

        # mempool (node/node.go:634)
        self.mempool = Mempool(
            self.proxy_app.mempool(), cfg.mempool.as_dict(), height=self.state.last_block_height
        )
        self.mempool.storage_health = self.storage_health
        if cfg.mempool.wal_dir and cfg.base.db_backend != "memdb":
            self.mempool.init_wal(cfg.mempool_wal_dir())
        if cfg.consensus.wait_for_txs():
            self.mempool.enable_txs_available()
        if cfg.mempool.sig_precheck and self.async_verifier is not None:
            # signed-tx envelopes batch-verify through the SAME engine as
            # consensus votes — one flusher coalesces both ingress streams
            self.mempool.sig_verifier = self.async_verifier

        # evidence pool
        from .evidence import EvidencePool

        home = None if cfg.base.db_backend == "memdb" else cfg.home
        self.evidence_pool = EvidencePool(
            open_db("evidence", home, cfg.base.db_backend), self.state_store
        )
        self.evidence_pool.metrics = self.metrics_provider.evidence
        self.evidence_pool.recorder = self.flight_recorder
        # re-publish the opening count: the pool counted pending evidence
        # against its nop metrics before this swap
        self.evidence_pool.metrics.pending.set(self.evidence_pool.num_pending())

        self.mempool.metrics = self.metrics_provider.mempool
        self.mempool.recorder = self.flight_recorder

        block_exec = BlockExecutor(
            self.state_store,
            self.proxy_app.consensus(),
            self.mempool,
            evidence_pool=self.evidence_pool,
            event_bus=self.event_bus,
            metrics=self.metrics_provider.state,
        )

        self.consensus = ConsensusState(
            cfg.consensus,
            self.state,
            block_exec,
            self.block_store,
            self.mempool,
            evidence_pool=self.evidence_pool,
            event_bus=self.event_bus,
        )
        self.consensus.metrics = self.metrics_provider.consensus
        self.consensus.recorder = self.flight_recorder
        if self.priv_validator is not None:
            self.consensus.set_priv_validator(self.priv_validator)
        self.consensus.storage_health = self.storage_health
        # dynamic validator sets: rebuild the verify engine's device tables
        # the moment an ABCI update lands, so the INCOMING set's first
        # commit verifies through a warm table instead of paying the
        # decline-while-building miss
        self.spawn(self._valset_watch(), name="valset-watch")
        cfg.ensure_dirs()
        if cfg.base.db_backend != "memdb":
            self.consensus.wal = WAL(cfg.wal_file())

        # without p2p (p2p.laddr "" or "none") consensus starts on its own
        await self.consensus.start()
        if self.loop_profiler is not None:
            self._register_queue_probes()
        # health watchdog, started LAST so every probed subsystem exists;
        # emits health.alarm/clear recorder events, auto-bundles on critical
        if cfg.instrumentation.watchdog:
            from .libs.watchdog import Watchdog, write_autodump_bundle

            inst = cfg.instrumentation
            autodump_fn = None
            if inst.watchdog_autodump:
                forensics_dir = cfg._join("data/forensics")

                def autodump_fn(health):  # noqa: F811 — the armed variant
                    return write_autodump_bundle(self, health, forensics_dir)

            self.watchdog = Watchdog(
                self,
                interval=inst.watchdog_interval,
                stall_seconds=inst.watchdog_stall_seconds,
                round_churn=inst.watchdog_round_churn,
                verify_stall_seconds=inst.watchdog_verify_stall_seconds,
                lag_ms=inst.watchdog_lag_ms,
                mempool_ratio=inst.watchdog_mempool_ratio,
                shed_rate=inst.watchdog_shed_rate,
                clock_drift_seconds=inst.watchdog_clock_drift_seconds,
                min_peers=inst.watchdog_min_peers,
                disk_free_bytes=cfg.storage.min_free_bytes,
                disk_fault_hold=inst.watchdog_disk_fault_hold,
                metrics=self.metrics_provider.health,
                recorder=self.flight_recorder,
                autodump_fn=autodump_fn,
                autodump_min_interval=inst.watchdog_autodump_min_interval,
            )
            await self.watchdog.start()
        self.log.info(
            "node started",
            chain_id=self.genesis_doc.chain_id,
            height=self.state.last_block_height,
        )

    async def _valset_watch(self) -> None:
        """Subscribe to EVENT_VALIDATOR_SET_UPDATES and keep every
        set-parameterized engine layer current:

        - gauges (`valset_updates_total`, `valset_size`) + a `valset.update`
          flight-recorder event so rotations are attributable post-mortem;
        - TableCache.rebuild for the upcoming set's pubkey digest — the
          device table is otherwise built lazily on first miss, which would
          put the build on the first post-rotation commit; a set that is
          not all ed25519 only re-warms the verifier for the new set size.
        """
        from .libs.events import SubscriptionCancelled
        from .types.events import EVENT_VALIDATOR_SET_UPDATES, query_for_event
        from .types.vote import is_bls_key

        sub = await self.event_bus.subscribe(
            "node-valset-watch", query_for_event(EVENT_VALIDATOR_SET_UPDATES)
        )
        while True:
            try:
                msg = await sub.next()
            except (SubscriptionCancelled, asyncio.CancelledError):
                return
            try:
                event = msg.data
                updates = (getattr(event, "data", None) or {}).get("validator_updates", [])
                # the executor saves state (with the H+2 set in
                # next_validators) BEFORE firing events, so the store is
                # the race-free source for the upcoming set
                new_state = self.state_store.load()
                next_vals = new_state.next_validators
                self.metrics_provider.state.valset_updates.inc()
                self.metrics_provider.state.valset_size.set(next_vals.size())
                self.flight_recorder.record(
                    "valset.update",
                    height=new_state.last_block_height,
                    n_updates=len(updates),
                    new_size=next_vals.size(),
                    uniform_bls=all(is_bls_key(v.pub_key) for v in next_vals.validators),
                )
                if self.table_cache is not None:
                    all_ed = all(
                        getattr(v.pub_key, "TYPE", "") == "tendermint/PubKeyEd25519"
                        for v in next_vals.validators
                    )
                    if all_ed:
                        self.table_cache.rebuild(
                            next_vals.pubkeys_digest(),
                            [v.pub_key.bytes() for v in next_vals.validators],
                        )
                    elif self.batch_verifier is not None:
                        self.batch_verifier.rewarm(next_vals.size())
            except Exception as e:
                self.log.error("valset watch failed", err=repr(e))

    def _register_queue_probes(self) -> None:
        """Wire the known choke-point queues into the scheduler profiler's
        per-tick `loop.queue` sampling: the consensus receive queue and the
        AsyncBatchVerifier's pending list + flush-executor backlog (the
        MConnection send queues come with p2p, ROADMAP 1.7)."""
        prof = self.loop_profiler
        if self.consensus is not None:
            prof.add_queue_probe("cs_recv", self.consensus.msg_queue.qsize)
        if self.async_verifier is not None:
            verifier = self.async_verifier
            prof.add_queue_probe("verify_pending", lambda: len(verifier._pending))

            def _executor_backlog() -> int:
                ex = verifier._executor
                q = getattr(ex, "_work_queue", None)
                return q.qsize() if q is not None else 0

            prof.add_queue_probe("flush_executor", _executor_backlog)

    async def on_stop(self) -> None:
        if self.watchdog is not None:
            await self.watchdog.stop()
        if self.loop_profiler is not None:
            await self.loop_profiler.stop()
        if self.consensus is not None:
            await self.consensus.stop()
        await self.indexer_service.stop()
        await self.event_bus.stop()
        await self.proxy_app.stop()
        if self.mempool is not None:
            self.mempool.close_wal()
        if self.async_verifier is not None:
            await self.async_verifier.stop()
        if self.batch_verifier is not None:
            from .crypto import batch as batch_hook

            # uninstall only if the process-wide hook is still ours — another
            # live node may have installed its own engine meanwhile
            if batch_hook.get_verifier() == self.batch_verifier.verify:
                batch_hook.set_verifier(None)
            if (
                self.table_cache is not None
                and batch_hook.get_indexed_verifier() == self.table_cache.verify_indexed
            ):
                batch_hook.set_indexed_verifier(None)
