"""Node: dependency-injection assembly of the full node (the port's copy of
tendermint_tpu/node.py, with the RPC server and its /websocket, the p2p
stack with PEX and the address book, the STATESYNC, BLOCKCHAIN, CONSENSUS,
MEMPOOL and EVIDENCE reactors, the embedded liteserve gateway, an app
behind the ABCI socket or gRPC, a remote signer on `priv_validator_laddr`,
the /metrics listener, the gRPC BroadcastAPI on `rpc.grpc_laddr` and the
crash-persistent flight spool; without the chaos layers).

Reference parity: node/node.go (NewNode:556, DefaultNewNode:90,
OnStart:752; createAndStartProxyAppConns:578, doHandshake:601,
createMempool:634, NewBlockExecutor:643, createConsensusReactor:659,
createPEXReactor:381, onlyValidatorIsUs:314, the RPC listeners:766).

The node builds what the JAX node builds, in its order, with the port's
engine where the JAX node builds its own: one BatchVerifier on the card
(installed as the flat hook), a TableCache on it (the indexed hook) and the
AsyncBatchVerifier on it, whose start puts the verifier in warmup mode, so
a validator set's first commit check declines while its table builds in
the background, and `_valset_watch` builds a rotated set's table before
its first commit.  `device=None` means the card; without one the node
raises at construction unless the caller passes device="cpu".

A node whose stores are empty, with `[statesync] enable` and p2p on,
bootstraps from a peer's app snapshot: the handshake is skipped, the
StateSyncer's trust root is read through the HTTP providers on
`statesync.rpc_servers`, and `_statesync_done` hands the restored state to
fast sync (or, when every snapshot failed, replays from genesis).  With
`p2p.pex` (the default) the address book lives at `addr_book_file()` and
the PEX reactor dials `p2p.seeds` and what they gossip; with
`liteserve.enable` the gateway serves `lite_*` off this node's engine.

A configuration that needs a part the port does not carry yet raises
NotImplementedError at construction, before anything is opened, naming
the ROADMAP item that ports it (see `check_ported`).  `p2p.laddr = "none"`
runs the node without p2p and `rpc.laddr = ""` without RPC.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from .abci import types as abci_types
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
        (cfg.p2p.test_fuzz, "p2p.test_fuzz: the p2p link policies", "1.8", "test_fuzz = false"),
        (cfg.chaos.enabled, "chaos.enabled: disk faults, the twin signer and link policies",
         "1.8", "chaos.enabled = false"),
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


def install_engine(tpu, device, metrics=None, recorder=None):
    """The verify hooks on `device` from a `[tpu]` section: one
    BatchVerifier installed as the flat crypto.batch hook and a TableCache
    on it installed as the indexed hook (tabulated windows auto-profiled on
    the card).  Out of warmup mode: a missing kernel library builds at the
    first launch and a set's first check builds its table, on the card."""
    from .crypto.batch_verifier import BatchVerifier, TableCache

    bv = BatchVerifier(
        device=device,
        min_device_batch=tpu.min_device_batch,
        metrics=metrics,
        recorder=recorder,
        chunk_size=tpu.chunk_size,
        chunk_depth=tpu.chunk_depth,
    ).install()
    table_cache = TableCache(
        bv, tabulated={"auto": None, "on": True, "off": False}[tpu.tabulated],
    ).install()
    return bv, table_cache


def build_engine(tpu, device, metrics=None, recorder=None):
    """The verify engine as the node builds it: install_engine's hooks and
    an AsyncBatchVerifier on them, not yet started (its start puts the
    verifier in warmup mode)."""
    from .crypto.batch_verifier import AsyncBatchVerifier

    bv, table_cache = install_engine(tpu, device, metrics=metrics, recorder=recorder)
    abv = AsyncBatchVerifier(
        bv,
        max_batch=tpu.max_batch,
        flush_interval=tpu.flush_interval,
        flush_min=tpu.flush_min,
        adaptive=tpu.flush_adaptive,
    )
    return bv, table_cache, abv


def uninstall_engine(bv, table_cache) -> None:
    """Give the crypto.batch hooks back, only where they are still this
    engine's — another live node may have installed its own meanwhile."""
    from .crypto import batch as batch_hook

    if batch_hook.get_verifier() == bv.verify:
        batch_hook.set_verifier(None)
    if table_cache is not None and batch_hook.get_indexed_verifier() == table_cache.verify_indexed:
        batch_hook.set_indexed_verifier(None)


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
    (or a remote signer when priv_validator_laddr is set) for signing."""
    check_ported(config)
    device = engine_device(config, device)
    if genesis_doc is None:
        genesis_doc = GenesisDoc.from_file(config.genesis_file())
    if config.base.priv_validator_laddr:
        from .privval import SignerClient

        pv = SignerClient(config.base.priv_validator_laddr)
    else:
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
        self.consensus_reactor = None
        self.blockchain_reactor = None
        self.statesync_reactor = None
        self.rpc_server = None
        self.grpc_server = None
        self.switch = None
        self.addr_book = None
        self.pex_reactor = None
        self.liteserve = None
        self.node_key = None
        self.evidence_pool = None
        self.batch_verifier = None
        self.async_verifier = None
        self.table_cache = None
        self.metrics_provider = None
        self.metrics_server = None
        self.loop_profiler = None
        self.watchdog = None
        self.flight_spool = None
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
        # crash-persistent flight spool ([instrumentation] flight_spool):
        # recorder events journal to disk on a cadence OFF the recording
        # hot path, so a SIGKILL leaves the last seconds of spans for
        # `debug dump` to replay offline.  Built before any service spawns
        # so startup spans are covered too.  The JAX node wraps the spool's
        # group in its chaos disk-fault layer; the port has no chaos layer
        # yet (ROADMAP 1.8), so the group stays unwrapped until it lands.
        if cfg.instrumentation.flight_spool and self.flight_recorder.enabled:
            from .libs.tracing import FlightSpool

            cfg.ensure_dirs()
            self.flight_spool = FlightSpool(
                cfg.flight_spool_file(),
                self.flight_recorder,
                size_limit=cfg.instrumentation.flight_spool_size_limit,
                node=cfg.base.moniker,
            )
            self.flight_spool.install_crash_hooks()
            self.spawn(self._spool_flush_loop(), name="flight-spool")
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
            self.batch_verifier, self.table_cache, self.async_verifier = build_engine(
                cfg.tpu, self.device, metrics=self.metrics_provider.verify,
                recorder=self.flight_recorder,
            )
            await self.async_verifier.start()
        # remote signer: wait for the external signer to dial in BEFORE
        # consensus needs a pubkey (node/node.go:612-618)
        if isinstance(self.priv_validator, Service) and not self.priv_validator.is_running:
            await self.priv_validator.start()
        await self.event_bus.start()
        await self.indexer_service.start()
        await self.proxy_app.start()

        # statesync gate, decided BEFORE the handshake: a truly empty node
        # (no state, no blocks) with [statesync] enable and p2p on will
        # bootstrap from a snapshot.  The handshake is SKIPPED in that case
        # (node/node.go: stateSync skips doHandshake): after a crash
        # between app restore and state persist the app may legitimately
        # be AHEAD of our empty stores, which the handshake would treat as
        # corruption — statesync re-offers the snapshot instead.
        do_state_sync = (
            cfg.statesync.enable
            and self.state.last_block_height == 0
            and self.block_store.height() == 0
            and bool(cfg.p2p.laddr and cfg.p2p.laddr != "none")
        )
        if not do_state_sync:
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

        # RPC (node/node.go:766)
        if cfg.rpc.laddr:
            from .rpc.server import RPCServer

            self.rpc_server = RPCServer(self, cfg.rpc)
            # ingress admission-control telemetry rides the node's own
            # metrics registry + flight recorder (ingress.throttle events)
            self.rpc_server.core.metrics = self.metrics_provider.rpc
            self.rpc_server.core.recorder = self.flight_recorder
            await self.rpc_server.start()
            self.log.info("rpc listening", laddr=cfg.rpc.laddr)
        if cfg.rpc.grpc_laddr:
            from .rpc.grpc_api import BroadcastAPIServer

            self.grpc_server = BroadcastAPIServer(self, cfg.rpc.grpc_laddr)
            await self.grpc_server.start()

        # p2p stack + reactors (node/node.go:653-709)
        if cfg.p2p.laddr and cfg.p2p.laddr != "none":
            await self._start_p2p(block_exec, do_state_sync)
        else:
            await self.consensus.start()
        # /metrics listener (node/node.go:1121)
        if cfg.instrumentation.prometheus:
            from .libs.metrics import MetricsServer

            self.metrics_server = MetricsServer(
                self.metrics_provider, cfg.instrumentation.prometheus_listen_addr
            )
            await self.metrics_server.start()
            self.log.info("prometheus metrics", laddr=self.metrics_server.bound_addr)
        if self.loop_profiler is not None:
            self._register_queue_probes()
        # embedded light-client gateway: lite_* routes served off this
        # node's own engine — the LocalProvider primary reads the node's
        # stores in-proc, and cache misses verify through the node's
        # shared AsyncBatchVerifier lane instead of a private batch
        if cfg.liteserve.enable:
            await self._start_liteserve()
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

    async def _start_p2p(self, block_exec, do_state_sync: bool) -> None:
        """The JAX node's p2p block without the chaos layers (check_ported
        refused them): NodeKey, NodeInfo with the gossip version the knobs
        enable, Transport, Switch with the ABCI peer filter, the STATESYNC
        (with a StateSyncer only when bootstrapping), BLOCKCHAIN,
        CONSENSUS, MEMPOOL, EVIDENCE and (with `p2p.pex`) PEX reactors with
        the address book, listen, the switch's start (which starts
        consensus unless a sync runs first), the quarantine refill and the
        persistent peers."""
        from .consensus.reactor import ConsensusReactor
        from .evidence_reactor import EvidenceReactor
        from .fastsync import BlockchainReactor
        from .mempool_reactor import MempoolReactor
        from .statesync import StateSyncer, StateSyncReactor
        from .p2p import NodeInfo, NodeKey, Switch, Transport
        from .p2p.node_info import (
            GOSSIP_BATCH_VERSION,
            GOSSIP_SUMMARY_VERSION,
            GOSSIP_TRACE_VERSION,
        )

        cfg = self.config
        self.node_key = NodeKey.load_or_gen(cfg.node_key_file())
        # advertise the highest gossip capability the knobs enable; peers
        # fall back per level (3 -> wire trace context, 2 -> summary+batch,
        # 1 -> batch, 0 -> the reference's single-vote messages)
        cc = cfg.consensus
        if cc.gossip_vote_batch and cc.gossip_vote_summary and cc.gossip_trace_context:
            gossip_version = GOSSIP_TRACE_VERSION
        elif cc.gossip_vote_batch and cc.gossip_vote_summary:
            gossip_version = GOSSIP_SUMMARY_VERSION
        elif cc.gossip_vote_batch:
            gossip_version = GOSSIP_BATCH_VERSION
        else:
            gossip_version = 0
        node_info = NodeInfo(
            node_id=self.node_key.id,
            network=self.genesis_doc.chain_id,
            moniker=cfg.base.moniker,
            gossip_version=gossip_version,
        )
        transport = Transport(self.node_key, node_info)
        self.switch = Switch(
            transport,
            max_inbound=cfg.p2p.max_num_inbound_peers,
            max_outbound=cfg.p2p.max_num_outbound_peers,
            unconditional_peer_ids={s for s in cfg.p2p.unconditional_peer_ids.split(",") if s},
            allow_duplicate_ip=cfg.p2p.allow_duplicate_ip,
        )
        self.switch.metrics = self.metrics_provider.p2p
        if cfg.base.filter_peers:
            # ABCI peer filter (node/node.go:498): the app may veto a peer
            # via Query at p2p/filter/id/<id>
            query_conn = self.proxy_app.query()

            async def abci_filter(ni, conn):
                # bounded: a hung app query must not stall the accept loop;
                # a timeout raises and the switch rejects (fail closed)
                res = await asyncio.wait_for(
                    query_conn.query(
                        abci_types.RequestQuery(path=f"/p2p/filter/id/{ni.node_id}")
                    ),
                    5.0,
                )
                return None if res.code == 0 else f"abci filter code {res.code}"

            self.switch.peer_filters.append(abci_filter)
        do_fast_sync = cfg.base.fast_sync and not only_validator_is_us(
            self.state, self.priv_validator
        )
        self.consensus_reactor = ConsensusReactor(
            self.consensus,
            wait_sync=do_fast_sync or do_state_sync,
            async_verifier=self.async_verifier,
        )
        self.consensus.metrics.fast_syncing.set(1 if (do_fast_sync or do_state_sync) else 0)
        self.blockchain_reactor = BlockchainReactor(
            self.state,
            block_exec,
            self.block_store,
            # while statesync runs, fastsync stays dormant — it must NOT
            # start replaying from genesis under the restore
            fast_sync=do_fast_sync and not do_state_sync,
            consensus_reactor=self.consensus_reactor,
            wait_statesync=do_state_sync,
        )
        syncer = None
        if do_state_sync:
            syncer = StateSyncer(
                cfg.statesync,
                self.genesis_doc,
                self.state_store,
                self.block_store,
                self.proxy_app,
                async_verifier=self.async_verifier,
                metrics=self.metrics_provider.statesync,
                recorder=self.flight_recorder,
            )
            self.metrics_provider.statesync.sync_phase.set(
                self.metrics_provider.statesync.PHASE_STATESYNC
            )
        # every node registers the reactor: full nodes SERVE their app's
        # snapshots on 0x60/0x61 even when not bootstrapping
        self.statesync_reactor = StateSyncReactor(
            self.proxy_app, syncer=syncer, on_done=self._statesync_done
        )
        self.blockchain_reactor.statesync_metrics = self.metrics_provider.statesync
        if do_fast_sync and not do_state_sync:
            self.metrics_provider.statesync.sync_phase.set(
                self.metrics_provider.statesync.PHASE_FASTSYNC
            )
        self.switch.add_reactor("STATESYNC", self.statesync_reactor)
        self.switch.add_reactor("BLOCKCHAIN", self.blockchain_reactor)
        self.switch.add_reactor("CONSENSUS", self.consensus_reactor)
        # always registered: broadcast=false only disables outbound gossip,
        # inbound txs must still be accepted (mempool/reactor.go)
        self.switch.add_reactor(
            "MEMPOOL",
            MempoolReactor(self.mempool, broadcast=cfg.mempool.broadcast,
                           config=cfg.mempool.as_dict()),
        )
        self.switch.add_reactor("EVIDENCE", EvidenceReactor(self.evidence_pool))
        # PEX + address book: peer discovery (node/node.go:381 createPEXReactor);
        # the reactor saves the book when it stops
        if cfg.p2p.pex:
            from .p2p.pex import AddrBook, PEXReactor

            book_path = cfg.addr_book_file() if cfg.base.db_backend != "memdb" else ""
            self.addr_book = AddrBook(
                book_path,
                strict=cfg.p2p.addr_book_strict,
                our_ids={self.node_key.id},
                private_ids={s for s in cfg.p2p.private_peer_ids.split(",") if s},
            )
            self.switch.addr_book = self.addr_book
            self.pex_reactor = PEXReactor(
                self.addr_book,
                seeds=[s for s in cfg.p2p.seeds.split(",") if s],
                seed_mode=cfg.p2p.seed_mode,
            )
            self.switch.add_reactor("PEX", self.pex_reactor)
        await transport.listen(cfg.p2p.laddr)
        node_info.listen_addr = cfg.p2p.external_address or transport.listen_addr
        await self.switch.start()  # starts reactors, incl. consensus
        # heights the boot scan (or a previous run) quarantined are
        # re-fetched from peers through the fast-sync channel
        quarantined = self.block_store.quarantined()
        if quarantined:
            self.blockchain_reactor.request_refill(quarantined)
        if cfg.p2p.persistent_peers:
            await self.switch.dial_peers_async(
                cfg.p2p.persistent_peers.split(","), persistent=True
            )

    async def _start_liteserve(self) -> None:
        from .lite2 import HTTPProvider, LocalProvider, TrustOptions
        from .liteserve import LiteServe, trust_root_from_rpc

        cfg = self.config
        ls = cfg.liteserve
        primary = LocalProvider(self)
        if ls.trust_height > 0 and ls.trust_hash:
            root = TrustOptions(
                int(ls.trust_period * 1e9), ls.trust_height, bytes.fromhex(ls.trust_hash)
            )
        else:
            # embedded dev convenience: root at our own near-tip header —
            # the gateway's subjective root IS this node's chain.  At boot
            # the chain may still be at height 0; wait for the first commit
            root = None
            for _ in range(100):
                try:
                    root = await trust_root_from_rpc(primary)
                    break
                except Exception:  # noqa: BLE001 — no header yet
                    await asyncio.sleep(0.1)
            if root is None:
                root = await trust_root_from_rpc(primary)
        chain_id = self.genesis_doc.chain_id
        witnesses = [
            HTTPProvider(chain_id, w.strip())
            for w in ls.witnesses.split(",") if w.strip()
        ]
        self.liteserve = LiteServe(
            chain_id,
            root,
            primary,
            witnesses,
            laddr=ls.laddr,
            cache_capacity=ls.cache_capacity,
            max_sessions=ls.max_sessions,
            idle_timeout_s=ls.idle_timeout,
            session_rate=ls.session_rate,
            session_burst=ls.session_burst,
            create_rate=ls.create_rate,
            create_burst=ls.create_burst,
            witness_quorum=ls.witness_quorum,
            witness_timeout_s=ls.witness_timeout,
            rotation_seed=ls.rotation_seed,
            max_body_bytes=ls.max_body_bytes,
            async_verifier=self.async_verifier,
            metrics=self.metrics_provider.liteserve,
            recorder=self.flight_recorder,
            primary_addr="local",
            witness_addrs=[w.strip() for w in ls.witnesses.split(",") if w.strip()],
        )
        await self.liteserve.start()
        self.log.info("liteserve gateway", laddr=self.liteserve.listen_addr)

    def _register_queue_probes(self) -> None:
        """Wire the known choke-point queues into the scheduler profiler's
        per-tick `loop.queue` sampling: the consensus receive queue, the
        AsyncBatchVerifier's pending list + flush-executor backlog, and the
        aggregate MConnection send-queue depth across peers."""
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
        if self.switch is not None:
            switch = self.switch

            def _mconn_send_depth() -> int:
                total = 0
                for peer in list(switch.peers.values()):
                    mconn = getattr(peer, "mconn", None)
                    if mconn is None:
                        continue
                    for ch in mconn.channels.values():
                        total += ch.send_queue.qsize()
                return total

            prof.add_queue_probe("mconn_send", _mconn_send_depth)

    async def _spool_flush_loop(self) -> None:
        """Cadence flush of the flight spool — small buffered appends, far
        from the recording hot path (the recorder never knows the spool
        exists).  Crash classes: this loop covers the steady state; the
        excepthook/atexit hooks cover crashes; node stop does the final
        synced flush; SIGKILL keeps everything up to the last cadence."""
        interval = self.config.instrumentation.flight_spool_flush_interval
        while True:
            await asyncio.sleep(interval)
            try:
                self.flight_spool.flush()
            except Exception as e:  # noqa: BLE001 — a full disk must not kill consensus
                self.log.error("flight spool flush failed", err=repr(e))

    async def _statesync_done(self, state) -> None:
        """Statesync → fastsync handover (or fallback).  `state` is the
        snapshot-restored state, or None when every candidate failed — in
        which case fastsync replays from the pre-statesync state (genesis
        on an empty node) so the node still joins, just slower."""
        ss_metrics = self.metrics_provider.statesync
        if state is not None:
            self.state = state
            # fresh statesync node: there is no WAL for the restored
            # height, so consensus must not demand an #ENDHEIGHT marker
            self.consensus.do_wal_catchup = False
        else:
            # fallback to replay-from-genesis: the handshake was SKIPPED
            # at startup (statesync path), so the app has never seen
            # InitChain — run it now or the first replayed block executes
            # against an uninitialized app
            handshaker = Handshaker(
                self.state_store, self.state, self.block_store, self.genesis_doc
            )
            self.state = await handshaker.handshake(self.proxy_app)
        ss_metrics.sync_phase.set(ss_metrics.PHASE_FASTSYNC)
        await self.blockchain_reactor.switch_to_fastsync(self.state)

    async def on_stop(self) -> None:
        if self.watchdog is not None:
            await self.watchdog.stop()
        if self.liteserve is not None:
            await self.liteserve.stop()
        if self.loop_profiler is not None:
            await self.loop_profiler.stop()
        if self.metrics_server is not None:
            await self.metrics_server.stop()
        if self.switch is not None:
            await self.switch.stop()  # stops reactors incl. consensus
        elif self.consensus is not None:
            await self.consensus.stop()
        if self.rpc_server is not None:
            await self.rpc_server.stop()
        if self.grpc_server is not None:
            await self.grpc_server.stop()
        await self.indexer_service.stop()
        await self.event_bus.stop()
        await self.proxy_app.stop()
        if self.mempool is not None:
            self.mempool.close_wal()
        if isinstance(self.priv_validator, Service) and self.priv_validator.is_running:
            await self.priv_validator.stop()
        if self.async_verifier is not None:
            await self.async_verifier.stop()
        if self.batch_verifier is not None:
            uninstall_engine(self.batch_verifier, self.table_cache)
        if self.flight_spool is not None:
            # final synced flush AFTER everything above recorded its last
            # events; an orderly stop leaves a complete spool
            self.flight_spool.close()
