"""Node configuration: the port's copy of tendermint_tpu/config.py, whole.

Reference parity: config/config.go (Config:60 aggregating Base/RPC/P2P/
Mempool/FastSync/Consensus/TxIndex/Instrumentation; consensus timeouts with
per-round linear growth :815-833; TestConfig :792 with millisecond
timeouts; ValidateBasic :855) and config/toml.go (TOML file mapping).
Times are seconds (float) here; per-round growth matches base + delta*round.

Every section, default, `validate_basic` message and the TOML bytes of
`save_config` equal the JAX package's, so one config.toml loads in either
package.  The `[tpu]` section keeps the JAX field names; node.py says what
the port does with each (a mesh and the JAX BLS aggregation raise there).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import List, Optional


@dataclass
class BaseConfig:
    chain_id: str = ""
    moniker: str = "node"
    fast_sync: bool = True
    proxy_app: str = "kvstore"
    abci: str = "socket"
    db_backend: str = "sqlite"
    log_level: str = "info"
    genesis_file: str = "config/genesis.json"
    priv_validator_key_file: str = "config/priv_validator_key.json"
    priv_validator_state_file: str = "data/priv_validator_state.json"
    priv_validator_laddr: str = ""
    node_key_file: str = "config/node_key.json"
    filter_peers: bool = False
    prof_laddr: str = ""
    # consensus key scheme for a GENERATED priv_validator_key (ed25519 |
    # sr25519 | bls12381 | secp256k1); existing key files keep whatever
    # type they carry.  bls12381 unlocks aggregate commits (see
    # [consensus] bls_aggregate_commits).
    key_type: str = "ed25519"


@dataclass
class RPCConfig:
    laddr: str = "tcp://127.0.0.1:26657"
    grpc_laddr: str = ""
    unsafe: bool = False
    max_open_connections: int = 900
    max_subscription_clients: int = 100
    max_subscriptions_per_client: int = 5
    timeout_broadcast_tx_commit: float = 10.0
    max_body_bytes: int = 1000000
    max_header_bytes: int = 1 << 20
    cors_allowed_origins: List[str] = field(default_factory=list)
    # -- ingress admission control (no reference counterpart; overload
    # robustness layer).  Every rejection is EXPLICIT: SERVER_OVERLOADED
    # (-32005) with a retry_after hint — never silent queueing.
    # Per-source token-bucket rate limit on broadcast_tx_* (txs/sec per
    # client address; 0 disables).  One hot client exhausts its own
    # bucket, not the node.
    broadcast_rate: float = 0.0
    broadcast_rate_burst: int = 200
    # Bound on concurrently in-flight broadcast CheckTx work across all
    # sources (0 = unbounded).  broadcast_tx_async used to spawn an
    # unbounded task per request — the firehose-starves-consensus lever.
    max_broadcast_inflight: int = 1024
    # Bound on concurrent broadcast_tx_commit waiters (each holds an
    # event-bus subscription for up to timeout_broadcast_tx_commit; 0 =
    # unbounded).
    max_commit_waiters: int = 64
    # JSON-RPC batch POST length cap: a single request must not fan out
    # into thousands of concurrent handler tasks.
    max_batch_request_items: int = 100


@dataclass
class P2PConfig:
    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    seeds: str = ""
    persistent_peers: str = ""
    upnp: bool = False
    addr_book_file: str = "config/addrbook.json"
    addr_book_strict: bool = True
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10
    unconditional_peer_ids: str = ""
    persistent_peers_max_dial_period: float = 0.0
    flush_throttle_timeout: float = 0.1
    max_packet_msg_payload_size: int = 1024
    send_rate: int = 5120000
    recv_rate: int = 5120000
    pex: bool = True
    seed_mode: bool = False
    private_peer_ids: str = ""
    allow_duplicate_ip: bool = False
    handshake_timeout: float = 20.0
    dial_timeout: float = 3.0
    test_fuzz: bool = False
    test_fuzz_prob_drop: float = 0.02
    test_fuzz_max_delay: float = 0.01


@dataclass
class MempoolConfig:
    recheck: bool = True
    broadcast: bool = True
    wal_dir: str = ""
    size: int = 5000
    max_txs_bytes: int = 1073741824
    cache_size: int = 10000
    max_tx_bytes: int = 1048576
    keep_invalid_txs_in_cache: bool = False
    # Batch-verify ed25519 signed-tx envelopes (mempool.SIGNED_TX_PREFIX)
    # through the shared verify engine BEFORE the ABCI round-trip; a burst
    # of CheckTx calls coalesces into one device/host batch.
    sig_precheck: bool = False
    # Total on-disk bound for the mempool tx WAL (head + rotated chunks;
    # libs/autofile.Group — the consensus WAL's head-size-limit pattern).
    # Under sustained ingress the journal used to grow without limit.
    wal_size_limit: int = 16 * 1024 * 1024
    # Per-peer mempool-gossip pacing: outbound tx frames to one peer are
    # token-bucket paced to this many bytes/sec (0 = unpaced), so tx
    # flooding shares each link with consensus traffic instead of
    # saturating it.  Frames are also capped at broadcast_batch_bytes.
    broadcast_rate_bytes: int = 1048576
    broadcast_batch_bytes: int = 65536

    def as_dict(self) -> dict:
        return {
            "recheck": self.recheck,
            "size": self.size,
            "max_txs_bytes": self.max_txs_bytes,
            "cache_size": self.cache_size,
            "max_tx_bytes": self.max_tx_bytes,
            "keep_invalid_txs_in_cache": self.keep_invalid_txs_in_cache,
            "sig_precheck": self.sig_precheck,
            "wal_size_limit": self.wal_size_limit,
            "broadcast_rate_bytes": self.broadcast_rate_bytes,
            "broadcast_batch_bytes": self.broadcast_batch_bytes,
        }


@dataclass
class FastSyncConfig:
    version: str = "v0"


@dataclass
class StateSyncConfig:
    """Snapshot bootstrap (reference config.StateSyncConfig).  With
    `enable`, a node whose stores are EMPTY restores a peer-served app
    snapshot verified against a lite2 trust root instead of replaying
    from genesis, then fastsyncs the tail.  `rpc_servers` (comma-
    separated) back the light client; `trust_height`/`trust_hash` (hex)
    are the subjective-security root, valid for `trust_period` seconds.

    `snapshot_interval`/`snapshot_chunk_bytes` are the APP side: the
    builtin kvstore takes a snapshot every N heights at commit."""

    enable: bool = False
    rpc_servers: str = ""
    trust_height: int = 0
    trust_hash: str = ""  # hex
    trust_period: float = 168 * 3600.0  # seconds (reference: 168h0m0s)
    discovery_time: float = 3.0  # seconds collecting peer snapshot offers
    chunk_fetch_timeout: float = 10.0  # per-chunk request timeout (seconds)
    chunk_fetch_retries: int = 4  # bounded retries per chunk
    snapshot_interval: int = 0  # app side: snapshot every N heights (0 = off)
    snapshot_chunk_bytes: int = 65536  # app side: chunk size
    # app side: snapshots retained for serving.  Lifetime of a snapshot is
    # keep_recent × interval blocks — on fast chains keep enough that a
    # joiner's discovery + trust-root + chunk fetch fits inside it.
    snapshot_keep_recent: int = 2


@dataclass
class ConsensusConfig:
    wal_file: str = "data/cs.wal/wal"
    # reference defaults (config/config.go:774-790)
    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval: float = 0.0
    peer_gossip_sleep_duration: float = 0.1
    peer_query_maj23_sleep_duration: float = 2.0
    # Event-driven batched gossip (no reference counterpart; the reference
    # polls one vote / one block part per peer_gossip_sleep_duration tick).
    # gossip_vote_batch advertises the vote_batch wire capability in
    # NodeInfo and sends byte-capped vote batches to peers that advertise
    # it back; peers that don't (or a node with the knob off) get the
    # reference's single-vote messages, so mixed-version nets converge.
    gossip_vote_batch: bool = True
    gossip_vote_batch_bytes: int = 65536  # byte cap per vote_batch frame
    # Scale topology (no reference counterpart): full-mesh vote gossip is
    # O(N²) frames per round.  With relay_degree > 0 and more than
    # gossip_relay_min_peers connected peers, event-driven vote pushes go
    # to a deterministic degree-bounded subset per (height, round) (scored
    # by hashing the undirected edge ids, so the subset rotates every round
    # and both ends rank the shared edge identically); everyone else is
    # covered by the repair tick and by maj23 summaries.  0 disables
    # (reference full-mesh behavior); small nets never engage it.
    gossip_relay_degree: int = 8
    gossip_relay_min_peers: int = 12
    # With the relay active, a woken vote routine lingers this long before
    # its pass so concurrent votes coalesce into one frame (the gossip
    # twin of the engine's flush quantum).  Latency cost is debounce ×
    # relay depth (~log_d N hops); the frame count drops ~an order of
    # magnitude at N=100.  Ignored when the relay is off — small nets
    # keep event-latency gossip.
    gossip_relay_debounce: float = 0.05
    # maj23-driven vote aggregation: once this node holds +2/3 for a step
    # it sends capable peers (NodeInfo gossip_version >= 2) a compact
    # have-maj23 + bitmap summary instead of streaming every vote;
    # receivers pull exactly the votes they lack as one vote_batch (one
    # engine flush).  Requires gossip_vote_batch, and engages under the
    # SAME peer-count gate as the relay topology: on a small net the
    # summary→pull→batch round trips (plus the refresh floor) cost a
    # laggard more than just receiving the stream (measured 3× block time
    # at 4 validators).
    gossip_vote_summary: bool = True
    # Wire-level trace context: stamp outbound `vote` / `vote_batch` /
    # `vote_summary` / `block_part` / `proposal` / `agg_commit` frames to
    # capable peers (NodeInfo gossip_version >= 3) with optional origin
    # fields — sender id, monotonic-anchored wall ns at send, content hop
    # count (+1 per relay) — and emit sampled `gossip.hop` recorder
    # events on receipt, so the flight recorder carries the dissemination
    # tree (`net_budget`, tracemerge measured skew, the fleet telescope).
    # Requires the batch + summary tiers below it (capabilities are
    # cumulative); frames to older peers omit the fields, so mixed nets
    # converge exactly like the vote_batch rollout.
    gossip_trace_context: bool = True
    # Flow-control window: block parts transmitted per gossip wakeup
    # (rarest-first across peers instead of pick_random).
    gossip_part_burst: int = 8
    # Propose-side clock sanity (seconds): prevote nil on proposals whose
    # header time is further than this past local now — the node-side twin
    # of lite2's max_clock_drift (defaultMaxClockDrift, 10 s).  0 disables.
    proposal_clock_drift: float = 10.0
    # BLS aggregate commits (crypto/bls, ROADMAP item 2): when the
    # validator set is uniformly BLS12-381, commit assembly folds the +2/3
    # precommits into ONE aggregate signature + signer bitmap, and every
    # commit consumer verifies it with a single pairing check.  The gate
    # is automatic — mixed or non-BLS sets keep per-vote commits — so the
    # knob exists only to A/B the wire format on an all-BLS net.
    bls_aggregate_commits: bool = True
    # -- consensus pipeline (perf, ROADMAP item 3) ------------------------
    # pipeline_delivery: once height H's block + seen commit are persisted
    # (save_block + WAL ENDHEIGHT), ABCI delivery (begin/deliver_tx/end/
    # commit + event publication) runs on a background task while the
    # state machine advances to H+1 under a provisional state.  Everything
    # that READS delivery output (the proposer building H+1's header with
    # H's app_hash, prevote/precommit validation, the next finalize) joins
    # the in-flight delivery first, so commit-to-commit time is bounded by
    # the slowest stage instead of the serial sum.  Crash-safe: the
    # persisted block + the handshake's store_height == state_height + 1
    # replay lane already cover a death between persist and delivery.
    # Off = the reference's strictly serial finalize (the A/B baseline).
    pipeline_delivery: bool = True
    # speculative_assembly: while H delivers, the next proposer pre-reaps
    # the mempool and pre-builds H+1's block + part set, invalidated if
    # the reap inputs change (mempool mutation, different last commit).
    # Only consulted when this node is the H+1 round-0 proposer.
    pipeline_speculative_assembly: bool = True
    # commit_grace: skip_timeout_commit fires only when ALL precommits are
    # in (state.go:1598 skipTimeoutCommit) — one dead validator forfeits
    # the skip forever and every height eats the full timeout_commit.
    # With +2/3 already committed, wait at most this long for stragglers
    # before entering the next round.  0 keeps the reference behavior
    # (full timeout_commit unless has_all).
    commit_grace: float = 0.05

    def propose(self, round_: int) -> float:
        """config.go:815 — base + delta·round."""
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote(self, round_: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit(self, round_: int) -> float:
        return self.timeout_precommit + self.timeout_precommit_delta * round_

    def commit(self, t: float) -> float:
        """Start-time of the next height = commit time + timeout_commit."""
        return t + self.timeout_commit

    def wait_for_txs(self) -> bool:
        return not self.create_empty_blocks or self.create_empty_blocks_interval > 0


@dataclass
class TPUConfig:
    """The batch-verify engine (no reference counterpart — the north star).

    With `enabled`, node startup builds a BatchVerifier, installs it as the
    process-wide crypto.batch hook (so verify_commit / fastsync replay /
    lite2 hit the device path) and runs an AsyncBatchVerifier feeding the
    consensus reactor's vote ingress."""

    enabled: bool = True
    flush_interval: float = 0.002  # async batcher coalescing cap (seconds)
    flush_min: float = 0.0002  # adaptive quiet-window floor (seconds)
    flush_adaptive: bool = True  # arrival-rate-adaptive flush quantum
    max_batch: int = 4096
    # Mesh policy for sharding the verify batch axis across devices:
    #   "auto" — shard whenever >1 real accelerator device is visible
    #            (virtual/host CPU device counts are ignored so forcing
    #            XLA_FLAGS host device counts in tests doesn't silently
    #            shard every node);
    #   "on"   — shard over whatever devices exist, any platform (smokes,
    #            dryruns, CPU-mesh CI);
    #   "off"  — never shard.
    mesh: str = "auto"
    mesh_devices: int = 0  # 0 = use all visible; N caps the shard count
    min_device_batch: int = 16  # below this, serial host verify wins
    # Double-buffered single-shot chunking (large indexed commits):
    # chunk_size 0 = engine default (2048); chunk_depth bounds how many
    # donated chunks may be in flight ahead of the device.
    chunk_size: int = 0
    chunk_depth: int = 2
    # Tabulated zero-doubling kernel: "auto" profiles break-even once per
    # process and engages only where it wins; "on"/"off" force it.
    tabulated: str = "auto"
    # Route BLS multi-point aggregation (Σpk / Σsig of aggregate commits)
    # through the batched JAX tier (crypto/bls/jax_tier).  OFF by default:
    # on CPU-only hosts the pure-python fold wins below committee scale
    # (measured ~5 ms vs ~200 ms warm + a multi-second compile at N=100 on
    # a 2-core container); flip on for real device meshes.
    bls_jax_aggregation: bool = False


@dataclass
class ChaosConfig:
    """Deterministic fault injection (chaos/ package; no reference
    counterpart — the reference scatters this across p2p/fuzz.go, the
    byzantine tests and the external Jepsen harness).

    With `enabled`, the node builds a runtime-controllable LinkPolicyTable
    (per-peer directional drop/delay/throttle — partitions that can form
    and HEAL), exposes the `unsafe_chaos_*` RPC control routes (which
    additionally require rpc.unsafe), honors `clock_skew`, and — with
    `twin` — wraps its privval in a TwinSigner that BYPASSES the
    double-sign guard and equivocates on prevotes from genesis.  Never
    enable on a production node; `twin` is the attack the accountability
    pipeline slashes."""

    enabled: bool = False
    seed: int = 0  # drives every probabilistic fault decision + jitter
    twin: bool = False  # this node double-signs (requires enabled)
    clock_skew: float = 0.0  # seconds added to this node's consensus wall clock


@dataclass
class StorageConfig:
    """Store integrity + disk-fault degradation (store/block_store.py seal
    + quarantine + libs/watchdog.py StorageHealth; no reference
    counterpart — the reference trusts goleveldb's internal CRCs and has
    no recovery story past them).

    The boot scan verifies block-store content against identity (per-entry
    crc seals + reassembled block hash vs meta) and QUARANTINES corrupt
    heights, which the fastsync refill machinery then re-fetches from
    peers — self-healing instead of serving rot or wedging.
    `integrity_scan_limit` bounds the boot sweep to the most recent N
    heights (0 = full scan; a deep archive node pays the full sweep only
    when asked via the unsafe_store_integrity_scan route)."""

    integrity_scan_on_boot: bool = True
    integrity_scan_limit: int = 512
    # disk_pressure watchdog alarm threshold: free bytes on the data dir's
    # filesystem below which the node self-reports BEFORE the first ENOSPC
    min_free_bytes: int = 128 * 1024 * 1024


@dataclass
class TxIndexConfig:
    indexer: str = "kv"  # kv | null


@dataclass
class LiteServeConfig:
    """Multi-tenant light-client verification gateway (liteserve/).

    With `enable`, the node (or the standalone `liteserve` CLI) serves
    `lite_*` JSON-RPC routes off one shared verification engine:
    `primary`/`witnesses` are the provider RPC addresses,
    `trust_height`/`trust_hash` the gateway's own subjective root (same
    semantics as [statesync]).  `cache_capacity` bounds the shared
    commit-verification LRU; `max_sessions` bounds the tenant table, with
    `session_rate`/`create_rate` token buckets enforcing the
    explicit-overload discipline (-32005 + retry_after, never silent
    queueing).  `witness_quorum` witnesses are rotated in per
    verification pass from the diversity pool."""

    enable: bool = False
    laddr: str = "tcp://127.0.0.1:8899"
    primary: str = ""
    witnesses: str = ""  # comma-separated RPC addresses
    trust_height: int = 0
    trust_hash: str = ""  # hex
    trust_period: float = 168 * 3600.0  # seconds
    cache_capacity: int = 4096
    max_sessions: int = 4096
    idle_timeout: float = 300.0  # seconds before an idle session is evictable
    session_rate: float = 0.0  # per-session requests/sec (0 = unlimited)
    session_burst: int = 50
    create_rate: float = 0.0  # per-source session creates/sec (0 = unlimited)
    create_burst: int = 20
    witness_quorum: int = 2
    witness_timeout: float = 3.0  # per-witness cross-check timeout (seconds)
    rotation_seed: int = 0
    max_body_bytes: int = 1_000_000


@dataclass
class InstrumentationConfig:
    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    max_open_connections: int = 3
    namespace: str = "tendermint"
    # Flight recorder (libs/tracing.py): always-on ring of hot-path span
    # events (consensus steps, verify-engine flush/dispatch/compile),
    # served by the dump_flight_recorder RPC route and the `trace` CLI.
    # Independent of `prometheus` — the recorder has no listener of its
    # own and costs ~1 µs/event, so it defaults on.
    flight_recorder: bool = True
    flight_recorder_size: int = 8192
    # 1-in-N sampling for HIGH-RATE recorder kinds (gossip.wakeup fires
    # per wakeup; gossip.hop fires per traced frame received — at N=100
    # either can evict the whole ring between commits).  Sampled events
    # carry `sampled=N` so consumers re-scale; 1 (default) records
    # everything — the small-net behavior.  Trace-context stamping itself
    # is not sampled (relays always need the hop count); only the
    # recorder emission is.
    trace_sample_high_rate: int = 1
    # Asyncio scheduler profiler (libs/loopprof.py): loop-lag probe,
    # per-category task time accounting through Service.spawn, GC-pause
    # hooks and queue-depth gauges — the `tendermint_loop_*` family plus
    # `loop.*` recorder events.  Like the recorder it has no listener of
    # its own; the accounting trampoline costs ~1 µs per task resume, so
    # it defaults on.  `false` is a true no-op (spawn pays one None check).
    loop_profiler: bool = True
    loop_probe_interval: float = 0.25
    # Crash-persistent flight spool (libs/tracing.FlightSpool): a size-
    # capped rotating on-disk journal of recorder events, flushed on a
    # cadence OFF the recording hot path (plus on excepthook/atexit/node
    # stop), so a SIGKILLed or OOMed node leaves its last seconds of span
    # events on disk for `debug dump` / trace-net to replay offline.
    # Opt-in: it costs ~one small buffered write per flush interval.
    flight_spool: bool = False
    flight_spool_path: str = "data/flight.spool"
    flight_spool_flush_interval: float = 0.25
    flight_spool_size_limit: int = 4 * 1024 * 1024
    # Health watchdog (libs/watchdog.py): periodic self-diagnosis —
    # consensus stall, round churn, peer collapse, verify-queue stall,
    # event-loop lag, mempool saturation, wall-vs-monotonic clock drift —
    # exported as tendermint_health_* gauges, an ok/degraded/critical
    # verdict on the /health RPC route and a `health` block in /status,
    # with health.alarm/health.clear recorder events on transitions and a
    # rate-bounded forensics auto-bundle on the critical transition.
    watchdog: bool = True
    watchdog_interval: float = 2.0
    # stall: tip not advancing for this long while caught_up (monotonic
    # clock — injected wall skew must not fake or mask a stall)
    watchdog_stall_seconds: float = 30.0
    watchdog_round_churn: int = 4
    watchdog_verify_stall_seconds: float = 5.0
    watchdog_lag_ms: float = 1000.0
    watchdog_mempool_ratio: float = 0.9
    # sustained explicit overload rejections per second (two consecutive
    # ticks over the bound): the QoS layer shedding correctly is still a
    # node that cannot serve its offered load.  0 disables.
    watchdog_shed_rate: float = 5.0
    # wall-vs-monotonic divergence since watchdog start; a CONSTANT offset
    # (NTP being early/late, [chaos] clock_skew from boot) is not drift
    watchdog_clock_drift_seconds: float = 2.0
    # peer collapse: alarm when the live peer count falls below half of
    # the peak this node has seen (and the peak was at least min_peers)
    watchdog_min_peers: int = 2
    watchdog_autodump: bool = True
    watchdog_autodump_min_interval: float = 60.0
    # disk_fault alarm: held this long past the last storage fault (a
    # component HALTED on persistence stays critical until restart)
    watchdog_disk_fault_hold: float = 30.0


@dataclass
class Config:
    home: str = "~/.tendermint_tpu"
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    fast_sync: FastSyncConfig = field(default_factory=FastSyncConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    instrumentation: InstrumentationConfig = field(default_factory=InstrumentationConfig)
    liteserve: LiteServeConfig = field(default_factory=LiteServeConfig)

    # -- paths -------------------------------------------------------------
    def _join(self, p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(os.path.expanduser(self.home), p)

    def genesis_file(self) -> str:
        return self._join(self.base.genesis_file)

    def priv_validator_key_file(self) -> str:
        return self._join(self.base.priv_validator_key_file)

    def priv_validator_state_file(self) -> str:
        return self._join(self.base.priv_validator_state_file)

    def node_key_file(self) -> str:
        return self._join(self.base.node_key_file)

    def wal_file(self) -> str:
        return self._join(self.consensus.wal_file)

    def addr_book_file(self) -> str:
        return self._join(self.p2p.addr_book_file)

    def mempool_wal_dir(self) -> str:
        return self._join(self.mempool.wal_dir)

    def flight_spool_file(self) -> str:
        return self._join(self.instrumentation.flight_spool_path)

    def db_dir(self) -> str:
        return self._join("data")

    def ensure_dirs(self) -> None:
        for sub in ("config", "data"):
            os.makedirs(self._join(sub), exist_ok=True)

    def validate_basic(self) -> None:
        """config.go:855."""
        if self.base.db_backend not in ("sqlite", "memdb"):
            raise ValueError(f"unknown db_backend {self.base.db_backend!r}")
        from .crypto.keys import KEY_TYPES

        if self.base.key_type not in KEY_TYPES:
            raise ValueError(
                f"unknown base.key_type {self.base.key_type!r} (want one of {KEY_TYPES})"
            )
        for name, v in (
            ("timeout_propose", self.consensus.timeout_propose),
            ("timeout_prevote", self.consensus.timeout_prevote),
            ("timeout_precommit", self.consensus.timeout_precommit),
            ("timeout_commit", self.consensus.timeout_commit),
            ("commit_grace", self.consensus.commit_grace),
        ):
            if v < 0:
                raise ValueError(f"consensus.{name} can't be negative")
        if self.mempool.size < 0:
            raise ValueError("mempool.size can't be negative")
        if self.mempool.wal_size_limit < 4096:
            raise ValueError("mempool.wal_size_limit must be >= 4096")
        if self.mempool.broadcast_rate_bytes < 0:
            raise ValueError("mempool.broadcast_rate_bytes can't be negative")
        if self.mempool.broadcast_batch_bytes < 1024:
            raise ValueError("mempool.broadcast_batch_bytes must be >= 1024")
        if self.rpc.max_open_connections < 0:
            raise ValueError("rpc.max_open_connections can't be negative")
        if self.rpc.broadcast_rate < 0:
            raise ValueError("rpc.broadcast_rate can't be negative")
        if self.rpc.broadcast_rate_burst < 1:
            raise ValueError("rpc.broadcast_rate_burst must be >= 1")
        if self.rpc.max_broadcast_inflight < 0:
            raise ValueError("rpc.max_broadcast_inflight can't be negative")
        if self.rpc.max_commit_waiters < 0:
            raise ValueError("rpc.max_commit_waiters can't be negative")
        if self.rpc.max_batch_request_items < 1:
            raise ValueError("rpc.max_batch_request_items must be >= 1")
        if self.fast_sync.version not in ("v0", "v2"):
            raise ValueError(f"unknown fastsync version {self.fast_sync.version!r}")
        if self.instrumentation.flight_recorder_size < 1:
            raise ValueError("instrumentation.flight_recorder_size must be >= 1")
        if self.instrumentation.trace_sample_high_rate < 1:
            raise ValueError("instrumentation.trace_sample_high_rate must be >= 1")
        if self.instrumentation.loop_probe_interval <= 0:
            raise ValueError("instrumentation.loop_probe_interval must be > 0")
        inst = self.instrumentation
        if inst.flight_spool_flush_interval <= 0:
            raise ValueError("instrumentation.flight_spool_flush_interval must be > 0")
        if inst.flight_spool_size_limit < 4096:
            raise ValueError("instrumentation.flight_spool_size_limit must be >= 4096")
        if inst.watchdog_interval <= 0:
            raise ValueError("instrumentation.watchdog_interval must be > 0")
        if inst.watchdog_stall_seconds <= 0:
            raise ValueError("instrumentation.watchdog_stall_seconds must be > 0")
        if inst.watchdog_round_churn < 1:
            raise ValueError("instrumentation.watchdog_round_churn must be >= 1")
        if not 0 < inst.watchdog_mempool_ratio <= 1.0:
            raise ValueError("instrumentation.watchdog_mempool_ratio must be in (0, 1]")
        if inst.watchdog_shed_rate < 0:
            raise ValueError("instrumentation.watchdog_shed_rate can't be negative")
        if inst.watchdog_clock_drift_seconds <= 0:
            raise ValueError("instrumentation.watchdog_clock_drift_seconds must be > 0")
        if inst.watchdog_autodump_min_interval < 0:
            raise ValueError(
                "instrumentation.watchdog_autodump_min_interval can't be negative"
            )
        if self.consensus.gossip_part_burst < 1:
            raise ValueError("consensus.gossip_part_burst must be >= 1")
        if self.consensus.gossip_vote_batch_bytes < 1024:
            raise ValueError("consensus.gossip_vote_batch_bytes must be >= 1024")
        if self.consensus.gossip_relay_degree < 0:
            raise ValueError("consensus.gossip_relay_degree can't be negative")
        if self.consensus.gossip_relay_min_peers < 0:
            raise ValueError("consensus.gossip_relay_min_peers can't be negative")
        if self.consensus.gossip_relay_debounce < 0:
            raise ValueError("consensus.gossip_relay_debounce can't be negative")
        ss = self.statesync
        if ss.enable:
            if not ss.rpc_servers.strip():
                raise ValueError("statesync.enable requires statesync.rpc_servers")
            if ss.trust_height < 1:
                raise ValueError("statesync.enable requires statesync.trust_height >= 1")
            try:
                if len(bytes.fromhex(ss.trust_hash)) != 32:
                    raise ValueError
            except ValueError:
                raise ValueError("statesync.trust_hash must be 32 hex-encoded bytes")
        if ss.snapshot_interval < 0:
            raise ValueError("statesync.snapshot_interval can't be negative")
        if ss.snapshot_chunk_bytes < 1:
            raise ValueError("statesync.snapshot_chunk_bytes must be >= 1")
        if ss.snapshot_keep_recent < 1:
            raise ValueError("statesync.snapshot_keep_recent must be >= 1")
        if ss.chunk_fetch_retries < 0:
            raise ValueError("statesync.chunk_fetch_retries can't be negative")
        if self.chaos.twin and not self.chaos.enabled:
            raise ValueError("chaos.twin requires chaos.enabled")
        if self.chaos.clock_skew != 0.0 and not self.chaos.enabled:
            raise ValueError("chaos.clock_skew requires chaos.enabled")
        if self.tpu.mesh not in ("auto", "on", "off"):
            raise ValueError(f"unknown tpu.mesh {self.tpu.mesh!r} (want auto|on|off)")
        if self.tpu.mesh_devices < 0:
            raise ValueError("tpu.mesh_devices can't be negative")
        if self.tpu.chunk_size < 0:
            raise ValueError("tpu.chunk_size can't be negative")
        if self.tpu.chunk_depth < 1:
            raise ValueError("tpu.chunk_depth must be >= 1")
        if self.tpu.tabulated not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown tpu.tabulated {self.tpu.tabulated!r} (want auto|on|off)"
            )
        if self.storage.integrity_scan_limit < 0:
            raise ValueError("storage.integrity_scan_limit can't be negative")
        if self.storage.min_free_bytes < 0:
            raise ValueError("storage.min_free_bytes can't be negative")
        if inst.watchdog_disk_fault_hold < 0:
            raise ValueError("instrumentation.watchdog_disk_fault_hold can't be negative")


def default_config(home: str = "~/.tendermint_tpu") -> Config:
    return Config(home=home)


def test_config(home: str) -> Config:
    """Millisecond timeouts for in-proc tests (config.go:792 TestConfig)."""
    cfg = Config(home=home)
    cfg.consensus = ConsensusConfig(
        wal_file="data/cs.wal/wal",
        timeout_propose=0.1,
        timeout_propose_delta=0.002,
        timeout_prevote=0.02,
        timeout_prevote_delta=0.002,
        timeout_precommit=0.02,
        timeout_precommit_delta=0.002,
        timeout_commit=0.02,
        skip_timeout_commit=True,
        peer_gossip_sleep_duration=0.005,
        peer_query_maj23_sleep_duration=0.25,
    )
    cfg.base.fast_sync = False
    cfg.p2p.laddr = ""  # tests opt into p2p with an explicit 127.0.0.1:0
    # test nets share 127.0.0.1 (config.go TestP2PConfig AllowDuplicateIP)
    cfg.p2p.allow_duplicate_ip = True
    # host verify is faster than XLA compiles at test scale; engine tests
    # turn the device path back on explicitly
    cfg.tpu.enabled = False
    return cfg


# -- TOML round-trip (config/toml.go) ---------------------------------------


def save_config(cfg: Config, path: str) -> None:
    """Write the config as TOML (sections mirror the reference file)."""
    import dataclasses

    lines = ["# tendermint_tpu config\n"]
    sections = {
        "": cfg.base,
        "rpc": cfg.rpc,
        "p2p": cfg.p2p,
        "mempool": cfg.mempool,
        "fastsync": cfg.fast_sync,
        "statesync": cfg.statesync,
        "consensus": cfg.consensus,
        "tpu": cfg.tpu,
        "chaos": cfg.chaos,
        "storage": cfg.storage,
        "tx_index": cfg.tx_index,
        "instrumentation": cfg.instrumentation,
        "liteserve": cfg.liteserve,
    }
    for name, section in sections.items():
        if name:
            lines.append(f"\n[{name}]\n")
        for f in dataclasses.fields(section):
            v = getattr(section, f.name)
            if isinstance(v, bool):
                sv = "true" if v else "false"
            elif isinstance(v, (int, float)):
                sv = str(v)
            elif isinstance(v, list):
                sv = "[" + ", ".join(f'"{x}"' for x in v) + "]"
            else:
                sv = f'"{v}"'
            lines.append(f"{f.name} = {sv}\n")
    with open(path, "w") as fh:
        fh.writelines(lines)


def load_config(path: str, home: Optional[str] = None) -> Config:
    import dataclasses

    import tomllib

    with open(path, "rb") as fh:
        data = tomllib.load(fh)
    cfg = Config(home=home or os.path.dirname(os.path.dirname(path)))

    def apply(section_obj, d: dict):
        names = {f.name for f in dataclasses.fields(section_obj)}
        for k, v in d.items():
            if k in names and not isinstance(v, dict):
                setattr(section_obj, k, v)

    apply(cfg.base, {k: v for k, v in data.items() if not isinstance(v, dict)})
    apply(cfg.rpc, data.get("rpc", {}))
    apply(cfg.p2p, data.get("p2p", {}))
    apply(cfg.mempool, data.get("mempool", {}))
    apply(cfg.fast_sync, data.get("fastsync", {}))
    apply(cfg.statesync, data.get("statesync", {}))
    apply(cfg.consensus, data.get("consensus", {}))
    apply(cfg.tpu, data.get("tpu", {}))
    apply(cfg.chaos, data.get("chaos", {}))
    apply(cfg.storage, data.get("storage", {}))
    apply(cfg.tx_index, data.get("tx_index", {}))
    apply(cfg.instrumentation, data.get("instrumentation", {}))
    apply(cfg.liteserve, data.get("liteserve", {}))
    return cfg
