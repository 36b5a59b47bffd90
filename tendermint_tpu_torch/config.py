"""Node configuration, the consensus section so far (the port's copy of
ConsensusConfig from tendermint_tpu/config.py).

Reference parity: config/config.go ConsensusConfig (:758) with its
defaults (:774-790) and the timeout arithmetic (:815-840).  The other
sections, the whole Config and its TOML are ROADMAP 1.6 (node wiring).
"""

from __future__ import annotations

from dataclasses import dataclass


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
