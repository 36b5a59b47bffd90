"""Consensus reactor: bridges the state machine to the p2p switch (the port's
copy of tendermint_tpu/consensus/reactor.py; its frames' bytes equal the JAX
package's).

One deviation from the JAX reactor (ROADMAP 3): no fallback hides the
engine.  The JAX reactor drops a vote_batch frame
  whose engine call raises, and reads a single vote whose engine call
  raises as badly signed (the peer is stopped).  Here an error of the
  engine itself (crypto.batch.EngineError) logs at ERROR and raises
  p2p.LocalFault, which fails the connection's receive task: an engine
  fault of this node is never read as the peer's.  Only the engine call
  sits inside that `try`; any other exception is the peer's data and
  reaches the connection, which stops the peer.  A False verdict keeps the
  JAX behaviour exactly.

Reference parity: consensus/reactor.go (channels 0x20-0x23 :24-27,
Receive:214 demux, SwitchToConsensus:102, broadcastHasVoteMessage:422,
gossipDataRoutine:467, gossipVotesRoutine:606, queryMaj23Routine:738,
PeerState:915).

TPU inversion #1 (SURVEY.md §7): peer votes are signature-checked BEFORE
they enter the serialized consensus loop — each per-peer receive task
enqueues into the shared AsyncBatchVerifier whose deadline flush coalesces
concurrent votes from all peers into one device batch; consensus then adds
them with verify=False.  Trickling votes at 10k validators become a few
vmapped kernel calls per round instead of 10k serial host verifies.

TPU inversion #2 (this layer): gossip is EVENT-DRIVEN and BATCHED, not
sleep-polled.  The reference sends one vote or one block part per peer per
`peer_gossip_sleep_duration` tick (reactor.go:606/467), which makes
propagation latency a multiple of the tick and feeds the batch verifier
one vote at a time.  Here consensus state changes (new vote, new proposal,
new block part, round step) set per-peer wakeup events; a woken vote
routine sends EVERY vote the peer lacks in one byte-capped `vote_batch`
frame (encoded once, reused across peers), and the receive side enqueues
the whole decoded batch into the AsyncBatchVerifier as one call — one
flush, one host-prep pass, matching the engine's batch shape.  Block
parts go out in rarest-first bursts up to a flow-control window.  The
fixed sleep survives only as a fallback cap, so the tick can be raised
without adding latency.  The gossip paper contract (arXiv:1807.04938:
eventual delivery) is unchanged; only the pacing is.

TPU inversion #3 (committee scale): full-mesh vote gossip is O(N²) frames
per round — at 100 validators every vote crosses every link and every
vote added triggers a has_vote broadcast to every peer, which is exactly
the fan-out wall arXiv:2302.00418 measures for committee consensus.  With
`consensus.gossip_relay_degree` (and enough peers), event-driven vote
pushes go to a deterministic O(d) relay subset per (height, round) —
edges are scored by hashing the undirected (height, round, id-pair), so
the subset rotates every round, both ends rank their shared edge
identically, and the union of 100 nodes' relay choices forms an expander
whp.  The repair tick (the fallback cap) still scans EVERY peer, so
completeness is a pacing property, not a topology property.  On top of
that rides maj23-driven aggregation: once this node holds +2/3 for a
step, capable peers get a compact `vote_summary` (have-maj23 + our vote
bitmap) instead of a vote stream; a receiver diffs the bitmap against
its own set and answers `vote_pull` with exactly the bits it lacks, and
the pulled `vote_batch` lands in the engine as ONE verify_many flush.

Wire compatibility: `vote_batch` (and the summary exchange) is negotiated
via NodeInfo.gossip_version (p2p/node_info.py) — peers that never
advertised it (older nodes, or `consensus.gossip_vote_batch = false`)
receive the reference's single-vote messages, peers at version 1 get
batches but no summaries, so mixed-version nets still converge.  Version
3 adds wire-level trace context: frames to capable peers carry optional
origin fields (`o`/`ow`/`hp`) and receivers emit sampled `gossip.hop`
recorder events, so the flight recorder carries the dissemination tree
(libs/tracing.net_budget consumes it).  Frames to older peers omit the
fields; received unknown fields were always ignored, so rollout is
exactly the vote_batch rollout.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
import time
from typing import Dict, List, Optional, Set, Tuple, Union

from ..crypto.batch import EngineError
from ..encoding import codec
from ..libs.bitarray import BitArray
from ..libs.log import get_logger
from ..p2p import ChannelDescriptor, LocalFault, Reactor
from ..p2p.node_info import (
    GOSSIP_BATCH_VERSION,
    GOSSIP_SUMMARY_VERSION,
    GOSSIP_TRACE_VERSION,
)
from ..types.agg_commit import AggregateCommit, AggregateLastCommit
from ..types.block import BlockID, PartSetHeader
from ..types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from ..types.part_set import Part
from ..types.proposal import Proposal
from ..types.vote import Vote
from .state import ConsensusState
from .types import RoundStep

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23

# A vote_batch frame may not claim more entries than a vote set can hold;
# decode stops a peer exceeding it before any per-vote work happens.
MAX_VOTE_BATCH_ENTRIES = 16384

# Received batches at least this big skip the AsyncBatchVerifier's
# coalescing flusher and go to the engine as one direct call — they are
# already batch-shaped, and the flusher's scheduling hops dominate at
# committee scale (smaller trickles still coalesce across peers).
DIRECT_VERIFY_MIN = 16

# Wire-level trace context (gossip_version >= 3): outbound frames to
# capable peers carry `o` (origin/sender node id prefix), `ow` (sender
# wall ns at send, monotonic-anchored via the recorder's wall fn so
# chaos clock skew is visible), `hp` (content hop count: 0 = the
# content originated at the sender, +1 per relay).  Both fields are
# attacker-suppliable, so receivers CLAMP before recording: a hop
# outside [0, TRACE_MAX_HOP] or an origin timestamp further than
# TRACE_MAX_LAT_NS from our wall clock marks the gossip.hop event
# `clamped` and withholds the latency sample from skew estimation —
# a byzantine peer can inflate the clamp counter, never the measured
# offsets (the dissemination-tree analogue of the vote_batch entry cap).
TRACE_MAX_HOP = 64
TRACE_MAX_LAT_NS = 60 * 1_000_000_000  # ±60 s sanity window
# hop-context table bound: one entry per in-flight proposal/part/agg
# key; eviction only costs a relay restarting its hop count at 0
TRACE_CTX_CAP = 1024


class PeerRoundState:
    """What we know about a peer's consensus position
    (consensus/types/peer_round_state.go + reactor.go:915 PeerState).

    Per-peer state is BOUNDED for committee scale: every container here
    that is keyed by a peer-suppliable round (the vote bit tables) or by
    (height, round, type) tuples (the dedupe maps) is capped — at N=100
    validators × 100 peers an unbounded O(rounds) table per peer is an
    O(N × rounds) allocation a stuck height grows forever, and a hostile
    peer can mint arbitrary round numbers in has_vote messages."""

    # Vote bit tables keep only the highest MAX_TRACKED_ROUNDS rounds per
    # type; dedupe maps (maj23_sent / summary_sent) prune expired entries
    # past MAX_SENT_ENTRIES.  Both are repair-safe: evicting an entry only
    # means one redundant re-send, never a lost vote.
    MAX_TRACKED_ROUNDS = 64
    MAX_SENT_ENTRIES = 256

    def __init__(self):
        self.height = 0
        self.round = -1
        self.step = RoundStep.NEW_HEIGHT
        self.start_time = 0.0
        self.proposal = False
        self.proposal_block_parts_header = None
        self.proposal_block_parts: Optional[BitArray] = None
        self.proposal_pol_round = -1
        self.proposal_pol: Optional[BitArray] = None
        self.prevotes: Dict[int, BitArray] = {}  # round -> bits
        self.precommits: Dict[int, BitArray] = {}
        self.last_commit_round = -1
        self.last_commit: Optional[BitArray] = None
        # Event-driven gossip: consensus state changes (and peer messages
        # that change what we could send) set these; the gossip routines
        # wait on them with peer_gossip_sleep_duration as a fallback cap.
        self.data_wake = asyncio.Event()
        self.vote_wake = asyncio.Event()
        # maj23 claims already sent to this peer: (height, round, type,
        # block_key) -> monotonic send time.  Stops _query_maj23_routine
        # re-sending identical claims every tick; entries expire so the
        # VoteSetBits repair exchange can still re-fire for a stuck peer.
        self.maj23_sent: Dict[tuple, float] = {}
        # vote_summary dedupe: (height, round, type) -> (bit count at last
        # send, monotonic send time).  Re-sent when our set grew (laggards
        # can pull the new votes) or after expiry (lost-frame repair).
        self.summary_sent: Dict[tuple, Tuple[int, float]] = {}
        # aggregate-commit catchup dedupe: (height last shipped, monotonic
        # send time).  A folded height has no per-vote precommits to
        # gossip, so catchup ships the stored AggregateCommit once per
        # stuck height, re-sent on a coarse timer (lost-frame repair).
        self.agg_commit_sent: Tuple[int, float] = (0, 0.0)
        # round-state re-announce dedupe: ((height, round, step) last
        # announced to THIS peer, monotonic send time) — the maj23 tick's
        # liveness repair for beliefs gone stale across a message-level
        # partition (see _query_maj23_routine).
        self.nrs_sent: Tuple[Optional[tuple], float] = (None, 0.0)

    # -- updates from peer messages ---------------------------------------
    def apply_new_round_step(self, msg: dict) -> None:
        """reactor.go ApplyNewRoundStepMessage."""
        psh, psr = self.height, self.round
        self.height = msg["height"]
        self.round = msg["round"]
        self.step = msg["step"]
        if psh != self.height or psr != self.round:
            self.proposal = False
            self.proposal_block_parts_header = None
            self.proposal_block_parts = None
            self.proposal_pol_round = -1
            self.proposal_pol = None
        if psh != self.height:
            # peer's prevotes/precommits for the old height are irrelevant
            if psh == self.height - 1 and msg.get("last_commit_round", -1) >= 0:
                self.last_commit_round = msg["last_commit_round"]
                self.last_commit = self.precommits.get(self.last_commit_round)
            else:
                self.last_commit_round = msg.get("last_commit_round", -1)
                self.last_commit = None
            self.prevotes = {}
            self.precommits = {}
            self.maj23_sent.clear()
            self.summary_sent.clear()

    def apply_new_valid_block(self, msg: dict) -> None:
        if self.height != msg["height"]:
            return
        if self.round != msg["round"] and not msg["is_commit"]:
            return
        self.proposal_block_parts_header = PartSetHeader.from_dict(msg["block_parts_header"])
        self.proposal_block_parts = BitArray.from_bytes(msg["block_parts"])

    def set_has_proposal(self, proposal: Proposal) -> None:
        if self.height != proposal.height or self.round != proposal.round:
            return
        if self.proposal:
            return
        self.proposal = True
        if self.proposal_block_parts is None:
            self.proposal_block_parts_header = proposal.block_id.parts_header
            self.proposal_block_parts = BitArray(proposal.block_id.parts_header.total)
        self.proposal_pol_round = proposal.pol_round

    def set_has_proposal_block_part(self, height: int, round_: int, index: int) -> None:
        if self.height != height or self.round != round_:
            return
        if self.proposal_block_parts is None:
            return
        self.proposal_block_parts.set_index(index, True)

    def apply_proposal_pol(self, msg: dict) -> None:
        if self.height != msg["height"]:
            return
        if self.proposal_pol_round != msg["proposal_pol_round"]:
            return
        self.proposal_pol = BitArray.from_bytes(msg["proposal_pol"])

    def get_vote_bits(self, height: int, round_: int, vote_type: int, num_validators: int) -> Optional[BitArray]:
        if height == self.height:
            table = self.prevotes if vote_type == PREVOTE_TYPE else self.precommits
            if round_ not in table:
                table[round_] = BitArray(num_validators)
                # bound: rounds are peer-suppliable (has_vote / summary
                # messages carry arbitrary ints) — keep the newest only.
                # If the round we just inserted IS the oldest, it is
                # refused tracking (None, same as an unresolvable claim)
                # rather than evicting a newer live round.
                while len(table) > self.MAX_TRACKED_ROUNDS:
                    victim = min(table)
                    del table[victim]
                    if victim == round_:
                        return None
            return table[round_]
        if height == self.height - 1 and vote_type == PRECOMMIT_TYPE and round_ == self.last_commit_round:
            if self.last_commit is None:
                self.last_commit = BitArray(num_validators)
            return self.last_commit
        return None

    def prune_sent(self, table: Dict[tuple, object], now: float, expired_before: float) -> None:
        """Cap a (maj23/summary) dedupe map: drop expired entries once the
        map exceeds MAX_SENT_ENTRIES, then oldest-first if still over."""
        if len(table) <= self.MAX_SENT_ENTRIES:
            return
        for k in [k for k, v in table.items() if _sent_time(v) < expired_before]:
            del table[k]
        while len(table) > self.MAX_SENT_ENTRIES:
            del table[min(table, key=lambda k: _sent_time(table[k]))]

    def set_has_vote(self, height: int, round_: int, vote_type: int, index: int, num_validators: int = 0) -> None:
        bits = self.get_vote_bits(height, round_, vote_type, num_validators)
        if bits is not None and index < bits.bits:
            bits.set_index(index, True)

    def apply_vote_set_bits(
        self, msg: dict, our_votes: Optional[BitArray], num_validators: int = -1
    ) -> None:
        """reactor.go ApplyVoteSetBitsMessage: the peer's response is the
        TRUTH for the claimed vote set — replace that slice of our belief,
        `(existing − ourVotes) ∪ theirBits`, keeping only the bits outside
        the set.  This must be able to CLEAR bits: a vote we marked as
        delivered that the peer never received (send raced a disconnect,
        message lost in a lossy link) is otherwise never re-gossiped, and
        a node missing one prevote wedges at step PREVOTE with no timeout
        pending — the maj23/VoteSetBits exchange is the designed repair.

        `num_validators` (our validator-set size for the claimed height)
        clamps the allocation: the wire bitmap's length header is
        attacker-suppliable, and sizing a fresh per-round BitArray from it
        let one frame allocate gigabytes.  0 = the height doesn't resolve
        to a set we hold — skip entirely (like the vote_batch/summary
        receive paths) rather than create a permanent zero-size entry:
        get_vote_bits sizes only on creation, and a 0-bit belief array
        makes set_has_vote a no-op, so every later send pass would see
        every vote missing and resend the full batch forever."""
        if num_validators == 0:
            return
        bits = BitArray.from_bytes(msg["votes"])
        size = bits.bits if num_validators < 0 else min(bits.bits, num_validators)
        existing = self.get_vote_bits(msg["height"], msg["round"], msg["type"], size)
        if existing is None:
            return
        n = min(existing.bits, bits.bits)
        if our_votes is not None:
            merged = existing.sub(our_votes).or_(bits)
        else:
            merged = bits
        existing._v[:n] = merged._v[:n]


class ConsensusReactor(Reactor):
    def __init__(self, cs: ConsensusState, wait_sync: bool = False, async_verifier=None):
        super().__init__("consensus-reactor")
        self.cs = cs
        self.wait_sync = wait_sync  # True while fast-syncing
        self.async_verifier = async_verifier  # AsyncBatchVerifier or None
        self.log = get_logger("cs-reactor")
        self.peer_states: Dict[str, PeerRoundState] = {}
        self._routines: Dict[str, list] = {}
        # relay topology: memoized target set for the current
        # (height, round, peer-set generation) — recomputed lazily, so a
        # burst of vote events at N=100 pays one hash ranking, not N
        self._relay_cache: Optional[Tuple[tuple, Optional[Set[str]]]] = None
        self._peer_gen = 0  # bumped on peer add/remove; invalidates cache
        # encode-once block-part streaming (the Vote.wire() move applied
        # to parts): each part's full wire frame is codec-encoded once per
        # (height, round, index) and reused across every peer send — at
        # N peers that is N−1 fewer 64 KiB encodes per part.  Bounded
        # FIFO; a full block is ~16 parts, so 256 covers the live height
        # plus plenty of catchup traffic.
        from collections import OrderedDict

        self._part_frames: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._part_frames_cap = 256
        # wire-level trace context: received content hop counts keyed by
        # ("prop", h, r) / ("part", h, r, idx) / ("agg", h) so relayed
        # frames can be stamped hop+1 (absence = we originated → hop 0).
        # Independent of gossip.hop sampling — relays always need it.
        self._trace_hops: "OrderedDict[tuple, int]" = OrderedDict()
        self._trace_id = ""  # our node id prefix, resolved lazily
        # clamped trace fields seen (byzantine/garbled hop or timestamp);
        # mirrored into metrics, polled by chaos-smoke's twin assertion
        self.trace_clamps = 0
        cs.on_new_round_step.append(self._on_new_round_step)
        cs.on_vote.append(self._on_vote_event)
        cs.on_valid_block.append(self._on_valid_block)
        cs.on_proposal.append(self._on_proposal)
        cs.on_new_block_part.append(self._on_new_block_part)

    def get_channels(self) -> List[ChannelDescriptor]:
        """reactor.go:160 GetChannels — priorities mirror the reference."""
        return [
            ChannelDescriptor(id=STATE_CHANNEL, priority=5, send_queue_capacity=100),
            ChannelDescriptor(id=DATA_CHANNEL, priority=10, send_queue_capacity=100),
            ChannelDescriptor(id=VOTE_CHANNEL, priority=5, send_queue_capacity=100),
            ChannelDescriptor(id=VOTE_SET_BITS_CHANNEL, priority=1, send_queue_capacity=2),
        ]

    async def on_start(self) -> None:
        if not self.wait_sync:
            await self.cs.start()

    async def on_stop(self) -> None:
        if self.cs.is_running:
            await self.cs.stop()

    async def switch_to_consensus(self, state, blocks_synced: int = 0) -> None:
        """Fast-sync → consensus handover (reactor.go:102)."""
        self.cs.reconstruct_last_commit_if_needed(state)
        self.cs.update_to_state(state)
        self.wait_sync = False
        if blocks_synced > 0:
            self.cs.do_wal_catchup = False
        await self.cs.start()
        # peers admitted during fast sync never had gossip routines started
        # (add_peer skips them while wait_sync) — start them now
        if self.switch is not None:
            for peer_id, ps in self.peer_states.items():
                if peer_id not in self._routines:
                    peer = self.switch.peers.get(peer_id)
                    if peer is not None:
                        self._start_gossip(peer, ps)
        await self._broadcast_new_round_step()

    # -- cs event hooks (broadcast + gossip wakeups) -----------------------
    def _wake_peers(self, data: bool = False, votes: bool = False) -> None:
        for ps in self.peer_states.values():
            if data:
                ps.data_wake.set()
            if votes:
                ps.vote_wake.set()

    def _on_new_round_step(self, rs) -> None:
        self.spawn(self._broadcast_new_round_step(), "bcast-nrs")
        self._wake_peers(data=True, votes=True)

    def _on_vote_event(self, vote: Vote) -> None:
        """broadcastHasVoteMessage (reactor.go:422) — fires for every vote
        added to our sets (own or relayed), which is exactly when a peer
        might newly lack one: wake the vote gossip routines.

        With the relay topology active, the per-vote has_vote frame is
        suppressed entirely and only the O(d) relay subset is woken —
        per-vote full-mesh chatter is the O(N²·V) term that wedges
        100-validator nets.  The announcement is ~redundant there: our own
        batched push marks possession on both ends (`set_has_vote` on
        send, `_mark_peer_vote` on receive), and everyone else learns
        what we hold from summaries, the VoteSetBits exchange, and the
        repair tick.

        Targets are keyed by OUR (height, round) — the same key
        `_relay_ok` gates the woken routine's push with — not the vote's:
        a late vote for an older round must wake peers whose pushes will
        actually be allowed, and a single shared key keeps the memoized
        ranking hot (alternating keys would recompute N edge hashes per
        event)."""
        targets = self._relay_targets(self.cs.rs.height, self.cs.rs.round)
        if targets is None:
            msg = _enc("has_vote", {
                "height": vote.height, "round": vote.round,
                "vote_type": vote.type, "index": vote.validator_index,
            })
            self.spawn(self._broadcast(STATE_CHANNEL, msg), "bcast-hasvote")
            self._wake_peers(votes=True)
            return
        for pid in targets:
            ps = self.peer_states.get(pid)
            if ps is not None:
                ps.vote_wake.set()

    def _on_valid_block(self, rs) -> None:
        self._wake_peers(data=True)
        if rs.proposal_block_parts is None:
            return
        msg = _enc("new_valid_block", {
            "height": rs.height, "round": rs.round,
            "block_parts_header": rs.proposal_block_parts.header().to_dict(),
            "block_parts": rs.proposal_block_parts.bit_array().to_bytes(),
            "is_commit": rs.step == RoundStep.COMMIT,
        })
        self.spawn(self._broadcast(STATE_CHANNEL, msg), "bcast-validblock")

    def _on_proposal(self, rs) -> None:
        self._wake_peers(data=True)

    def _on_new_block_part(self, rs) -> None:
        self._wake_peers(data=True)

    async def _broadcast(self, chan: int, msg: bytes) -> None:
        if self.switch is not None:
            await self.switch.broadcast(chan, msg)

    async def _broadcast_new_round_step(self) -> None:
        await self._broadcast(STATE_CHANNEL, self._new_round_step_msg())

    def _new_round_step_msg(self) -> bytes:
        rs = self.cs.rs
        return _enc("new_round_step", {
            "height": rs.height,
            "round": rs.round,
            "step": rs.step,
            "seconds_since_start": max(0.0, time.monotonic() - rs.start_time),
            "last_commit_round": rs.last_commit.round if rs.last_commit is not None else -1,
        })

    # -- peer lifecycle ----------------------------------------------------
    async def add_peer(self, peer) -> None:
        ps = PeerRoundState()
        self.peer_states[peer.id] = ps
        self._peer_gen += 1
        peer.set("cs_peer_state", ps)
        # while fast-syncing, our round state is announced only at the
        # handover (reactor.go AddPeer): a peer told our height now would
        # send us proposals and votes that receive drops, mark them
        # delivered, and keep them marked after the handover's
        # new_round_step at the same height and round
        if not self.wait_sync:
            await peer.send(STATE_CHANNEL, self._new_round_step_msg())
            self._start_gossip(peer, ps)

    def _start_gossip(self, peer, ps) -> None:
        self._routines[peer.id] = [
            self.spawn(self._gossip_data_routine(peer, ps), f"gossip-data-{peer.id[:8]}"),
            self.spawn(self._gossip_votes_routine(peer, ps), f"gossip-votes-{peer.id[:8]}"),
            self.spawn(self._query_maj23_routine(peer, ps), f"maj23-{peer.id[:8]}"),
        ]

    async def remove_peer(self, peer, reason=None) -> None:
        self.peer_states.pop(peer.id, None)
        self._peer_gen += 1
        for task in self._routines.pop(peer.id, []):
            task.cancel()

    def _peer_batched(self, peer) -> bool:
        """True when vote_batch frames may be sent to this peer: both our
        config knob and the peer's advertised NodeInfo capability agree."""
        return (
            self.cs.config.gossip_vote_batch
            and getattr(peer, "gossip_version", 0) >= GOSSIP_BATCH_VERSION
        )

    def _peer_summarized(self, peer) -> bool:
        """True when the maj23 summary/pull exchange may be used with this
        peer (negotiated like vote_batch, one capability level up)."""
        return (
            self.cs.config.gossip_vote_batch
            and self.cs.config.gossip_vote_summary
            and getattr(peer, "gossip_version", 0) >= GOSSIP_SUMMARY_VERSION
        )

    def _peer_traced(self, peer) -> bool:
        """True when outbound frames to this peer may carry wire-level
        trace context (negotiated like vote_batch, one level up again)."""
        return (
            self.cs.config.gossip_vote_batch
            and self.cs.config.gossip_vote_summary
            and self.cs.config.gossip_trace_context
            and getattr(peer, "gossip_version", 0) >= GOSSIP_TRACE_VERSION
        )

    # -- wire-level trace context ------------------------------------------
    def _trace_wall_ns(self) -> int:
        """Wall ns through the recorder's anchor fn when present — under
        clock-skew chaos that is the node's SKEWED clock, which is exactly
        what makes the skew measurable at the receiver."""
        fn = getattr(self.cs.recorder, "_wall_ns_fn", None)
        return fn() if fn is not None else time.time_ns()

    def _trace_origin_id(self) -> str:
        oid = self._trace_id
        if not oid:
            oid = (getattr(self.switch, "node_id", "") or "")[:16]
            self._trace_id = oid
        return oid

    def _stamp_trace(self, fields: dict, hop: int) -> dict:
        """Stamp a frame's field dict with trace context (sender id, send
        wall ns, content hop count).  Callers gate on _peer_traced."""
        fields["o"] = self._trace_origin_id()
        fields["ow"] = self._trace_wall_ns()
        fields["hp"] = hop
        return fields

    def _store_hop(self, key: tuple, hop: int) -> None:
        self._trace_hops[key] = hop
        while len(self._trace_hops) > TRACE_CTX_CAP:
            self._trace_hops.popitem(last=False)

    def _content_hop(self, key: tuple) -> int:
        """Hop count to stamp on a relay of `key`: received-hop + 1, or 0
        when we originated the content (no stored entry)."""
        hop = self._trace_hops.get(key)
        return 0 if hop is None else min(hop + 1, TRACE_MAX_HOP)

    def _trace_recv(self, frame: str, peer, msg: dict, height=None) -> Optional[int]:
        """Decode (and clamp) trace context off a received frame; emit a
        sampled `gossip.hop` recorder event; return the hop count for the
        caller to store for relays (None = no trace context on the frame).

        Every field is attacker-suppliable: hop is clamped into
        [0, TRACE_MAX_HOP], and the propagation-latency sample is emitted
        only when the origin timestamp lands inside the ±TRACE_MAX_LAT_NS
        sanity window AND nothing else was clamped — a forged frame gets
        `clamped=1` and a counter bump, never a say in skew estimation."""
        ow = msg.get("ow")
        if not isinstance(ow, int) or isinstance(ow, bool):
            return None
        hp = msg.get("hp")
        origin = msg.get("o")
        clamped = False
        if not isinstance(hp, int) or isinstance(hp, bool) or hp < 0:
            hp, clamped = 0, True
        elif hp > TRACE_MAX_HOP:
            hp, clamped = TRACE_MAX_HOP, True
        fields = {
            "frame": frame,
            "peer": peer.id[:8],
            "origin": origin[:8] if isinstance(origin, str) else "",
            "hop": hp,
        }
        if isinstance(height, int) and not isinstance(height, bool):
            fields["h"] = height
        lat_ns = self._trace_wall_ns() - ow
        if clamped or not -TRACE_MAX_LAT_NS <= lat_ns <= TRACE_MAX_LAT_NS:
            clamped = True
            fields["clamped"] = 1
            self.trace_clamps += 1
            self.cs.metrics.trace_clamps.inc()
        else:
            fields["lat_ms"] = round(lat_ns / 1e6, 3)
        self.cs.recorder.record_sampled("gossip.hop", **fields)
        return hp

    # -- relay topology ----------------------------------------------------
    def _relay_targets(self, height: int, round_: int) -> Optional[Set[str]]:
        """The deterministic O(d) relay subset of connected peers for
        (height, round); None = full mesh (relay off, or too few peers for
        the topology to pay).  Each undirected edge (us, peer) is scored by
        hashing (height, round, sorted id pair) — both endpoints rank the
        shared edge identically, the ranking is uncorrelated across rounds
        (stuck rounds re-roll the graph), and the union of every node's d
        cheapest edges forms a connected expander whp at committee sizes."""
        cfg = self.cs.config
        d = cfg.gossip_relay_degree
        n = len(self.peer_states)
        if d <= 0 or n <= max(d, cfg.gossip_relay_min_peers):
            return None
        key = (height, round_, self._peer_gen)
        cached = self._relay_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        me = getattr(self.switch, "node_id", "") or ""
        prefix = b"%d|%d|" % (height, round_)

        def edge_score(pid: str) -> bytes:
            a, b = (me, pid) if me < pid else (pid, me)
            return hashlib.sha256(prefix + a.encode() + b"|" + b.encode()).digest()

        targets = set(sorted(self.peer_states, key=edge_score)[:d])
        self._relay_cache = (key, targets)
        return targets

    def _relay_ok(self, peer_id: str) -> bool:
        """May event-triggered passes push votes to this peer right now?"""
        targets = self._relay_targets(self.cs.rs.height, self.cs.rs.round)
        return targets is None or peer_id in targets

    # -- receive demux (reactor.go:214) ------------------------------------
    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            kind, msg = _dec(msg_bytes)
        except Exception:
            await self.switch.stop_peer_for_error(peer, "malformed consensus message")
            return
        ps = self.peer_states.get(peer.id)
        if ps is None:
            return

        if chan_id == STATE_CHANNEL:
            if kind == "new_round_step":
                ps.apply_new_round_step(msg)
                # the peer moved: what it lacks changed — rescan now, not a
                # gossip tick from now
                ps.data_wake.set()
                ps.vote_wake.set()
            elif kind == "new_valid_block":
                ps.apply_new_valid_block(msg)
                ps.data_wake.set()
            elif kind == "has_vote":
                ps.set_has_vote(
                    msg["height"], msg["round"], msg["vote_type"], msg["index"],
                    self.cs.rs.validators.size() if self.cs.rs.validators else 0,
                )
            elif kind == "vote_set_maj23":
                await self._handle_vote_set_maj23(peer, msg)
            elif kind == "vote_summary":
                self._trace_recv("vote_summary", peer, msg, msg.get("height"))
                await self._handle_vote_summary(peer, ps, msg)
        elif self.wait_sync:
            return  # ignore data/votes while fast-syncing (reactor.go:231)
        elif chan_id == DATA_CHANNEL:
            if kind == "proposal":
                proposal = Proposal.from_dict(msg["proposal"])
                try:  # ValidateBasic on ingress (reactor.go:222)
                    proposal.validate_basic()
                except ValueError as e:
                    await self.switch.stop_peer_for_error(peer, f"invalid proposal: {e}")
                    return
                hp = self._trace_recv("proposal", peer, msg, proposal.height)
                if hp is not None:
                    self._store_hop(("prop", proposal.height, proposal.round), hp)
                ps.set_has_proposal(proposal)
                await self.cs.set_proposal_input(proposal, peer.id)
            elif kind == "proposal_pol":
                ps.apply_proposal_pol(msg)
                ps.data_wake.set()
            elif kind == "block_part":
                part = Part.from_dict(msg["part"])
                try:
                    part.validate_basic()
                except ValueError as e:
                    await self.switch.stop_peer_for_error(peer, f"invalid block part: {e}")
                    return
                hp = self._trace_recv("block_part", peer, msg, msg.get("height"))
                if hp is not None:
                    self._store_hop(
                        ("part", msg["height"], msg["round"], part.index), hp
                    )
                ps.set_has_proposal_block_part(msg["height"], msg["round"], part.index)
                await self.cs.add_block_part_input(msg["height"], msg["round"], part, peer.id)
        elif chan_id == VOTE_CHANNEL:
            if kind == "vote":
                vote = Vote.from_dict(msg["vote"])
                try:  # a signed vote with a malformed BlockID must not
                    # enter vote sets (reactor.go:222 ValidateBasic)
                    vote.validate_basic()
                except ValueError as e:
                    await self.switch.stop_peer_for_error(peer, f"invalid vote: {e}")
                    return
                hp = self._trace_recv("vote", peer, msg, vote.height)
                if hp is not None:
                    vote._trace_hop = hp
                self._mark_peer_vote(ps, vote)
                if self._already_have_vote(vote):
                    return  # duplicate relay; already verified and stored
                verified = await self._preverify_vote(vote)
                if verified is None:
                    return  # not verifiable against known sets; let cs drop it
                if not verified:
                    await self.switch.stop_peer_for_error(peer, "invalid vote signature")
                    return
                await self.cs.add_vote_input(vote, peer.id, verified=True)
            elif kind == "vote_batch":
                await self._receive_vote_batch(peer, ps, msg)
            elif kind == "agg_commit":
                try:
                    commit = AggregateCommit.from_dict(msg["commit"])
                    commit.validate_basic()
                except Exception as e:
                    await self.switch.stop_peer_for_error(peer, f"invalid agg_commit: {e}")
                    return
                hp = self._trace_recv("agg_commit", peer, msg, commit.height)
                if hp is not None:
                    self._store_hop(("agg", commit.height), hp)
                # the signature check (one pairing) runs inside the
                # consensus routine against OUR validator set; a forged
                # commit is dropped there
                await self.cs.add_agg_commit_input(commit, peer.id)
        elif chan_id == VOTE_SET_BITS_CHANNEL:
            if kind == "vote_set_bits":
                our_votes = None
                rs = self.cs.rs
                if rs.height == msg["height"] and rs.votes is not None:
                    vs = (
                        rs.votes.prevotes(msg["round"])
                        if msg["type"] == PREVOTE_TYPE
                        else rs.votes.precommits(msg["round"])
                    )
                    if vs is not None:
                        our_votes = vs.bit_array_by_block_id(BlockID.from_dict(msg["block_id"]))
                ps.apply_vote_set_bits(msg, our_votes, self._num_validators(msg["height"]))
                # bits may have been CLEARED (the repair path): the peer
                # lacks votes we thought delivered — resend without waiting
                # out a tick
                ps.vote_wake.set()
            elif kind == "vote_pull":
                await self._handle_vote_pull(peer, ps, msg)

    def _mark_peer_vote(self, ps: PeerRoundState, vote: Vote) -> None:
        rs = self.cs.rs
        val_size = rs.validators.size() if rs.validators else 0
        last_size = rs.last_validators.size() if rs.last_validators else 0
        ps.set_has_vote(
            vote.height, vote.round, vote.type, vote.validator_index,
            val_size if vote.height == rs.height else last_size,
        )

    def _already_have_vote(self, vote: Vote) -> bool:
        """True when an IDENTICAL signed vote is already in our sets.
        Event-driven relays race the has_vote suppression: in a full mesh
        every vote arrives ~once per peer, and each duplicate used to pay
        a full signature verify before the vote set's dedup could see it
        (measured: ~2.2x the necessary verifies per block at 4 vals).
        An identical signature already stored means already verified."""
        rs = self.cs.rs
        existing = None
        if vote.height == rs.height and rs.votes is not None:
            vs = (
                rs.votes.prevotes(vote.round)
                if vote.type == PREVOTE_TYPE
                else rs.votes.precommits(vote.round)
            )
            if vs is not None:
                existing = vs.get_by_index(vote.validator_index)
        elif (
            vote.height + 1 == rs.height
            and rs.last_commit is not None
            and vote.type == PRECOMMIT_TYPE
            and vote.round == rs.last_commit.round
        ):
            existing = rs.last_commit.get_by_index(vote.validator_index)
        return existing is not None and existing.signature == vote.signature

    async def _receive_vote_batch(self, peer, ps: PeerRoundState, msg: dict) -> None:
        """Decode a byte-capped vote_batch and verify it as ONE
        AsyncBatchVerifier call — the receive-side half of the batched
        gossip path (one flush, one host-prep pass for the whole frame)."""
        blobs = msg.get("votes")
        if not isinstance(blobs, list) or len(blobs) > MAX_VOTE_BATCH_ENTRIES:
            await self.switch.stop_peer_for_error(peer, "malformed vote_batch")
            return
        votes: List[Vote] = []
        for blob in blobs:
            try:
                vote = codec.loads(blob)
                if not isinstance(vote, Vote):
                    raise ValueError("vote_batch entry is not a vote")
                vote.validate_basic()
            except Exception as e:
                await self.switch.stop_peer_for_error(peer, f"invalid vote in batch: {e}")
                return
            votes.append(vote)
        if not votes:
            return
        hp = self._trace_recv("vote_batch", peer, msg, votes[0].height)
        if hp is not None:
            # per-vote content hop: our own relay of these votes stamps
            # max(stored)+1, so hop counts never decrement along a path
            for vote in votes:
                vote._trace_hop = hp
        # piggybacked possession bitmap: fold the sender's full bit array
        # for the set into our belief (it covers votes it received from
        # third parties — the anti-echo half of the relay topology)
        have = msg.get("have")
        if isinstance(have, bytes):
            try:
                height, round_, vtype = int(msg["h"]), int(msg["r"]), int(msg["t"])
                theirs = BitArray.from_bytes(have)
            except Exception:
                await self.switch.stop_peer_for_error(peer, "malformed vote_batch have")
                return
            n_vals = self._num_validators(height)
            if n_vals > 0:
                bits = ps.get_vote_bits(height, round_, vtype, n_vals)
                if bits is not None:
                    k = min(bits.bits, theirs.bits)
                    bits._v[:k] |= theirs._v[:k]
        for vote in votes:
            self._mark_peer_vote(ps, vote)
        keep: List[Tuple[Vote, object, bytes]] = []  # (vote, pub_key, sign_bytes)
        seen: set = set()  # within-frame dedup: without it a peer could
        # pack one fresh vote 16k times and buy 16k signature verifies
        # for one vote of real work (verify-amplification)
        for vote in votes:
            slot = (vote.height, vote.round, vote.type, vote.validator_index)
            if slot in seen:
                continue
            seen.add(slot)
            if self._already_have_vote(vote):
                continue  # duplicate relay; already verified and stored
            resolved = self._resolve_vote(vote)
            if resolved is None:
                continue  # height not resolvable against known sets; drop
            if resolved is False:
                await self.switch.stop_peer_for_error(
                    peer, "vote validator address mismatch in batch"
                )
                return
            keep.append((vote, *resolved))
        if not keep:
            return
        # provenance: the relay hop (peer) plus fresh-vs-already-held
        # split — `n` fresh votes entered the verifier, `dup` were relays
        # of votes this node already verified (first-seen vs relayed)
        self.cs.recorder.record(
            "gossip.vote_batch_recv", n=len(keep), dup=len(votes) - len(keep),
            peer=peer.id[:8], h=keep[0][0].height, r=keep[0][0].round,
        )
        results: List[Optional[bool]] = [None] * len(keep)
        engine: List[Tuple[int, bytes, bytes, bytes]] = []
        for i, (vote, pub_key, sign_bytes) in enumerate(keep):
            pk = self._engine_key(pub_key)
            if self.async_verifier is not None and pk is not None:
                engine.append((i, pk, sign_bytes, vote.signature))
            else:
                # non-ed25519 keys (sr25519, multisig) verify through their
                # own key type, same as the single-vote path
                results[i] = bool(pub_key.verify(sign_bytes, vote.signature))
        if engine:
            entries = [(pk, sb, sig) for _, pk, sb, sig in engine]
            try:
                if len(entries) >= DIRECT_VERIFY_MIN:
                    # already batch-shaped: one direct engine call, no
                    # coalescing-flusher scheduling hops (committee scale)
                    res = await self.async_verifier.verify_direct(entries)
                else:
                    res = await asyncio.gather(
                        *self.async_verifier.verify_many(entries)
                    )
            except EngineError as e:
                # the engine's fault, not the peer's (the JAX reactor drops
                # the frame here): fail the receive task with it
                self.log.error(
                    "vote_batch verify failed in the engine", peer=peer.id[:12],
                    n=len(entries), err=repr(e),
                )
                raise LocalFault(f"vote_batch verify failed in the engine: {e!r}") from e
            for (i, _, _, _), ok in zip(engine, res):
                results[i] = bool(ok)
        if not all(results):
            await self.switch.stop_peer_for_error(peer, "invalid vote signature in batch")
            return
        for vote, _, _ in keep:
            await self.cs.add_vote_input(vote, peer.id, verified=True)

    async def _handle_vote_set_maj23(self, peer, msg: dict) -> None:
        """reactor.go:258 — record peer claim, respond with our bits."""
        rs = self.cs.rs
        if rs.height != msg["height"] or rs.votes is None:
            return
        block_id = BlockID.from_dict(msg["block_id"])
        try:
            rs.votes.set_peer_maj23(msg["round"], msg["type"], peer.id, block_id)
        except Exception as e:
            await self.switch.stop_peer_for_error(peer, str(e))
            return
        vs = (
            rs.votes.prevotes(msg["round"])
            if msg["type"] == PREVOTE_TYPE
            else rs.votes.precommits(msg["round"])
        )
        if vs is None:
            return
        our = vs.bit_array_by_block_id(block_id) or BitArray(vs.size())
        await peer.send(
            VOTE_SET_BITS_CHANNEL,
            _enc("vote_set_bits", {
                "height": msg["height"], "round": msg["round"], "type": msg["type"],
                "block_id": msg["block_id"], "votes": our.to_bytes(),
            }),
        )

    # -- maj23-driven vote aggregation (summary / pull) --------------------
    def _num_validators(self, height: int) -> int:
        """Our validator-set size for a claimed height; 0 when the height
        does not pin to a set we hold (the claim is then unusable anyway).
        Used to clamp every peer-supplied bitmap allocation."""
        rs = self.cs.rs
        if height == rs.height and rs.validators is not None:
            return rs.validators.size()
        if height == rs.height - 1 and rs.last_validators is not None:
            return rs.last_validators.size()
        if height == rs.height + 1 and rs.validators is not None:
            # a peer one height ahead summarizes against a set we may not
            # hold yet; our current set is the best available clamp
            return rs.validators.size()
        return 0

    def _summary_vote_set(self, height: int, round_: int, vote_type: int):
        """Resolve a (height, round, type) claim to a live VoteSet we can
        serve pulls from / diff summaries against: the current height's
        sets, or last_commit for height-1 precommits."""
        rs = self.cs.rs
        if height == rs.height and rs.votes is not None:
            return (
                rs.votes.prevotes(round_)
                if vote_type == PREVOTE_TYPE
                else rs.votes.precommits(round_)
            )
        if (
            height == rs.height - 1
            and rs.last_commit is not None
            and vote_type == PRECOMMIT_TYPE
            and round_ == rs.last_commit.round
        ):
            return rs.last_commit
        return None

    # bitmap-growth summary re-sends are rate-limited to one per this many
    # seconds per (peer, height, round, type); expiry-driven repair
    # re-sends are governed by the (longer) fallback cap
    SUMMARY_REFRESH = 0.25

    async def _maybe_send_summary(self, peer, ps: PeerRoundState, vote_set) -> bool:
        """Send a compact have-maj23 + vote-bitmap summary instead of
        streaming votes (the aggregation path, gossip_version >= 2).
        Deduped per (height, round, type): re-sent only when our bitmap
        grew (new votes for laggards to pull, refresh-floored) or after
        expiry (frame loss repair)."""
        bits = vote_set.bit_array()
        count = bits.count()
        key = (vote_set.height, vote_set.round, vote_set.signed_msg_type)
        now = time.monotonic()
        resend_after = max(
            self._fallback_cap(self.cs.config.peer_gossip_sleep_duration), 1.0
        )
        prev = ps.summary_sent.get(key)
        if prev is not None:
            grown = count > prev[0]
            age = now - prev[1]
            # growth alone re-sends only past a refresh floor — without it
            # every late vote re-summarizes to every peer (measured ~65
            # summaries/node/block at N=20); expiry still repairs losses
            if not (grown and age >= self.SUMMARY_REFRESH) and age < resend_after:
                return False
        maj23, _ = vote_set.two_thirds_majority()
        if maj23 is None:
            return False
        fields = {
            "height": vote_set.height, "round": vote_set.round,
            "type": vote_set.signed_msg_type, "block_id": maj23.to_dict(),
            "votes": bits.to_bytes(),
        }
        if self._peer_traced(peer):
            # summaries always ORIGINATE here (our own maj23 bitmap claim,
            # never a relay of someone else's summary) → hop 0
            self._stamp_trace(fields, 0)
        ok = await peer.send(STATE_CHANNEL, _enc("vote_summary", fields))
        if ok:
            ps.summary_sent[key] = (count, now)
            ps.prune_sent(ps.summary_sent, now, now - resend_after)
            self.cs.metrics.vote_summaries.inc()
            self.cs.recorder.record(
                "gossip.summary", n=count, peer=peer.id[:8],
                h=vote_set.height, r=vote_set.round, t=vote_set.signed_msg_type,
            )
        return ok

    async def _handle_vote_summary(self, peer, ps: PeerRoundState, msg: dict) -> None:
        """Receive side of the aggregation path: the sender holds +2/3 and
        these votes.  Fold its bitmap into our belief (so we never stream
        those votes back), record the maj23 claim, and pull exactly the
        votes we lack — the response is a vote_batch that lands in the
        engine as one flush."""
        try:
            height, round_, vtype = int(msg["height"]), int(msg["round"]), int(msg["type"])
            theirs = BitArray.from_bytes(msg["votes"])
            block_id = BlockID.from_dict(msg["block_id"])
        except Exception:
            await self.switch.stop_peer_for_error(peer, "malformed vote_summary")
            return
        n_vals = self._num_validators(height)
        if n_vals <= 0:
            return  # height not resolvable against our sets; ignore
        # belief update: the sender HAS these votes (superset claims are
        # self-harm only — we'd skip sending votes the peer then pulls)
        bits = ps.get_vote_bits(height, round_, vtype, n_vals)
        if bits is not None:
            n = min(bits.bits, theirs.bits)
            bits._v[:n] |= theirs._v[:n]
        rs = self.cs.rs
        if height == rs.height and rs.votes is not None:
            try:
                rs.votes.set_peer_maj23(round_, vtype, peer.id, block_id)
            except Exception as e:
                await self.switch.stop_peer_for_error(peer, str(e))
                return
        vote_set = self._summary_vote_set(height, round_, vtype)
        if vote_set is None:
            return
        want = vote_set.bits_we_lack(theirs)
        if want.is_empty():
            return
        self.cs.recorder.record(
            "gossip.pull_req", n=want.count(), peer=peer.id[:8], h=height, r=round_,
        )
        await peer.send(VOTE_SET_BITS_CHANNEL, _enc("vote_pull", {
            "height": height, "round": round_, "type": vtype,
            "want": want.to_bytes(),
        }))

    async def _handle_vote_pull(self, peer, ps: PeerRoundState, msg: dict) -> None:
        """Serve a pull: exactly the requested canonical votes, as one
        byte-capped vote_batch (the puller advertised >= batch capability
        by speaking the summary exchange at all)."""
        if not self._peer_batched(peer):
            return
        try:
            height, round_, vtype = int(msg["height"]), int(msg["round"]), int(msg["type"])
            want = BitArray.from_bytes(msg["want"])
        except Exception:
            await self.switch.stop_peer_for_error(peer, "malformed vote_pull")
            return
        vote_set = self._summary_vote_set(height, round_, vtype)
        if vote_set is None:
            return
        votes = vote_set.select_votes(want)
        if not votes:
            return
        self.cs.metrics.vote_pulls.inc()
        self.cs.recorder.record(
            "gossip.pull_serve", n=len(votes), peer=peer.id[:8], h=height, r=round_,
        )
        await self._send_vote_batch(peer, ps, votes, vote_set.size(), have=vote_set)

    # -- vote pre-verification (the TPU batch path) ------------------------
    def _resolve_vote(self, vote: Vote) -> Union[None, bool, Tuple[object, bytes]]:
        """Resolve a vote to (pub_key, sign_bytes) against the validator
        set its height pins to.  None = can't resolve (height mismatch /
        no set); False = claimed (validator_index, address) don't match
        the set (peer misbehaviour)."""
        rs = self.cs.rs
        if vote.height == rs.height:
            val_set = rs.validators
        elif vote.height + 1 == rs.height:
            val_set = rs.last_validators
        else:
            return None
        if val_set is None:
            return None
        addr, val = val_set.get_by_index(vote.validator_index)
        if val is None or addr != vote.validator_address:
            return False
        # per-scheme sign-bytes: BLS validators sign the timestamp-free
        # aggregation domain, everyone else the reference layout
        return val.pub_key, vote.sign_bytes_for_key(self.cs.sm_state.chain_id, val.pub_key)

    @staticmethod
    def _engine_key(pub_key) -> Optional[bytes]:
        """Raw key bytes iff the engine's ed25519 kernel can verify this
        key type; None routes it to the key's own (polymorphic) verify —
        sr25519/multisig validators must not be fed to the ed25519 batch."""
        from ..crypto.keys import Ed25519PubKey

        return pub_key.bytes() if isinstance(pub_key, Ed25519PubKey) else None

    async def _preverify_vote(self, vote: Vote) -> Optional[bool]:
        """Check the signature against the pubkey our validator sets pin to
        (validator_index, address).  None = can't resolve (height mismatch)."""
        resolved = self._resolve_vote(vote)
        if resolved is None:
            return None
        if resolved is False:
            return False
        pub_key, sign_bytes = resolved
        pk = self._engine_key(pub_key)
        if self.async_verifier is not None and pk is not None:
            try:
                return await self.async_verifier.verify_one(pk, sign_bytes, vote.signature)
            except EngineError as e:
                # the engine's fault: the JAX reactor reads it as a bad
                # signature and stops the peer; here it fails the receive task
                self.log.error("vote verify failed in the engine", err=repr(e))
                raise LocalFault(f"vote verify failed in the engine: {e!r}") from e
        return bool(pub_key.verify(sign_bytes, vote.signature))

    # -- gossip routines ---------------------------------------------------

    # Every state transition that could give a gossip routine work fires an
    # explicit wakeup, so the old per-tick poll survives only as a repair
    # fallback — at 10x the configured tick (floored at 250 ms) it stays a
    # liveness backstop while costing orders of magnitude less idle churn.
    # The churn is not just CPU: each wait_for spins up a task, and a node
    # that is constantly runnable loses the scheduler's sleeper boost, so
    # co-located nodes woke each other late (measured on the 4-val procs
    # rig: the reference pacing was ~200 tasks/sec per peer routine).
    FALLBACK_CAP_MULTIPLIER = 10
    FALLBACK_CAP_FLOOR = 0.25

    def _fallback_cap(self, sleep: float) -> float:
        return max(sleep * self.FALLBACK_CAP_MULTIPLIER, self.FALLBACK_CAP_FLOOR)

    async def _gossip_wait(self, peer, event: asyncio.Event, cap: float) -> bool:
        """Event-driven pacing: return as soon as a wakeup event fires;
        the reference's fixed sleep survives only as the fallback cap, so
        propagation latency is bounded by the event loop, not the tick.
        Returns True iff an event carried the wakeup (False = the fallback
        cap lapsed — the next pass is a REPAIR pass, exempt from the relay
        topology's push gating so completeness never depends on it).

        NOT wait_for: on py3.10 a remove_peer/stop cancellation landing in
        the same tick the (constantly-fired) event completes would be
        swallowed (bpo-42130) and the routine would outlive its peer —
        same mechanism as the SignerClient/Service.stop fix."""
        from ..libs.service import wait_event

        fired = await wait_event(event, self._fallback_cap(cap))
        if not fired:
            return False
        self.cs.metrics.gossip_wakeups.inc()
        # high-rate kind (fires per wakeup; ~700 conns can evict the whole
        # ring between commits) — 1-in-N under trace_sample_high_rate
        self.cs.recorder.record_sampled("gossip.wakeup", peer=peer.id[:8])
        return True

    async def _gossip_data_routine(self, peer, ps: PeerRoundState) -> None:
        """reactor.go:467, event-driven: one pass per wakeup, block parts
        in rarest-first bursts."""
        sleep = self.cs.config.peer_gossip_sleep_duration
        while True:
            # clear BEFORE scanning: an event landing mid-pass re-sets it
            # and the next wait returns immediately (no lost wakeups)
            ps.data_wake.clear()
            progress = await self._gossip_data_pass(peer, ps)
            if not progress:
                await self._gossip_wait(peer, ps.data_wake, sleep)

    def _part_frame(self, height: int, round_: int, part, traced: bool = False) -> bytes:
        """The wire frame for a block_part message, encoded once per
        (height, round, index, traced) and shared across all peers.  The
        traced variant embeds trace context at FIRST encode — `ow` goes
        stale across later sends of the cached frame (the price of the
        encode-once move), which is why block_part hop events are excluded
        from measured-skew estimation downstream (tracemerge)."""
        key = (height, round_, part.index, traced)
        frame = self._part_frames.get(key)
        if frame is None:
            fields = {"height": height, "round": round_, "part": part.to_dict()}
            if traced:
                self._stamp_trace(
                    fields, self._content_hop(("part", height, round_, part.index))
                )
            frame = _enc("block_part", fields)
            self._part_frames[key] = frame
            while len(self._part_frames) > self._part_frames_cap:
                self._part_frames.popitem(last=False)
        return frame

    async def _gossip_data_pass(self, peer, ps: PeerRoundState) -> bool:
        rs = self.cs.rs
        burst = self.cs.config.gossip_part_burst
        # 1. burst-send proposal block parts the peer lacks.  Snapshot the
        # part set and the peer bits: rs/ps are mutated in place across the
        # awaits below (a check-then-act race); set_has_proposal_block_part
        # re-checks the peer's current position internally.
        pset = rs.proposal_block_parts
        theirs = ps.proposal_block_parts
        if pset is not None and rs.height == ps.height and theirs is not None:
            missing = pset.bit_array().sub(theirs)
            idxs = self._pick_parts(missing, ps, burst)
            if idxs:
                height, round_ = rs.height, rs.round
                sent = 0
                for idx in idxs:
                    part = pset.get_part(idx)
                    if part is None:
                        continue
                    ok = await peer.send(
                        DATA_CHANNEL,
                        self._part_frame(height, round_, part, self._peer_traced(peer)),
                    )
                    if not ok:
                        # send refused (mconn stopping / unknown channel):
                        # report what DID go out and fall back to the wait —
                        # retrying here would busy-spin
                        break
                    ps.set_has_proposal_block_part(ps.height, ps.round, idx)
                    sent += 1
                if sent:
                    self.cs.metrics.parts_per_burst.observe(sent)
                    self.cs.recorder.record(
                        "gossip.part_burst", n=sent, peer=peer.id[:8]
                    )
                return sent > 0
        # 2. peer is catching up: burst parts of their next stored block
        if 0 < ps.height < rs.height and ps.height >= self.cs.block_store.base():
            return await self._gossip_catchup_block_parts(peer, ps, burst)
        # 3. send the proposal (+POL) if the peer lacks it.  Snapshot
        # the proposal: rs is mutated in place by the consensus task,
        # so after any await it may have moved height (proposal=None) —
        # re-reading rs.proposal across the sends crashed this routine
        # (and a dead gossip-data task wedges the peer under loss).
        proposal = rs.proposal
        if proposal is not None and rs.height == ps.height and not ps.proposal:
            if rs.round == ps.round:
                fields = {"proposal": proposal.to_dict()}
                if self._peer_traced(peer):
                    self._stamp_trace(
                        fields,
                        self._content_hop(("prop", proposal.height, proposal.round)),
                    )
                ok = await peer.send(DATA_CHANNEL, _enc("proposal", fields))
                if not ok:
                    return False
                ps.set_has_proposal(proposal)
                if 0 <= proposal.pol_round:
                    pol = rs.votes.prevotes(proposal.pol_round)
                    if pol is not None:
                        await peer.send(DATA_CHANNEL, _enc("proposal_pol", {
                            "height": proposal.height,
                            "proposal_pol_round": proposal.pol_round,
                            "proposal_pol": pol.bit_array().to_bytes(),
                        }))
                return True
        return False

    def _pick_parts(self, missing: BitArray, ps: PeerRoundState, k: int) -> List[int]:
        """Up to k missing part indices, rarest-first: parts held by the
        fewest OTHER peers (per their advertised bit arrays for the same
        part-set header) go first, so concurrent senders stop duplicating
        each other's work; ties break randomly (the reference's
        pick_random degenerate case when every peer looks the same)."""
        idxs = missing.true_indices()
        if not idxs:
            return []
        if len(idxs) > 1 and len(self.peer_states) > 1:
            header = ps.proposal_block_parts_header
            counts = dict.fromkeys(idxs, 0)
            for other in self.peer_states.values():
                if other is ps or other.proposal_block_parts is None:
                    continue
                if other.proposal_block_parts_header != header:
                    continue
                bits = other.proposal_block_parts
                for i in idxs:
                    if bits.get_index(i):
                        counts[i] += 1
            random.shuffle(idxs)
            idxs.sort(key=counts.__getitem__)
        elif len(idxs) > 1:
            random.shuffle(idxs)
        return idxs[:k]

    async def _gossip_catchup_block_parts(self, peer, ps: PeerRoundState, burst: int) -> bool:
        """reactor.go:552 gossipDataForCatchup, burst-sized."""
        if ps.proposal_block_parts is None:
            # init from the stored block meta so we know the shape
            meta = self.cs.block_store.load_block_meta(ps.height)
            if meta is None:
                return False
            ps.proposal_block_parts_header = meta.block_id.parts_header
            ps.proposal_block_parts = BitArray(meta.block_id.parts_header.total)
        meta = self.cs.block_store.load_block_meta(ps.height)
        if meta is None or ps.proposal_block_parts_header != meta.block_id.parts_header:
            return False
        # snapshot: a NewRoundStep arriving during the send resets
        # ps.proposal_block_parts to None (same in-place-mutation trap as
        # the proposal send above; a crashed gossip task wedges the peer)
        parts = ps.proposal_block_parts
        height, round_ = ps.height, ps.round
        full = BitArray.from_indices(parts.bits, range(parts.bits))
        missing = full.sub(parts)
        idxs = self._pick_parts(missing, ps, burst)
        sent = 0
        for idx in idxs:
            part = self.cs.block_store.load_block_part(height, idx)
            if part is None:
                break
            ok = await peer.send(
                DATA_CHANNEL,
                self._part_frame(height, round_, part, self._peer_traced(peer)),
            )
            if not ok:
                break
            parts.set_index(idx, True)
            sent += 1
        if sent:
            self.cs.metrics.parts_per_burst.observe(sent)
            self.cs.recorder.record(
                "gossip.part_burst", n=sent, peer=peer.id[:8], catchup=True
            )
        return sent > 0

    async def _gossip_votes_routine(self, peer, ps: PeerRoundState) -> None:
        """reactor.go:606, event-driven + batched + relay-gated.

        `repair` tracks what carried the last wakeup: event-triggered
        passes respect the relay topology (pushes go to the O(d) subset;
        everyone else gets summaries only), a lapsed fallback cap makes
        the next pass a repair pass that pushes to ANY peer — the
        completeness guarantee the topology rides on."""
        sleep = self.cs.config.peer_gossip_sleep_duration
        debounce = self.cs.config.gossip_relay_debounce
        repair = True  # first pass services a freshly-added peer fully
        while True:
            ps.vote_wake.clear()
            rs = self.cs.rs
            sent = False
            if rs.height == ps.height:
                sent = await self._gossip_votes_for_height(peer, ps, repair)
            elif rs.height == ps.height + 1 and rs.last_commit is not None:
                if isinstance(rs.last_commit, AggregateLastCommit):
                    # restart adapter: the folded seen commit has no votes
                    # to stream, so ship the aggregate itself
                    sent = await self._send_agg_commit(peer, ps, rs.last_commit.commit)
                else:
                    sent = await self._send_votes(peer, ps, rs.last_commit)
            elif rs.height >= ps.height + 2 and ps.height >= self.cs.block_store.base():
                commit = self.cs.block_store.load_block_commit(ps.height)
                if isinstance(commit, AggregateCommit):
                    sent = await self._send_agg_commit(peer, ps, commit)
                elif commit is not None:
                    sent = await self._send_commit_votes(peer, ps, commit)
            relay_on = (
                debounce > 0
                and self._relay_targets(self.cs.rs.height, self.cs.rs.round) is not None
            )
            if sent and relay_on:
                # committee scale: cap the per-peer send cadence at the
                # debounce so votes arriving meanwhile coalesce into the
                # NEXT frame instead of trickling one frame each (the
                # momentum loop otherwise defeats the coalescing below)
                await asyncio.sleep(debounce)
            if not sent:
                fired = await self._gossip_wait(peer, ps.vote_wake, sleep)
                repair = not fired
                if fired and relay_on:
                    # linger so the votes racing this wakeup coalesce into
                    # ONE frame (the gossip twin of the engine's flush
                    # quantum); the event re-sets under us, so nothing is
                    # lost, only batched
                    await asyncio.sleep(debounce)

    async def _gossip_votes_for_height(
        self, peer, ps: PeerRoundState, repair: bool = True
    ) -> bool:
        """reactor.go:668 gossipVotesForHeight ordering."""
        rs = self.cs.rs
        relay_ok = repair or self._relay_ok(peer.id)
        # peer in NewHeight: our last commit helps them finish their commit
        if ps.step == RoundStep.NEW_HEIGHT and rs.last_commit is not None:
            if await self._send_votes(peer, ps, rs.last_commit, relay_ok):
                return True
        # peer needs POL prevotes
        if ps.step <= RoundStep.PROPOSE and 0 <= ps.proposal_pol_round:
            pol = rs.votes.prevotes(ps.proposal_pol_round)
            if pol is not None and await self._send_votes(peer, ps, pol, relay_ok):
                return True
        if ps.step <= RoundStep.PREVOTE_WAIT and 0 <= ps.round <= rs.round:
            vs = rs.votes.prevotes(ps.round)
            if vs is not None and await self._send_votes(peer, ps, vs, relay_ok):
                return True
        if ps.step <= RoundStep.PRECOMMIT_WAIT and 0 <= ps.round <= rs.round:
            vs = rs.votes.precommits(ps.round)
            if vs is not None and await self._send_votes(peer, ps, vs, relay_ok):
                return True
        if 0 <= ps.round <= rs.round:
            vs = rs.votes.prevotes(ps.round)
            if vs is not None and await self._send_votes(peer, ps, vs, relay_ok):
                return True
        if 0 <= ps.proposal_pol_round:
            pol = rs.votes.prevotes(ps.proposal_pol_round)
            if pol is not None and await self._send_votes(peer, ps, pol, relay_ok):
                return True
        return False

    AGG_COMMIT_RESEND_S = 2.0  # lost-frame repair cadence per stuck peer

    async def _send_agg_commit(self, peer, ps: PeerRoundState, commit) -> bool:
        """Catchup for a folded height: the per-vote precommits were
        dropped at fold time, so ship the stored AggregateCommit itself, ONE
        ~190-byte frame; the receiver checks it with one pairing and
        finalizes from it (state._apply_aggregate_commit).  Deduped per
        stuck height with a coarse resend timer."""
        if ps.height != commit.height:
            return False
        now = time.monotonic()
        last_h, last_t = ps.agg_commit_sent
        if last_h == commit.height and now - last_t < self.AGG_COMMIT_RESEND_S:
            return False
        fields = {"commit": commit.to_dict()}
        if self._peer_traced(peer):
            self._stamp_trace(fields, self._content_hop(("agg", commit.height)))
        ok = await peer.send(VOTE_CHANNEL, _enc("agg_commit", fields))
        if ok:
            ps.agg_commit_sent = (commit.height, now)
            self.cs.recorder.record(
                "gossip.agg_commit", height=commit.height, peer=peer.id[:8]
            )
        return ok

    async def _send_votes(
        self, peer, ps: PeerRoundState, vote_set, relay_ok: bool = True
    ) -> bool:
        """Send votes the peer lacks from one vote set.  Once the set holds
        +2/3, capable peers get a compact maj23 summary and pull what they
        lack (aggregation) instead of a stream.  Below maj23, batched peers
        get everything in one byte-capped vote_batch frame and legacy peers
        the reference's one-random-vote PickSendVote (reactor.go:1036) —
        but only relay targets / repair passes push at all when the relay
        topology is active."""
        if vote_set is None:
            return False
        peer_bits = ps.get_vote_bits(
            vote_set.height, vote_set.round, vote_set.signed_msg_type, vote_set.size()
        )
        if peer_bits is None:
            return False
        # Aggregation only pays at committee scale: a summary→pull→batch
        # exchange is two extra RTTs (plus the refresh floor) that a small
        # net's laggard pays on the final vote of every step — measured 3×
        # block time at 4 vals.  Gate it exactly like the relay topology:
        # below gossip_relay_min_peers votes stream directly.
        if (
            self._relay_targets(self.cs.rs.height, self.cs.rs.round) is not None
            and vote_set.has_two_thirds_majority()
            and self._peer_summarized(peer)
        ):
            return await self._maybe_send_summary(peer, ps, vote_set)
        if not relay_ok:
            return False
        votes = vote_set.missing_votes(peer_bits)
        if not votes:
            return False
        if self._peer_batched(peer):
            return await self._send_vote_batch(
                peer, ps, votes, vote_set.size(), have=vote_set
            )
        return await self._send_single_vote(peer, ps, random.choice(votes), vote_set.size())

    async def _send_vote_batch(
        self, peer, ps: PeerRoundState, votes: List[Vote], num_validators: int,
        have=None,
    ) -> bool:
        """One frame, every missing vote up to the byte cap, each vote's
        wire bytes encoded once (types/vote.py Vote.wire) and shared
        across peers.  Anything over the cap rides the next wakeup (the
        routine loops immediately after a successful send).

        `have` (the source VoteSet/Commit) piggybacks our possession
        bitmap on the frame: the receiver folds it into its belief of us,
        so it never echoes these votes back and — since our bitmap covers
        votes we got from THIRD parties — the epidemic push converges at
        ~1 send per (edge, vote) instead of degree-fold duplication.
        Older receivers ignore the extra fields (wire-compatible)."""
        cap = self.cs.config.gossip_vote_batch_bytes
        blobs: List[bytes] = []
        included: List[Vote] = []
        total = 0
        for v in votes:
            if len(included) >= MAX_VOTE_BATCH_ENTRIES:
                break  # receiver kills peers over the entry cap; never hit it
            w = v.wire()
            if included and total + len(w) > cap:
                break
            blobs.append(w)
            included.append(v)
            total += len(w)
        frame = {"votes": blobs}
        if have is not None and included:
            frame.update({
                "h": have.height, "r": have.round, "t": have.signed_msg_type,
                "have": have.bit_array().to_bytes(),
            })
        if included and self._peer_traced(peer):
            # content hop = worst relay depth among the votes: own votes
            # contribute 0 (we originate), a vote received at hop k is
            # relayed at k+1 — so the stamp never decrements along a path
            hop = max(getattr(v, "_trace_hop", -1) for v in included) + 1
            self._stamp_trace(frame, min(hop, TRACE_MAX_HOP))
        ok = await peer.send(VOTE_CHANNEL, _enc("vote_batch", frame))
        if ok:
            for v in included:
                ps.set_has_vote(v.height, v.round, v.type, v.validator_index, num_validators)
            self.cs.metrics.vote_batch_size.observe(len(included))
            self.cs.recorder.record(
                "gossip.votes", mode="batch", n=len(included), bytes=total,
                peer=peer.id[:8],
            )
        return ok

    async def _send_single_vote(
        self, peer, ps: PeerRoundState, vote: Vote, num_validators: int
    ) -> bool:
        """Legacy wire path: the reference's single-vote message, with the
        frame cached on the vote so N peers don't pay N encodes."""
        frame = vote._legacy_frame
        if frame is None:
            frame = _enc("vote", {"vote": vote.to_dict()})
            vote._legacy_frame = frame
        ok = await peer.send(VOTE_CHANNEL, frame)
        if ok:
            ps.set_has_vote(vote.height, vote.round, vote.type, vote.validator_index, num_validators)
            self.cs.recorder.record(
                "gossip.votes", mode="single", n=1, bytes=len(frame), peer=peer.id[:8]
            )
        return ok

    async def _send_commit_votes(self, peer, ps: PeerRoundState, commit) -> bool:
        """Catchup: send stored-commit precommits the peer lacks (batched
        for capable peers, single-vote otherwise)."""
        peer_bits = ps.get_vote_bits(commit.height, commit.round, PRECOMMIT_TYPE, commit.size())
        if peer_bits is None:
            return False
        missing = commit.bit_array().sub(peer_bits)
        idxs = missing.true_indices()
        if not idxs:
            return False
        if self._peer_batched(peer):
            votes = [v for i in idxs if (v := commit.get_vote(i)) is not None]
            if not votes:
                return False
            return await self._send_vote_batch(peer, ps, votes, commit.size())
        vote = commit.get_vote(random.choice(idxs))
        if vote is None:
            return False
        return await self._send_single_vote(peer, ps, vote, commit.size())

    async def _query_maj23_routine(self, peer, ps: PeerRoundState) -> None:
        """reactor.go:738 — periodically tell peers about our maj23s.
        Claims are deduped per (height, round, type, blockID) per peer:
        the reference re-sends identical claims every tick, filling the
        STATE channel with idle chatter.  Entries expire (10× the query
        interval) so the VoteSetBits repair exchange can still re-fire
        for a peer that stays stuck."""
        sleep = self.cs.config.peer_query_maj23_sleep_duration
        resend_after = 10 * sleep
        while True:
            await asyncio.sleep(sleep)
            rs = self.cs.rs
            # Round-state re-announce (liveness repair).  NewRoundStep is
            # normally sent only on step transitions and on add_peer — a
            # REAL partition breaks TCP, so reconnect re-announces via
            # add_peer.  But a message-level fault (chaos drop policy, a
            # middlebox eating frames on a live connection) drops the
            # transition broadcasts while connections stay up: if the cut
            # straddles a height transition, both sides' PeerRoundState
            # beliefs go permanently stale and every post-heal vote push
            # targets the WRONG height (measured: a healed 4-val net
            # wedged at Precommit with 2/4 precommits for 70+ s — the
            # watchdog's stall alarm is what surfaced it).  Re-announce
            # when our state changed since the last announce this peer
            # acked, and keep re-announcing at a slow repair cadence
            # while the peer still looks desynced.
            now = time.monotonic()
            state = (rs.height, rs.round, rs.step)
            sent_state, sent_t = ps.nrs_sent
            desynced = (ps.height, ps.round) != (rs.height, rs.round)
            if state != sent_state or (desynced and now - sent_t >= resend_after):
                if await peer.send(STATE_CHANNEL, self._new_round_step_msg()):
                    ps.nrs_sent = (state, now)
            if rs.votes is not None and rs.height == ps.height:
                for vote_type, getter in (
                    (PREVOTE_TYPE, rs.votes.prevotes),
                    (PRECOMMIT_TYPE, rs.votes.precommits),
                ):
                    vs = getter(ps.round if ps.round >= 0 else rs.round)
                    if vs is None:
                        continue
                    maj23, ok = vs.two_thirds_majority()
                    if ok:
                        await self._maybe_send_maj23(
                            peer, ps, rs.height, vs.round, vote_type, maj23
                        )
                continue
            # Catchup-commit claim (reference reactor.go:783): the peer is
            # on an earlier height whose commit we store — claiming its
            # maj23 makes the peer answer with its REAL precommit bits,
            # repairing any falsely-marked last-commit bits in our
            # PeerRoundState so _send_commit_votes resends what they
            # actually lack.  Without this, one phantom-delivered commit
            # vote leaves a lagging peer stuck one height behind forever.
            if 0 < ps.height < rs.height and ps.height >= self.cs.block_store.base():
                commit = self.cs.block_store.load_block_commit(ps.height)
                if commit is not None:
                    await self._maybe_send_maj23(
                        peer, ps, ps.height, commit.round, PRECOMMIT_TYPE, commit.block_id
                    )

    async def _maybe_send_maj23(
        self, peer, ps: PeerRoundState, height: int, round_: int, vote_type: int, block_id
    ) -> None:
        key = (height, round_, vote_type, block_id.key())
        now = time.monotonic()
        last = ps.maj23_sent.get(key)
        resend_after = 10 * self.cs.config.peer_query_maj23_sleep_duration
        if last is not None and now - last < resend_after:
            return
        ok = await peer.send(STATE_CHANNEL, _enc("vote_set_maj23", {
            "height": height, "round": round_, "type": vote_type,
            "block_id": block_id.to_dict(),
        }))
        if ok:
            ps.maj23_sent[key] = now
            ps.prune_sent(ps.maj23_sent, now, now - resend_after)


def _sent_time(v) -> float:
    """Monotonic send time of a dedupe-map value — maj23_sent stores bare
    floats, summary_sent stores (count, time) pairs."""
    return v[1] if isinstance(v, tuple) else v


def _enc(kind: str, fields: dict) -> bytes:
    return codec.dumps({"k": kind, **fields})


def _dec(msg_bytes: bytes):
    d = codec.loads(msg_bytes)
    return d.pop("k"), d
