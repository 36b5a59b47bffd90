"""Blockchain (fast-sync) reactor: IO around the scheduler + processor (the
port's copy of tendermint_tpu/fastsync/reactor.py).

Reference parity: blockchain/v0/reactor.go (channel 0x40:20, status
broadcast, block request/response handling, poolRoutine:216 trySync,
SwitchToConsensus handover :276) structured the v2 way (io separated from
the pure FSMs).

One deviation from the JAX reactor: an exception of the verify engine
itself (crypto.batch.EngineError: a kernel that did not build or launch) is
this node's fault, not the delivering peer's: it is logged at ERROR and
raised as p2p.LocalFault, which fails the pool routine.  Every other
exception of the commit check (a bad signature, too little power, a nil or
mistyped LastCommit) blames the peer, as in the JAX reactor.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..crypto.batch import EngineError
from ..encoding import codec
from ..libs.log import get_logger
from ..libs.service import wait_event
from ..p2p import ChannelDescriptor, LocalFault, Reactor
from ..p2p import behaviour
from ..types.block import Block, BlockID
from ..types.params import BLOCK_PART_SIZE_BYTES
from .processor import Processor
from .scheduler import Scheduler

BLOCKCHAIN_CHANNEL = 0x40
STATUS_BROADCAST_INTERVAL = 2.0
# Event-driven pool routine (the gossip design): block arrivals, status
# changes and peer churn set a wakeup event; the old 10 ms TRY_SYNC poll
# survives only as a repair fallback at 10x + a 250 ms floor (it reaps
# request timeouts and catches any missed edge).
TRY_SYNC_INTERVAL = 0.01
POOL_FALLBACK_TICK = max(TRY_SYNC_INTERVAL * 10, 0.25)
SWITCH_TO_CONSENSUS_INTERVAL = 1.0


class BlockchainReactor(Reactor):
    def __init__(
        self,
        state,  # sm State (current)
        block_exec,
        block_store,
        fast_sync: bool,
        consensus_reactor=None,  # for the handover
        wait_statesync: bool = False,  # dormant until statesync hands over
    ):
        super().__init__("blockchain-reactor")
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.fast_sync = fast_sync
        # statesync runs first: the pool routine must NOT start requesting
        # blocks from genesis while the snapshot restore is in flight —
        # switch_to_fastsync() activates it with the restored state
        self.wait_statesync = wait_statesync
        self.consensus_reactor = consensus_reactor
        self.log = get_logger("fastsync")
        # behaviour reporter (behaviour/reporter.go): peer conduct flows
        # through one component; tests inject MockReporter
        self.reporter = None  # SwitchReporter once the switch is known
        start_height = max(block_store.height() + 1, state.last_block_height + 1)
        self.scheduler = Scheduler(start_height)
        self.processor = Processor(start_height)
        self.blocks_synced = 0
        self._started_at = 0.0
        self._wake: Optional[asyncio.Event] = None
        self.statesync_metrics = None  # node wires StateSyncMetrics (phase gauge)
        # self-healing refill: quarantined (corrupt) heights to re-fetch
        # from peers — runs in EVERY mode, not just fast sync; the store
        # already answers None for them, so peers are the only source
        self.refill_heights: set = set()
        self._refill_wake: Optional[asyncio.Event] = None
        self.refilled = 0

    def get_channels(self):
        return [
            ChannelDescriptor(
                id=BLOCKCHAIN_CHANNEL,
                priority=10,
                send_queue_capacity=1000,
                recv_message_capacity=BLOCK_PART_SIZE_BYTES * 200,
            )
        ]

    async def on_start(self) -> None:
        self._started_at = time.monotonic()
        self._wake = asyncio.Event()
        self._refill_wake = asyncio.Event()
        if self.fast_sync and not self.wait_statesync:
            self.spawn(self._pool_routine(), "pool")
        self.spawn(self._status_broadcast_routine(), "status-bcast")
        self.spawn(self._refill_routine(), "refill")
        if self.refill_heights:
            self._refill_wake.set()

    def _wake_pool(self) -> None:
        if self._wake is not None:
            self._wake.set()

    async def switch_to_fastsync(self, state) -> None:
        """Statesync → fastsync handover: adopt the snapshot-restored
        state, rebuild the scheduler/processor at the new start height,
        and activate the pool routine for the tail."""
        self.state = state
        self.wait_statesync = False
        self.fast_sync = True
        start_height = max(self.block_store.height() + 1, state.last_block_height + 1)
        self.scheduler = Scheduler(start_height)
        self.processor = Processor(start_height)
        self._started_at = time.monotonic()
        if self.switch is not None:
            for peer in self.switch.peer_list():
                self.scheduler.add_peer(peer.id)
                peer.try_send(BLOCKCHAIN_CHANNEL, _enc("status_request", {}))
        self.log.info("switching to fast sync", height=state.last_block_height)
        self.spawn(self._pool_routine(), "pool")
        self._wake_pool()

    # -- peer lifecycle ----------------------------------------------------
    async def add_peer(self, peer) -> None:
        await peer.send(BLOCKCHAIN_CHANNEL, _enc("status_response", {
            "height": self.block_store.height(), "base": self.block_store.base(),
        }))
        if self.fast_sync:
            self.scheduler.add_peer(peer.id)
            self._wake_pool()

    async def remove_peer(self, peer, reason=None) -> None:
        freed = self.scheduler.remove_peer(peer.id)
        self.processor.drop_heights(freed)
        self._wake_pool()

    async def _report(self, b) -> None:
        if self.reporter is None:
            self.reporter = behaviour.SwitchReporter(self.switch)
        await self.reporter.report(b)

    # -- receive -----------------------------------------------------------
    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            kind, msg = _dec(msg_bytes)
        except Exception:
            await self._report(behaviour.bad_message(peer.id, "malformed blockchain message"))
            return
        if kind == "status_request":
            await peer.send(BLOCKCHAIN_CHANNEL, _enc("status_response", {
                "height": self.block_store.height(), "base": self.block_store.base(),
            }))
        elif kind == "status_response":
            if self.fast_sync:
                self.scheduler.set_peer_range(peer.id, msg["base"], msg["height"])
                self._wake_pool()
        elif kind == "block_request":
            await self._serve_block(peer, msg["height"])
        elif kind == "block_response":
            if not self.fast_sync and not self.refill_heights:
                # steady state with nothing pending: an unsolicited block
                # must not cost a multi-MB deserialize on the event loop
                return
            try:
                block = Block.deserialize(msg["block"])
            except Exception:
                await self._report(behaviour.bad_message(peer.id, "undecodable block response"))
                return
            if block.height in self.refill_heights:
                await self._try_refill(peer, block)
                return
            if not self.fast_sync:
                return
            if self.scheduler.block_received(peer.id, block.height):
                self.processor.add_block(block.height, block, peer.id)
                self._wake_pool()
            else:
                await self._report(
                    behaviour.message_out_of_order(peer.id, "unsolicited block")
                )
        elif kind == "no_block_response":
            if self.fast_sync:
                self.scheduler.no_block(peer.id, msg["height"])
                self._wake_pool()
            # refill: a "don't have it" just means the retry tick asks
            # someone else (or the same peer later)

    # -- quarantine refill (self-healing store) -----------------------------
    REFILL_RETRY_INTERVAL = 1.0

    def request_refill(self, heights) -> None:
        """Queue quarantined heights for re-fetch from peers.  Callable
        from any mode (boot scan, live integrity scan RPC): consensus can
        be serving at the tip while history heals underneath."""
        fresh = set(heights) - self.refill_heights
        if not fresh:
            return
        self.refill_heights |= fresh
        self.log.warn(
            "refill queued for quarantined blocks", heights=sorted(fresh)
        )
        if self._refill_wake is not None:
            self._refill_wake.set()

    async def _refill_routine(self) -> None:
        """Re-request quarantined heights round-robin across peers until
        each arrives and verifies against the surviving identity.  Block
        responses route through _try_refill; this loop only (re)issues
        requests on a slow tick — at most len(heights) small messages per
        interval, nothing at all while the set is empty."""
        rr = 0
        while True:
            if not self.refill_heights:
                await wait_event(self._refill_wake, 3600.0)
                self._refill_wake.clear()
                continue
            peers = self.switch.peer_list() if self.switch is not None else []
            if peers:
                for height in sorted(self.refill_heights):
                    peer = peers[rr % len(peers)]
                    rr += 1
                    peer.try_send(
                        BLOCKCHAIN_CHANNEL, _enc("block_request", {"height": height})
                    )
            await wait_event(self._refill_wake, self.REFILL_RETRY_INTERVAL)
            self._refill_wake.clear()

    async def _try_refill(self, peer, block) -> None:
        """A block arrived for a quarantined height: restore_block verifies
        it against the strongest surviving identity (meta / commit hash)
        and lifts the quarantine; a hash mismatch is a bad peer, not a
        reason to wedge the refill."""
        height = block.height
        if self.block_store.quarantine_expected_hash(height) is None:
            # every identity source rotted too: nothing to verify a peer
            # copy against — leave the height quarantined (served as
            # "don't have it") rather than trust an unverifiable block,
            # and stop asking for what we cannot accept
            self.log.error(
                "refill impossible: no surviving identity", height=height
            )
            self.refill_heights.discard(height)
            return
        try:
            self.block_store.restore_block(height, block)
        except ValueError as e:
            self.log.warn("refill rejected", height=height, peer=peer.id[:8], err=str(e))
            await self._report(behaviour.bad_message(peer.id, "invalid refill block"))
            return
        self.refill_heights.discard(height)
        self.refilled += 1
        self.log.info(
            "quarantined block refilled from peer",
            height=height, peer=peer.id[:8], remaining=len(self.refill_heights),
        )

    async def _serve_block(self, peer, height: int) -> None:
        block = self.block_store.load_block(height)
        if block is None:
            await peer.send(BLOCKCHAIN_CHANNEL, _enc("no_block_response", {"height": height}))
            return
        await peer.send(BLOCKCHAIN_CHANNEL, _enc("block_response", {"block": block.serialize()}))

    # -- routines ----------------------------------------------------------
    async def _status_broadcast_routine(self) -> None:
        while True:
            await self.switch.broadcast(BLOCKCHAIN_CHANNEL, _enc("status_request", {}))
            await asyncio.sleep(STATUS_BROADCAST_INTERVAL)

    async def _pool_routine(self) -> None:
        """v0 poolRoutine:216 — request scheduling + trySync + handover,
        event-driven: block arrivals / status changes / peer churn set
        `_wake`; the sleep is only the repair fallback (timeout reaping),
        so an idle syncer costs ~4 scheduler slots/sec instead of 100."""
        last_switch_check = 0.0
        while True:
            now = time.monotonic()
            # issue requests
            for peer_id, height in self.scheduler.next_requests(now):
                peer = self.switch.peers.get(peer_id)
                if peer is None:
                    self.processor.drop_heights(self.scheduler.remove_peer(peer_id))
                    continue
                if peer.try_send(BLOCKCHAIN_CHANNEL, _enc("block_request", {"height": height})):
                    self.scheduler.mark_requested(peer_id, height, now)

            # apply what we can
            await self._try_sync()

            # caught up? (grace period so peers can report their status)
            if (
                now - last_switch_check > SWITCH_TO_CONSENSUS_INTERVAL
                and now - self._started_at > SWITCH_TO_CONSENSUS_INTERVAL
            ):
                last_switch_check = now
                if self.scheduler.only_tip_outstanding():
                    await self._switch_to_consensus()
                    return
            await wait_event(self._wake, POOL_FALLBACK_TICK)
            self._wake.clear()

    async def _try_sync(self) -> None:
        """Verify + apply contiguous pairs (v0 reactor.go:244 trySync)."""
        while True:
            pair = self.processor.peek_two()
            if pair is None:
                return
            first, second = pair
            first_id = BlockID(first.hash(), first.make_part_set(BLOCK_PART_SIZE_BYTES).header())
            try:
                # verify first with second's LastCommit (batched over V sigs)
                self.state.validators.verify_commit(
                    self.state.chain_id, first_id, first.height, second.last_commit
                )
            except EngineError as e:
                # the engine's fault, not the peer's (the JAX reactor blames
                # the delivering peer here): fail the pool routine with it
                self.log.error(
                    "fast-sync commit verify failed in the engine", height=first.height, err=repr(e)
                )
                raise LocalFault(f"fast-sync commit verify failed in the engine: {e!r}") from e
            except Exception as e:
                # anything else is the block's: a bad signature, too little
                # power, a nil or mistyped LastCommit -- the peer's fault
                self.log.error("invalid block in fast sync", height=first.height, err=str(e))
                for h in self.processor.drop_invalid():
                    # block_invalid clears scheduler.received[h], removes the
                    # delivering peer, and frees that peer's other queued
                    # deliveries; drop those from the processor too so the
                    # re-requested copies are not shadowed by stale ones
                    pid, freed = self.scheduler.block_invalid(h)
                    self.processor.drop_heights(freed)
                    if pid:
                        await self._report(behaviour.bad_message(pid, "sent invalid block"))
                return
            self.block_store.save_block(
                first, first.make_part_set(BLOCK_PART_SIZE_BYTES), second.last_commit
            )
            self.state, _ = await self.block_exec.apply_block(self.state, first_id, first)
            self.processor.pop_processed()
            self.scheduler.block_processed(first.height)
            self.blocks_synced += 1
            if self.blocks_synced % 100 == 0:
                self.log.info("fast sync", height=self.processor.height, synced=self.blocks_synced)

    async def _switch_to_consensus(self) -> None:
        """reactor.go:276 — hand over to the consensus reactor."""
        self.log.info(
            "switching to consensus", height=self.state.last_block_height, synced=self.blocks_synced
        )
        self.fast_sync = False
        if self.consensus_reactor is not None and self.consensus_reactor.cs is not None:
            self.consensus_reactor.cs.metrics.fast_syncing.set(0)
        if self.statesync_metrics is not None:
            self.statesync_metrics.sync_phase.set(self.statesync_metrics.PHASE_CAUGHT_UP)
        if self.consensus_reactor is not None:
            await self.consensus_reactor.switch_to_consensus(self.state, self.blocks_synced)
            # late gossip routines for peers added while syncing
            for peer in self.switch.peer_list():
                ps = self.consensus_reactor.peer_states.get(peer.id)
                if ps is not None and peer.id not in self.consensus_reactor._routines:
                    self.consensus_reactor._start_gossip(peer, ps)


def _enc(kind: str, fields: dict) -> bytes:
    return codec.dumps({"k": kind, **fields})


def _dec(msg_bytes: bytes):
    d = codec.loads(msg_bytes)
    return d.pop("k"), d
