"""Evidence reactor: gossips pending evidence (the port's copy of
tendermint_tpu/evidence_reactor.py).

Reference parity: evidence/reactor.go (channel 0x38:17,
broadcastEvidenceRoutine:107, peer-height withholding :157).
"""

from __future__ import annotations

import asyncio
from typing import List

from .encoding import codec
from .evidence import EvidencePool
from .libs.log import get_logger
from .p2p import ChannelDescriptor, Reactor

EVIDENCE_CHANNEL = 0x38
BROADCAST_FALLBACK_INTERVAL = 10.0


class EvidenceReactor(Reactor):
    def __init__(self, pool: EvidencePool):
        super().__init__("evidence-reactor")
        self.pool = pool
        self.log = get_logger("evidence-reactor")
        self._routines = {}
        self._peer_events: dict = {}  # per-peer wakeups (shared event races)

        def _wake_all(ev):
            for e in self._peer_events.values():
                e.set()

        pool.on_evidence.append(_wake_all)

    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(id=EVIDENCE_CHANNEL, priority=5, send_queue_capacity=32)]

    async def add_peer(self, peer) -> None:
        self._peer_events[peer.id] = asyncio.Event()
        self._routines[peer.id] = self.spawn(
            self._broadcast_routine(peer), f"ev-bcast-{peer.id[:8]}"
        )

    async def remove_peer(self, peer, reason=None) -> None:
        task = self._routines.pop(peer.id, None)
        self._peer_events.pop(peer.id, None)
        if task is not None:
            task.cancel()

    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            evs = codec.loads(msg_bytes)["evidence"]
        except Exception:
            await self.switch.stop_peer_for_error(peer, "malformed evidence message")
            return
        for ev in evs:
            try:
                self.pool.add_evidence(ev)
            except ValueError as e:
                self.log.info("invalid evidence from peer", peer=peer.id[:12], err=str(e))
                await self.switch.stop_peer_for_error(peer, f"invalid evidence: {e}")
                return

    def _peer_height(self, peer) -> int:
        """The peer's consensus height via the PeerRoundState the consensus
        reactor attaches to the peer — the reference's peer.Get(PeerStateKey)
        pattern (evidence/reactor.go:157)."""
        ps = peer.get("cs_peer_state")
        return getattr(ps, "height", 0) if ps is not None else 0

    async def _broadcast_routine(self, peer) -> None:
        """reactor.go:107 — event-driven (woken on add_evidence), with a
        slow fallback rescan instead of a 10 Hz poll per peer.  Evidence
        for heights the peer hasn't reached is WITHHELD (not marked sent):
        the peer could not validate it yet; the rescan retries once the
        peer catches up (reactor.go:157)."""
        sent: set = set()
        wake = self._peer_events[peer.id]
        while True:
            wake.clear()  # before scanning, so adds during the scan re-set it
            peer_h = self._peer_height(peer)
            fresh, withheld = [], False
            pending = self.pool.pending_evidence()
            # Bound the sent set: an entry is only needed while the
            # evidence can still be re-scanned, i.e. while it is pending.
            # Once committed or expired it leaves the pool and can never
            # be re-sent, so its hash is dead weight — on a long-lived
            # peer the set used to grow forever.
            sent.intersection_update(ev.hash() for ev in pending)
            for ev in pending:
                if ev.hash() in sent:
                    continue
                if ev.height() <= peer_h:
                    fresh.append(ev)
                else:
                    withheld = True
            if fresh:
                ok = await peer.send(EVIDENCE_CHANNEL, codec.dumps({"evidence": fresh}))
                if not ok:
                    return
                sent.update(ev.hash() for ev in fresh)
            if withheld:
                # catching-up peer: fast-poll ONLY its height (the
                # reference's peerCatchupSleepInterval); the pool is only
                # rescanned once the height actually moves or we're woken
                while True:
                    try:
                        await asyncio.wait_for(wake.wait(), 0.1)
                        break  # new evidence arrived: rescan
                    except asyncio.TimeoutError:
                        if self._peer_height(peer) > peer_h:
                            break  # peer advanced: rescan
            else:
                try:
                    await asyncio.wait_for(wake.wait(), BROADCAST_FALLBACK_INTERVAL)
                except asyncio.TimeoutError:
                    pass
