"""Scheduler: pure peer/block-request state machine (the port's copy of
tendermint_tpu/fastsync/scheduler.py).

Reference parity: blockchain/v2/scheduler.go (event-in/event-out over
peer states and block states; per-height ownership; timeout pruning;
termination detection) — no IO, fully table-testable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass
class PeerInfo:
    peer_id: str
    height: int = 0  # best height the peer claims
    base: int = 0  # lowest height the peer retains
    pending: Set[int] = field(default_factory=set)  # heights requested from it


class Scheduler:
    """Decides which heights to request from which peers.

    All methods are synchronous, deterministic, and IO-free: inputs are
    events (peer status, block receipt, processing results, time), outputs
    are request lists / state queries.
    """

    def __init__(
        self,
        initial_height: int,
        max_pending_per_peer: int = 20,
        max_total_pending: int = 600,  # v0 pool's requester cap
        request_timeout: float = 15.0,
    ):
        self.height = initial_height  # next height to schedule/process
        self.max_pending_per_peer = max_pending_per_peer
        self.max_total_pending = max_total_pending
        self.request_timeout = request_timeout
        self.peers: Dict[str, PeerInfo] = {}
        self.pending: Dict[int, Tuple[str, float]] = {}  # height -> (peer, at)
        self.received: Dict[int, str] = {}  # height -> peer that delivered

    # -- peer events -------------------------------------------------------
    def add_peer(self, peer_id: str) -> None:
        if peer_id not in self.peers:
            self.peers[peer_id] = PeerInfo(peer_id)

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        """Status response (scheduler.go setPeerRange)."""
        self.add_peer(peer_id)
        p = self.peers[peer_id]
        if height < p.height:
            return  # peers may not regress
        p.base, p.height = base, height

    def remove_peer(self, peer_id: str) -> List[int]:
        """Returns heights that must be rescheduled: both in-flight requests
        and received-but-unprocessed blocks this peer delivered (v0
        pool.removePeer redoes those requesters immediately — an invalid
        block from a punished peer means its other queued blocks are
        suspect too)."""
        p = self.peers.pop(peer_id, None)
        if p is None:
            return []
        freed = []
        for h, (owner, _) in list(self.pending.items()):
            if owner == peer_id:
                del self.pending[h]
                freed.append(h)
        for h, owner in list(self.received.items()):
            if owner == peer_id:
                del self.received[h]
                freed.append(h)
        return freed

    # -- block events ------------------------------------------------------
    def block_received(self, peer_id: str, height: int) -> bool:
        """False = unsolicited/wrong peer (punishable)."""
        owner = self.pending.get(height)
        if owner is None or owner[0] != peer_id:
            return False
        del self.pending[height]
        self.received[height] = peer_id
        p = self.peers.get(peer_id)
        if p is not None:
            p.pending.discard(height)
        return True

    def no_block(self, peer_id: str, height: int) -> None:
        """Peer says it doesn't have the block: free the height."""
        owner = self.pending.get(height)
        if owner is not None and owner[0] == peer_id:
            del self.pending[height]
            p = self.peers.get(peer_id)
            if p is not None:
                p.pending.discard(height)

    def block_processed(self, height: int) -> None:
        if height != self.height:
            raise ValueError(f"processed {height}, expected {self.height}")
        self.received.pop(height, None)
        self.height += 1

    def block_invalid(self, height: int) -> Tuple[Optional[str], List[int]]:
        """Verification failed: requeue from someone else.  Returns (peer to
        punish, all heights freed for re-request — including the peer's
        other received-but-unprocessed deliveries, which are now suspect)."""
        peer = self.received.pop(height, None)
        freed = [height]
        if peer is not None:
            freed.extend(self.remove_peer(peer))
        return peer, freed

    # -- scheduling --------------------------------------------------------
    def max_peer_height(self) -> int:
        return max((p.height for p in self.peers.values()), default=0)

    def next_requests(self, now: float) -> List[Tuple[str, int]]:
        """(peer, height) pairs to request next; also re-assigns timed-out
        pending requests."""
        # prune timeouts
        for h, (owner, at) in list(self.pending.items()):
            if now - at > self.request_timeout:
                del self.pending[h]
                p = self.peers.get(owner)
                if p is not None:
                    p.pending.discard(h)

        out: List[Tuple[str, int]] = []
        target = self.max_peer_height()
        h = self.height
        while len(self.pending) + len(out) < self.max_total_pending and h <= target:
            if h in self.pending or h in self.received:
                h += 1
                continue
            if not any(p.base <= h <= p.height for p in self.peers.values()):
                # No peer retains height h at all (pruned below its base):
                # processing is contiguous, so nothing past h can be applied —
                # requesting ahead would only waste bandwidth and break the
                # processor's two-contiguous-blocks invariant.
                break
            peer = self._pick_peer_for(h)
            if peer is None:
                h += 1  # capacity-limited only: requesting ahead is fine
                continue
            out.append((peer.peer_id, h))
            peer.pending.add(h)
            h += 1
        return out

    def mark_requested(self, peer_id: str, height: int, now: float) -> None:
        self.pending[height] = (peer_id, now)

    def _pick_peer_for(self, height: int) -> Optional[PeerInfo]:
        candidates = [
            p
            for p in self.peers.values()
            if p.base <= height <= p.height and len(p.pending) < self.max_pending_per_peer
        ]
        if not candidates:
            return None
        return min(candidates, key=lambda p: len(p.pending))

    def is_caught_up(self) -> bool:
        """v0 pool.IsCaughtUp (blockchain/v0/pool.go:168): at/above every
        peer's best height, with at least one peer known — and nothing
        received but still unprocessed (switching to consensus while blocks
        wait in the processor would drop them on the floor)."""
        if not self.peers:
            return False
        return self.height >= self.max_peer_height() and not self.received

    def only_tip_outstanding(self) -> bool:
        """The v0 `maxPeerHeight-1` tolerance (blockchain/v0/pool.go:168),
        made explicit: everything below tip-1 is processed, where tip is the
        best claimed peer height.  The tip cannot be fastsync-verified —
        verifying block H requires block H+1's commit — so the reactor hands
        over to consensus, whose catchup gossip fetches the remainder.  The
        -1 also keeps handover live when the tallest peer claims a height it
        never delivers (reference v0 switches at maxPeerHeight-1 for the
        same reason).  Received-but-unprocessed heights never block this:
        the reactor exhausts processable pairs before checking, so whatever
        remains is unprovable without future blocks."""
        if not self.peers:
            return False
        return self.height >= self.max_peer_height() - 1
