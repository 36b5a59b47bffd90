"""Chunk-fetch scheduler: pure state machine for snapshot chunk transfer
(the port's copy of tendermint_tpu/statesync/chunker.py).

No reference counterpart file — the reference's statesync chunk queue
(statesync/chunks.go) is IO-entangled; this follows the repo's fastsync
split (scheduler = table-testable FSM, reactor = IO).  Responsibilities:

  * spread chunk requests across the peers advertising the snapshot,
    bounded in-flight per peer;
  * per-chunk request timeout with bounded retries and exponential
    backoff between attempts;
  * SHA-256 verification of every received chunk against the snapshot
    metadata's chunk-hash list — a mismatch requeues the chunk with a
    different-peer preference and names the serving peer for banning;
  * strict in-order release to the applier (ABCI ApplySnapshotChunk
    applies chunks sequentially).

All methods are synchronous and IO-free; the syncer drives it from
event wakeups (chunk arrivals, peer changes, timeouts).
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

TODO = "todo"
REQUESTED = "requested"
RECEIVED = "received"
APPLIED = "applied"


class ChunkScheduler:
    def __init__(
        self,
        chunk_hashes: Sequence[bytes],
        timeout: float = 10.0,
        max_retries: int = 4,
        backoff_base: float = 0.25,
        max_inflight_per_peer: int = 4,
    ):
        if not chunk_hashes:
            raise ValueError("snapshot must have at least one chunk")
        self.hashes = list(chunk_hashes)
        self.total = len(self.hashes)
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.max_inflight_per_peer = max_inflight_per_peer

        self.status: List[str] = [TODO] * self.total
        self.data: Dict[int, bytes] = {}
        self.owner: Dict[int, Tuple[str, float]] = {}  # idx -> (peer, requested_at)
        self.retries: Dict[int, int] = {i: 0 for i in range(self.total)}
        self.ready_at: Dict[int, float] = {i: 0.0 for i in range(self.total)}  # backoff gate
        self.avoid: Dict[int, Set[str]] = {i: set() for i in range(self.total)}  # bad servers
        self.peers: Dict[str, Set[int]] = {}  # peer -> in-flight chunk idxs
        self.served_by: Dict[int, str] = {}  # idx -> peer that delivered it
        self.banned: Set[str] = set()
        self.apply_next = 0  # next chunk index to hand to the app
        self.exhausted: Optional[int] = None  # chunk that ran out of retries

    # -- peers -------------------------------------------------------------
    def add_peer(self, peer_id: str) -> None:
        if peer_id not in self.banned:
            self.peers.setdefault(peer_id, set())

    def remove_peer(self, peer_id: str) -> None:
        inflight = self.peers.pop(peer_id, set())
        for idx in inflight:
            if self.status[idx] == REQUESTED:
                self.status[idx] = TODO
                self.owner.pop(idx, None)

    def ban_peer(self, peer_id: str) -> None:
        self.banned.add(peer_id)
        self.remove_peer(peer_id)

    # -- scheduling --------------------------------------------------------
    def _expire_timeouts(self, now: float) -> None:
        for idx, (peer, at) in list(self.owner.items()):
            if self.status[idx] == REQUESTED and now - at > self.timeout:
                self._requeue(idx, now, avoid_peer=peer)

    def _requeue(self, idx: int, now: float, avoid_peer: Optional[str] = None) -> None:
        peer, _ = self.owner.pop(idx, (None, 0.0))
        if peer is not None and peer in self.peers:
            self.peers[peer].discard(idx)
        if avoid_peer:
            self.avoid[idx].add(avoid_peer)
        self.retries[idx] += 1
        if self.retries[idx] > self.max_retries:
            self.exhausted = idx
            return
        self.status[idx] = TODO
        self.ready_at[idx] = now + self.backoff_base * (2 ** (self.retries[idx] - 1))

    def next_requests(self, now: float) -> List[Tuple[str, int]]:
        """(peer, chunk_index) pairs to request now; reaps timeouts first.
        Assignments made within one call count toward peer load, so a
        burst of TODO chunks spreads across peers instead of piling onto
        the first one."""
        self._expire_timeouts(now)
        out: List[Tuple[str, int]] = []
        tentative: Dict[str, int] = {}
        for idx in range(self.total):
            if self.status[idx] != TODO or now < self.ready_at[idx]:
                continue
            peer = self._pick_peer(idx, tentative)
            if peer is None:
                continue
            tentative[peer] = tentative.get(peer, 0) + 1
            out.append((peer, idx))
        return out

    def _pick_peer(self, idx: int, tentative: Dict[str, int]) -> Optional[str]:
        """Least-loaded peer not implicated for this chunk; fall back to
        any peer when only implicated ones remain (last resort beats a
        wedge — the hash check still rejects bad data)."""
        def load(p: str) -> int:
            return len(self.peers[p]) + tentative.get(p, 0)

        candidates = [
            p for p in self.peers
            if load(p) < self.max_inflight_per_peer and p not in self.avoid[idx]
        ]
        if not candidates:
            candidates = [p for p in self.peers if load(p) < self.max_inflight_per_peer]
        if not candidates:
            return None
        return min(candidates, key=lambda p: (load(p), p))

    def mark_requested(self, peer_id: str, idx: int, now: float) -> None:
        self.status[idx] = REQUESTED
        self.owner[idx] = (peer_id, now)
        self.peers.setdefault(peer_id, set()).add(idx)

    # -- chunk events ------------------------------------------------------
    def chunk_received(self, peer_id: str, idx: int, chunk: bytes, now: float) -> str:
        """Returns "ok", "dup", "unsolicited" or "bad_hash".  A bad hash
        requeues the chunk avoiding this peer; the caller bans the peer."""
        if idx < 0 or idx >= self.total:
            return "unsolicited"
        if self.status[idx] in (RECEIVED, APPLIED):
            return "dup"
        owner = self.owner.get(idx)
        if owner is None or owner[0] != peer_id:
            return "unsolicited"
        if hashlib.sha256(chunk).digest() != self.hashes[idx]:
            self._requeue(idx, now, avoid_peer=peer_id)
            self.ban_peer(peer_id)
            return "bad_hash"
        self.owner.pop(idx, None)
        self.peers.get(peer_id, set()).discard(idx)
        self.status[idx] = RECEIVED
        self.data[idx] = chunk
        self.served_by[idx] = peer_id
        return "ok"

    def chunk_missing(self, peer_id: str, idx: int, now: float) -> None:
        """Peer says it doesn't have the chunk: requeue elsewhere, counting
        against the retry budget — when EVERY peer has pruned the snapshot
        (a fast chain outran the restore) this must converge to failure so
        the syncer can move to a fresher snapshot instead of spinning."""
        owner = self.owner.get(idx)
        if owner is not None and owner[0] == peer_id:
            self._requeue(idx, now, avoid_peer=peer_id)

    # -- applying ----------------------------------------------------------
    def next_apply(self) -> Optional[Tuple[int, bytes, str]]:
        """The next in-order (index, chunk, sender) ready for the app."""
        idx = self.apply_next
        if idx < self.total and self.status[idx] == RECEIVED:
            return idx, self.data[idx], self.served_by.get(idx, "")
        return None

    def mark_applied(self, idx: int) -> None:
        self.status[idx] = APPLIED
        self.data.pop(idx, None)
        self.apply_next = idx + 1

    def refetch(self, idx: int, now: float, avoid_peer: Optional[str] = None) -> None:
        """App asked for this chunk again (RETRY / refetch_chunks)."""
        if 0 <= idx < self.total and self.status[idx] != APPLIED:
            self.data.pop(idx, None)
            if self.status[idx] == RECEIVED:
                self.status[idx] = TODO
                self.retries[idx] += 1
                if self.retries[idx] > self.max_retries:
                    self.exhausted = idx
                if avoid_peer:
                    self.avoid[idx].add(avoid_peer)
            else:
                self._requeue(idx, now, avoid_peer=avoid_peer)

    # -- termination -------------------------------------------------------
    def done(self) -> bool:
        return self.apply_next >= self.total

    def is_failed(self) -> bool:
        """A chunk exhausted its retry budget, or no usable peers remain
        while work is outstanding."""
        if self.exhausted is not None:
            return True
        return not self.peers and not self.done()
