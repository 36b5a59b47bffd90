"""Per-link fault policies: the runtime-controllable upgrade of p2p/fuzz
(the port's copy of tendermint_tpu/chaos/link.py).

The old PeerFuzz (p2p/fuzz.go parity) was one probability knob applied to
every peer for the life of the connection — enough for a loss soak, useless
for staging a partition that HEALS.  A LinkPolicyTable instead keys
policies by destination peer id (with a `"*"` default), is consulted on
EVERY send, and can be mutated at runtime by the scenario orchestrator
(direct handle in-process, `unsafe_chaos_link` RPC on the process rig):
set drop=1.0 toward a peer and the link is partitioned; clear it and
gossip resumes on the very next wakeup.

Directionality: each node's table governs its OUTBOUND sends only.  A
symmetric partition between A and B is two entries — drop=1.0 in A's table
toward B and in B's toward A; an asymmetric link (A hears B, B doesn't
hear A) is one.

Semantics inherited from the fuzz layer (and kept for the same reason —
see the TCP-invariant discussion there): a dropped send REPORTS FAILURE
instead of fabricating phantom delivery, and inbound drops don't exist —
all loss is injected on the send side where it is honestly reportable.
`try_send` is covered too: a drop refuses synchronously; a delayed or
throttled try_send is accepted (True) and delivered later by a spawned
task, which models a deep send queue rather than loss.

Determinism: one seeded RNG per table drives every probabilistic decision
and every jitter draw, so a single-loop in-process net replays the same
fault sequence for the same seed and send order.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field, replace
from typing import Dict, Optional

from ..libs.log import get_logger


@dataclass(frozen=True)
class LinkPolicy:
    """Faults applied to one directional link.  The zero policy is a
    healthy link (the table's fast path skips wrapping work for it)."""

    drop: float = 0.0  # P(refuse a send); 1.0 = hard partition
    delay: float = 0.0  # fixed added latency per message (seconds)
    jitter: float = 0.0  # + uniform[0, jitter) seconds
    rate_bytes_per_sec: float = 0.0  # token-bucket throttle; 0 = unlimited

    def is_healthy(self) -> bool:
        return (
            self.drop <= 0.0
            and self.delay <= 0.0
            and self.jitter <= 0.0
            and self.rate_bytes_per_sec <= 0.0
        )

    def to_dict(self) -> dict:
        return {
            "drop": self.drop,
            "delay": self.delay,
            "jitter": self.jitter,
            "rate_bytes_per_sec": self.rate_bytes_per_sec,
        }


#: Convenience: the full-partition policy.
PARTITIONED = LinkPolicy(drop=1.0)


class _Bucket:
    """Token bucket for one throttled link (monotonic loop time)."""

    __slots__ = ("rate", "tokens", "last")

    def __init__(self, rate: float):
        self.rate = rate
        self.tokens = rate  # one second of burst
        self.last: Optional[float] = None

    def wait_for(self, n: int, now: float) -> float:
        """Seconds to wait before n bytes may pass; debits the bucket."""
        if self.last is None:
            self.last = now
        self.tokens = min(self.rate, self.tokens + (now - self.last) * self.rate)
        self.last = now
        self.tokens -= n
        if self.tokens >= 0:
            return 0.0
        return -self.tokens / self.rate


class PeerLink:
    """The per-peer installed wrapper.  Keeps the counters the old
    PeerFuzz exposed (tests and operators read `peer.fuzz.dropped_sends`)
    and consults the owning table's CURRENT policy on every send."""

    def __init__(self, table: "LinkPolicyTable", peer):
        self.table = table
        self.peer_id = peer.id
        self.dropped_sends = 0
        self.dropped_recvs = 0  # inbound drops intentionally don't exist
        self.delayed_sends = 0
        self.throttled_bytes = 0

    def drop_recv(self) -> bool:
        """Legacy PeerFuzz surface — all loss is send-side (see module
        docstring); inbound chaos would fabricate phantom-delivery state
        the real transport cannot produce."""
        return False


class LinkPolicyTable:
    """All chaos links of one node, keyed by destination peer id.

    `install(peer)` wraps `peer.send`/`peer.try_send`; the wrapper looks
    the policy up at CALL time, so `set_policy`/`heal` take effect on the
    next message without touching connections — the transport (and its
    ping/pong liveness) stays up, exactly like a real network partition
    at the IP layer with TCP keepalives still flowing."""

    WILDCARD = "*"

    def __init__(self, seed: Optional[int] = None, metrics=None, recorder=None):
        self.rng = random.Random(seed)
        self.seed = seed
        self._policies: Dict[str, LinkPolicy] = {}
        self._buckets: Dict[str, _Bucket] = {}
        self.links: Dict[str, PeerLink] = {}  # peer id -> installed wrapper
        self.metrics = metrics  # ChaosMetrics or None
        self.recorder = recorder  # FlightRecorder or None
        self.log = get_logger("chaos.link")

    # -- policy control (the scenario orchestrator's surface) --------------

    def set_policy(self, peer_id: str, policy: LinkPolicy) -> None:
        """Set (or clear, when healthy) the policy toward `peer_id`
        (p2p id prefix match is NOT done — exact id or "*")."""
        if policy.is_healthy():
            self._policies.pop(peer_id, None)
            self._buckets.pop(peer_id, None)
        else:
            self._policies[peer_id] = policy
            if policy.rate_bytes_per_sec > 0:
                self._buckets[peer_id] = _Bucket(policy.rate_bytes_per_sec)
            else:
                self._buckets.pop(peer_id, None)
        if self.recorder is not None:
            self.recorder.record(
                "chaos.link", peer=peer_id[:12], **policy.to_dict()
            )
        if self.metrics is not None:
            self.metrics.links_degraded.set(len(self._policies))
        self.log.info("link policy", peer=peer_id[:12], **policy.to_dict())

    def heal(self) -> None:
        """Clear every policy — the partition heals, all links healthy."""
        self._policies.clear()
        self._buckets.clear()
        if self.recorder is not None:
            self.recorder.record("chaos.heal")
        if self.metrics is not None:
            self.metrics.links_degraded.set(0)
        self.log.info("all links healed")

    def get(self, peer_id: str) -> Optional[LinkPolicy]:
        p = self._policies.get(peer_id)
        if p is None:
            p = self._policies.get(self.WILDCARD)
        return p

    def policies(self) -> Dict[str, dict]:
        return {pid: p.to_dict() for pid, p in self._policies.items()}

    def counters(self) -> dict:
        return {
            "dropped_sends": sum(l.dropped_sends for l in self.links.values()),
            "delayed_sends": sum(l.delayed_sends for l in self.links.values()),
            "throttled_bytes": sum(l.throttled_bytes for l in self.links.values()),
        }

    # -- installation -------------------------------------------------------

    def install(self, peer) -> PeerLink:
        # a reconnecting peer keeps its PeerLink: the cumulative fault
        # counters (counters() / unsafe_chaos_status) must never go
        # backwards just because a connection churned
        link = self.links.get(peer.id)
        if link is None:
            link = PeerLink(self, peer)
            self.links[peer.id] = link
        orig_send = peer.send
        orig_try_send = peer.try_send

        async def chaotic_send(chan_id: int, msg: bytes) -> bool:
            policy = self.get(link.peer_id)
            if policy is None:
                return await orig_send(chan_id, msg)
            wait = self._pre_send(link, policy, len(msg))
            if wait is None:
                return False  # dropped: refusal is honestly reported
            if wait > 0.0:
                link.delayed_sends += 1
                if self.metrics is not None:
                    self.metrics.msgs_delayed.inc()
                await asyncio.sleep(wait)
            return await orig_send(chan_id, msg)

        def chaotic_try_send(chan_id: int, msg: bytes) -> bool:
            policy = self.get(link.peer_id)
            if policy is None:
                return orig_try_send(chan_id, msg)
            wait = self._pre_send(link, policy, len(msg))
            if wait is None:
                return False
            if wait <= 0.0:
                return orig_try_send(chan_id, msg)
            # try_send is sync: model the delay as a deep send queue —
            # accepted now, delivered after the wait.  The delivery task
            # MUST be peer-owned (tracked, cancelled on peer stop) and
            # strongly referenced: a GC'd or orphaned task would lose an
            # "accepted" message — exactly the phantom-delivery state this
            # layer's TCP invariant forbids.  If the peer is already past
            # its spawn window, deliver inline instead of accepting a
            # message nobody will carry.
            if not peer.is_running:
                # a stopped/stopping peer cannot carry a deferred message;
                # let the real try_send refuse on its own terms (and if
                # stop races the spawn below, the connection is dying —
                # the remote observes connection death, never a phantom)
                return orig_try_send(chan_id, msg)

            async def _later():
                await asyncio.sleep(wait)
                if peer.is_running:
                    await orig_send(chan_id, msg)

            try:
                peer.spawn(_later(), f"chaos-delay-{link.peer_id[:8]}")
            except Exception:
                return orig_try_send(chan_id, msg)  # no loop/spawn: deliver now
            link.delayed_sends += 1
            if self.metrics is not None:
                self.metrics.msgs_delayed.inc()
            return True

        peer.send = chaotic_send
        peer.try_send = chaotic_try_send
        peer.fuzz = link  # legacy PeerFuzz surface (tests, operators)
        peer.link = link
        return link

    def _pre_send(self, link: PeerLink, policy: LinkPolicy, n_bytes: int):
        """Returns None to drop, else seconds of injected wait (>= 0)."""
        if policy.drop > 0.0 and self.rng.random() < policy.drop:
            link.dropped_sends += 1
            if self.metrics is not None:
                self.metrics.msgs_dropped.inc()
            return None
        wait = policy.delay
        if policy.jitter > 0.0:
            wait += self.rng.random() * policy.jitter
        if policy.rate_bytes_per_sec > 0.0:
            bucket = self._buckets.get(link.peer_id) or self._buckets.get(self.WILDCARD)
            if bucket is not None:
                loop_now = asyncio.get_event_loop().time()
                tw = bucket.wait_for(n_bytes, loop_now)
                if tw > 0.0:
                    link.throttled_bytes += n_bytes
                    wait += tw
        return wait


def degraded(drop: float = 0.0, delay: float = 0.0, jitter: float = 0.0,
             rate: float = 0.0) -> LinkPolicy:
    """Keyword-lite constructor used by the RPC route and the DSL."""
    return LinkPolicy(drop=drop, delay=delay, jitter=jitter, rate_bytes_per_sec=rate)


def flaky(policy: LinkPolicy, drop: float) -> LinkPolicy:
    return replace(policy, drop=drop)
