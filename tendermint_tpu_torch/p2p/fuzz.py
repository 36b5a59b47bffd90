"""Fuzz layer: probabilistic message loss + latency injection (the port's
copy of tendermint_tpu/p2p/fuzz.py).

Reference parity: p2p/fuzz.go:14 FuzzedConnection (ProbDropRW / MaxDelay)
— config-gated chaos for soak tests.

This module is now a thin compatibility surface over the chaos engine's
per-link policy layer (chaos/link.py).  The original PeerFuzz was one
immutable probability applied to every peer for the life of the node —
enough for the loss soak, but it could not stage a partition, heal one,
or degrade a single named link; LinkPolicyTable can, at runtime, and the
switch installs IT.  `p2p.test_fuzz` configs keep working: the node maps
them to a wildcard LinkPolicy(drop=prob_drop, jitter=max_delay).

Design notes that carried over verbatim into chaos/link.py:

- The chaos sits at the CHANNEL MESSAGE boundary, not the byte/packet
  level: under SecretConnection a byte-level drop desyncs the AEAD stream
  and under MConnection a packet drop corrupts reassembly — both turn
  "loss" into instant connection death, which tests reconnect but not
  protocol liveness under loss.
- A dropped send REPORTS FAILURE (returns False) instead of silently
  swallowing the message: tendermint gossip runs over TCP, so peer-state
  bookkeeping assumes sent == will-be-delivered unless the connection
  dies.  A silent drop plants a phantom "peer has this part/vote" bit;
  block-part bitmaps deliberately have no repair channel, so one phantom
  part can wedge a catching-up peer forever.
- Inbound drops don't exist: discarding a message the remote has already
  accounted as delivered fabricates the same phantom-delivery state — all
  loss is injected on the send side, where it is honestly reportable.
"""

from __future__ import annotations

from typing import Optional

from ..chaos.link import LinkPolicy, LinkPolicyTable, PeerLink  # noqa: F401


class PeerFuzz:
    """Legacy constructor shape (prob_drop_rw / max_delay / seed) kept for
    any external callers; internally one LinkPolicyTable with a wildcard
    policy.  `install(peer)` returns the PeerLink carrying the familiar
    dropped_sends / dropped_recvs counters."""

    def __init__(self, prob_drop_rw: float = 0.02, max_delay: float = 0.01,
                 seed: Optional[int] = None):
        self.prob_drop_rw = prob_drop_rw
        self.max_delay = max_delay
        self.table = LinkPolicyTable(seed=seed)
        self.table.set_policy(
            LinkPolicyTable.WILDCARD,
            LinkPolicy(drop=prob_drop_rw, jitter=max_delay),
        )

    def install(self, peer) -> PeerLink:
        return self.table.install(peer)


def table_from_fuzz_config(fuzz_config: dict, metrics=None, recorder=None) -> LinkPolicyTable:
    """The node/switch mapping for `[p2p] test_fuzz` configs."""
    table = LinkPolicyTable(
        seed=fuzz_config.get("seed"), metrics=metrics, recorder=recorder
    )
    table.set_policy(
        LinkPolicyTable.WILDCARD,
        LinkPolicy(
            drop=float(fuzz_config.get("prob_drop_rw", 0.02)),
            jitter=float(fuzz_config.get("max_delay", 0.01)),
        ),
    )
    return table
