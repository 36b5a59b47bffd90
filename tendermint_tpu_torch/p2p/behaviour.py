"""Peer-behaviour reporting (the port's copy of tendermint_tpu/p2p/behaviour.py).

Reference parity: behaviour/peer_behaviour.go + reporter.go — a small
indirection so reactors report peer conduct (good votes/parts, bad or
out-of-order messages) to one component instead of calling the switch
directly, and tests can assert WHAT a reactor reported without a live
switch (MockReporter).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

# behaviour kinds (peer_behaviour.go constructors)
CONSENSUS_VOTE = "consensus_vote"  # good conduct
BLOCK_PART = "block_part"  # good conduct
BAD_MESSAGE = "bad_message"
MESSAGE_OUT_OF_ORDER = "message_out_of_order"

_GOOD = {CONSENSUS_VOTE, BLOCK_PART}
_BAD = {BAD_MESSAGE, MESSAGE_OUT_OF_ORDER}


@dataclass(frozen=True)
class PeerBehaviour:
    peer_id: str
    kind: str
    explanation: str = ""


def consensus_vote(peer_id: str, explanation: str = "") -> PeerBehaviour:
    return PeerBehaviour(peer_id, CONSENSUS_VOTE, explanation)


def block_part(peer_id: str, explanation: str = "") -> PeerBehaviour:
    return PeerBehaviour(peer_id, BLOCK_PART, explanation)


def bad_message(peer_id: str, explanation: str = "") -> PeerBehaviour:
    return PeerBehaviour(peer_id, BAD_MESSAGE, explanation)


def message_out_of_order(peer_id: str, explanation: str = "") -> PeerBehaviour:
    return PeerBehaviour(peer_id, MESSAGE_OUT_OF_ORDER, explanation)


class SwitchReporter:
    """reporter.go:17 — routes behaviours to the switch: good conduct
    marks the address book, bad conduct stops the peer."""

    def __init__(self, switch):
        self.switch = switch

    async def report(self, behaviour: PeerBehaviour) -> bool:
        peer = self.switch.peers.get(behaviour.peer_id)
        if peer is None:
            return False
        if behaviour.kind in _GOOD:
            if self.switch.addr_book is not None:
                self.switch.addr_book.mark_good(behaviour.peer_id)
            return True
        if behaviour.kind in _BAD:
            # stop_peer_for_error feeds the trust store (mark_failed);
            # the decayed score then demotes the peer in dial selection
            await self.switch.stop_peer_for_error(peer, behaviour.explanation)
            return True
        raise ValueError(f"unknown behaviour kind {behaviour.kind!r}")


class MockReporter:
    """reporter.go:53 — records reports for reactor tests."""

    def __init__(self):
        self.reports: Dict[str, List[PeerBehaviour]] = {}

    async def report(self, behaviour: PeerBehaviour) -> bool:
        self.reports.setdefault(behaviour.peer_id, []).append(behaviour)
        return True

    def get(self, peer_id: str) -> List[PeerBehaviour]:
        return list(self.reports.get(peer_id, []))
