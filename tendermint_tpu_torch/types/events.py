"""Typed EventBus over the pubsub server (the port's copy of
tendermint_tpu/types/events.py).

Reference parity: types/event_bus.go (EventBus:32, typed Publish helpers),
types/events.go (event type strings + query constants).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..libs.events import PubSubServer, Query, Subscription
from ..libs.service import Service

# Event type strings (types/events.go)
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_POLKA = "Polka"
EVENT_LOCK = "Lock"
EVENT_RELOCK = "Relock"
EVENT_UNLOCK = "Unlock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_VOTE = "Vote"
EVENT_VALID_BLOCK = "ValidBlock"
EVENT_TX = "Tx"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"

# Reserved event tags (types/events.go:120ff)
EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"


def query_for_event(event_type: str) -> Query:
    return Query.parse(f"{EVENT_TYPE_KEY}='{event_type}'")


@dataclass
class Event:
    type: str
    data: Any


class EventBus(Service):
    """types/event_bus.go:32 — the common bus through which all events flow
    (consensus → RPC subscribers + tx indexer)."""

    def __init__(self):
        super().__init__("event-bus")
        self.pubsub = PubSubServer()

    async def on_start(self) -> None:
        await self.pubsub.start()

    async def on_stop(self) -> None:
        await self.pubsub.stop()

    def num_clients(self) -> int:
        return self.pubsub.num_clients()

    async def subscribe(
        self, subscriber: str, query: Query | str, buffer: Optional[int] = None
    ) -> Subscription:
        return await self.pubsub.subscribe(subscriber, query, buffer)

    async def unsubscribe(self, subscriber: str, query: Query | str) -> None:
        await self.pubsub.unsubscribe(subscriber, query)

    async def unsubscribe_all(self, subscriber: str) -> None:
        await self.pubsub.unsubscribe_all(subscriber)

    async def _publish(
        self, event_type: str, data: Any, extra_events: Optional[Dict[str, List[str]]] = None
    ) -> None:
        events = dict(extra_events or {})
        events.setdefault(EVENT_TYPE_KEY, []).append(event_type)
        await self.pubsub.publish(Event(event_type, data), events)

    # -- typed helpers (event_bus.go:118ff) --------------------------------
    async def publish_new_block(self, block, result_begin_block=None, result_end_block=None, abci_events=None) -> None:
        await self._publish(
            EVENT_NEW_BLOCK,
            {"block": block, "result_begin_block": result_begin_block, "result_end_block": result_end_block},
            abci_events,
        )

    async def publish_new_block_header(self, header, abci_events=None) -> None:
        await self._publish(EVENT_NEW_BLOCK_HEADER, {"header": header}, abci_events)

    async def publish_new_round(self, height: int, round_: int, proposer) -> None:
        await self._publish(
            EVENT_NEW_ROUND, {"height": height, "round": round_, "proposer": proposer}
        )

    async def publish_new_round_step(self, round_state) -> None:
        await self._publish(EVENT_NEW_ROUND_STEP, round_state)

    async def publish_complete_proposal(self, round_state) -> None:
        await self._publish(EVENT_COMPLETE_PROPOSAL, round_state)

    async def publish_polka(self, round_state) -> None:
        await self._publish(EVENT_POLKA, round_state)

    async def publish_lock(self, round_state) -> None:
        await self._publish(EVENT_LOCK, round_state)

    async def publish_unlock(self, round_state) -> None:
        await self._publish(EVENT_UNLOCK, round_state)

    async def publish_relock(self, round_state) -> None:
        await self._publish(EVENT_RELOCK, round_state)

    async def publish_timeout_propose(self, round_state) -> None:
        await self._publish(EVENT_TIMEOUT_PROPOSE, round_state)

    async def publish_timeout_wait(self, round_state) -> None:
        await self._publish(EVENT_TIMEOUT_WAIT, round_state)

    async def publish_valid_block(self, round_state) -> None:
        await self._publish(EVENT_VALID_BLOCK, round_state)

    async def publish_vote(self, vote) -> None:
        await self._publish(EVENT_VOTE, {"vote": vote})

    async def publish_validator_set_updates(self, updates) -> None:
        await self._publish(EVENT_VALIDATOR_SET_UPDATES, {"validator_updates": updates})

    async def publish_tx(self, height: int, index: int, tx: bytes, result, abci_events=None) -> None:
        """EventDataTx with reserved tx.hash / tx.height tags
        (event_bus.go:137 PublishEventTx)."""
        from .tx import tx_hash

        events = dict(abci_events or {})
        events.setdefault(TX_HASH_KEY, []).append(tx_hash(tx).hex().upper())
        events.setdefault(TX_HEIGHT_KEY, []).append(str(height))
        await self._publish(
            EVENT_TX, {"height": height, "index": index, "tx": tx, "result": result}, events
        )
