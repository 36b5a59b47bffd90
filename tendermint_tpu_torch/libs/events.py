"""Event bus: typed pub/sub with a query language (the port's copy of
tendermint_tpu/libs/events.py).

Counterpart of the reference's `libs/pubsub` server +
`libs/pubsub/query` language + `types/event_bus.go` wrapper.  Queries of the
form ``tm.event='NewBlock' AND tx.height>5`` are parsed into predicate trees
and matched against event tag maps, powering WebSocket subscriptions and the
tx indexer (reference: libs/pubsub/pubsub.go, libs/pubsub/query/query.go).
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .service import Service


# ---------------------------------------------------------------------------
# Query language.  Grammar (reference libs/pubsub/query/query.peg):
#   conditions joined by AND; condition = tag op operand
#   ops: = < <= > >= CONTAINS EXISTS; operands: 'string' | number | time
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<and>AND\b)|(?P<op><=|>=|=|<|>|\bCONTAINS\b|\bEXISTS\b)"
    r"|(?P<str>'[^']*')|(?P<num>-?\d+(?:\.\d+)?)|(?P<tag>[A-Za-z_][\w.\-]*))",
    re.IGNORECASE,
)


@dataclass(frozen=True)
class Condition:
    tag: str
    op: str  # '=', '<', '<=', '>', '>=', 'CONTAINS', 'EXISTS'
    operand: Any = None

    def matches(self, events: Dict[str, List[str]]) -> bool:
        values = events.get(self.tag)
        if values is None:
            return False
        if self.op == "EXISTS":
            return True
        for v in values:
            if self._match_one(v):
                return True
        return False

    def _match_one(self, value: str) -> bool:
        op, operand = self.op, self.operand
        if op == "CONTAINS":
            return str(operand) in value
        if isinstance(operand, (int, float)):
            try:
                num = float(value)
            except ValueError:
                return False
            if op == "=":
                return num == float(operand)
            if op == "<":
                return num < float(operand)
            if op == "<=":
                return num <= float(operand)
            if op == ">":
                return num > float(operand)
            if op == ">=":
                return num >= float(operand)
            return False
        if op == "=":
            return value == str(operand)
        # string ordering comparisons are not supported by the reference either
        return False


class Query:
    """Parsed pubsub query: conjunction of conditions."""

    def __init__(self, conditions: List[Condition], source: str = ""):
        self.conditions = conditions
        self._source = source or " AND ".join(
            f"{c.tag} {c.op} {c.operand!r}" for c in conditions
        )

    @classmethod
    def parse(cls, s: str) -> "Query":
        pos, toks = 0, []
        while pos < len(s):
            m = _TOKEN_RE.match(s, pos)
            if not m or m.end() == pos:
                if s[pos:].strip() == "":
                    break
                raise ValueError(f"query parse error at {pos}: {s[pos:]!r}")
            pos = m.end()
            kind = m.lastgroup
            text = m.group(kind)
            toks.append((kind, text))
        conds: List[Condition] = []
        i = 0
        while i < len(toks):
            kind, text = toks[i]
            if kind == "and":
                i += 1
                continue
            if kind != "tag":
                raise ValueError(f"expected tag, got {text!r}")
            tag = text
            if i + 1 >= len(toks) or toks[i + 1][0] != "op":
                raise ValueError(f"expected operator after tag {tag!r}")
            op = toks[i + 1][1].upper()
            if op == "EXISTS":
                conds.append(Condition(tag, "EXISTS"))
                i += 2
                continue
            if i + 2 >= len(toks):
                raise ValueError(f"expected operand after {tag} {op}")
            okind, otext = toks[i + 2]
            if okind == "str":
                operand: Any = otext[1:-1]
            elif okind == "num":
                operand = float(otext) if "." in otext else int(otext)
            else:
                raise ValueError(f"bad operand {otext!r}")
            conds.append(Condition(tag, op, operand))
            i += 3
        return cls(conds, s)

    def matches(self, events: Dict[str, List[str]]) -> bool:
        return all(c.matches(events) for c in self.conditions)

    def __str__(self) -> str:
        return self._source

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and str(self) == str(other)

    def __hash__(self) -> int:
        return hash(str(self))


# ---------------------------------------------------------------------------
# Pub/sub server
# ---------------------------------------------------------------------------


@dataclass
class Message:
    data: Any
    events: Dict[str, List[str]] = field(default_factory=dict)


_CANCEL_SENTINEL = object()


class Subscription:
    """A buffered event stream for one (subscriber, query) pair.

    Reference parity: per-subscriber buffered channels
    (libs/pubsub/pubsub.go:60); a full buffer cancels the subscription the
    same way the reference unsubscribes slow clients.  Cancellation wakes
    consumers blocked in `next()` (the reference closes the channel).
    """

    def __init__(self, subscriber: str, query: Query, buffer: int):
        self.subscriber = subscriber
        self.query = query
        # +1 slot so the cancel sentinel always fits even on overflow-cancel.
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=buffer + 1)
        self.cancelled = False
        self.cancel_reason = ""

    def cancel(self, reason: str) -> None:
        if self.cancelled:
            return
        self.cancelled = True
        self.cancel_reason = reason
        try:
            self.queue.put_nowait(_CANCEL_SENTINEL)
        except asyncio.QueueFull:
            pass

    async def next(self) -> Message:
        if self.cancelled and self.queue.empty():
            raise SubscriptionCancelled(self.cancel_reason)
        msg = await self.queue.get()
        if msg is _CANCEL_SENTINEL:
            # keep the sentinel visible to other blocked consumers
            try:
                self.queue.put_nowait(_CANCEL_SENTINEL)
            except asyncio.QueueFull:
                pass
            raise SubscriptionCancelled(self.cancel_reason)
        return msg

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        try:
            return await self.next()
        except SubscriptionCancelled:
            raise StopAsyncIteration


class SubscriptionCancelled(Exception):
    pass


class PubSubServer(Service):
    """In-process pub/sub matching published tag maps against queries."""

    def __init__(self, buffer: int = 1000):
        super().__init__("pubsub")
        self._buffer = buffer
        self._subs: Dict[tuple[str, str], Subscription] = {}

    async def subscribe(
        self, subscriber: str, query: Query | str, buffer: Optional[int] = None
    ) -> Subscription:
        if isinstance(query, str):
            query = Query.parse(query)
        key = (subscriber, str(query))
        if key in self._subs:
            raise ValueError(f"already subscribed: {key}")
        sub = Subscription(subscriber, query, buffer or self._buffer)
        self._subs[key] = sub
        return sub

    async def unsubscribe(self, subscriber: str, query: Query | str) -> None:
        key = (subscriber, str(query) if not isinstance(query, str) else str(Query.parse(query)))
        sub = self._subs.pop(key, None)
        if sub:
            sub.cancel("unsubscribed")

    async def unsubscribe_all(self, subscriber: str) -> None:
        for key in [k for k in self._subs if k[0] == subscriber]:
            self._subs.pop(key).cancel("unsubscribed")

    def num_clients(self) -> int:
        return len({k[0] for k in self._subs})

    async def publish(self, data: Any, events: Optional[Dict[str, List[str]]] = None) -> None:
        events = events or {}
        for key, sub in list(self._subs.items()):
            if sub.cancelled or not sub.query.matches(events):
                continue
            if sub.queue.qsize() >= sub.queue.maxsize - 1:
                # Slow subscriber: cancel, like the reference's
                # ErrOutOfCapacity unsubscribe path (the spare slot is
                # reserved for the cancel sentinel).
                sub.cancel("out of capacity")
                self._subs.pop(key, None)
                continue
            sub.queue.put_nowait(Message(data, events))

    async def on_stop(self) -> None:
        for sub in self._subs.values():
            sub.cancel("server stopped")
        self._subs.clear()
