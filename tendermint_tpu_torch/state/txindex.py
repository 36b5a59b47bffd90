"""Transaction indexer: indexes TxResults by hash + composite event keys
(the port's copy of tendermint_tpu/state/txindex.py).

Reference parity: state/txindex/ (TxIndexer iface indexer.go,
IndexerService indexer_service.go — subscribes to the EventBus;
kv impl state/txindex/kv/kv.go — keys `<event.key>/<value>/<height>/<index>`
powering tx_search).
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from ..encoding import codec
from ..libs.events import Query
from ..libs.kvstore import KVStore
from ..libs.service import Service
from ..types import events as tme
from ..types.tx import tx_hash


class TxIndexer:
    """kv indexer (state/txindex/kv/kv.go)."""

    def __init__(self, db: KVStore, index_all_events: bool = True):
        self.db = db
        self.index_all_events = index_all_events

    @staticmethod
    def _k_hash(h: bytes) -> bytes:
        return b"tx.hash/" + h

    @staticmethod
    def _esc(s: str) -> str:
        # '/' delimits key segments; attacker-controlled ABCI event values
        # must not be able to inject separators into the composite key
        from urllib.parse import quote

        return quote(s, safe="")

    @classmethod
    def _k_event(cls, key: str, value: str, height: int, index: int) -> bytes:
        return f"ev/{cls._esc(key)}/{cls._esc(value)}/{height:020d}/{index:010d}".encode()

    def index(self, tx_result: dict, events: Optional[Dict[str, List[str]]] = None) -> None:
        """tx_result = {"height", "index", "tx", "result": {...}}."""
        h = tx_hash(tx_result["tx"])
        payload = codec.dumps(tx_result)
        sets = [(self._k_hash(h), payload)]
        if self.index_all_events and events:
            for key, values in events.items():
                if key == tme.TX_HASH_KEY:
                    continue
                for v in values:
                    sets.append(
                        (
                            self._k_event(key, v, tx_result["height"], tx_result["index"]),
                            h,
                        )
                    )
        # reserved height key always indexed (kv/kv.go indexes tx.height)
        sets.append(
            (
                self._k_event(tme.TX_HEIGHT_KEY, str(tx_result["height"]), tx_result["height"], tx_result["index"]),
                h,
            )
        )
        self.db.write_batch(sets)

    def get(self, h: bytes) -> Optional[dict]:
        raw = self.db.get(self._k_hash(h))
        return codec.loads(raw) if raw else None

    def search(self, query: Query | str, limit: int = 100) -> List[dict]:
        """Subset of kv.go Search: equality + range conditions over indexed
        event keys, intersected."""
        if isinstance(query, str):
            query = Query.parse(query)
        from urllib.parse import unquote

        result_sets: List[set] = []
        for cond in query.conditions:
            hashes = set()
            if cond.op == "=":
                prefix = f"ev/{self._esc(cond.tag)}/{self._esc(str(cond.operand))}/".encode()
                for _, h in self.db.iterate_prefix(prefix):
                    hashes.add(h)
            else:
                # range/exists scans walk every value under the tag
                prefix = f"ev/{self._esc(cond.tag)}/".encode()
                for k, h in self.db.iterate_prefix(prefix):
                    value = unquote(k.decode().split("/")[2])
                    if cond.matches({cond.tag: [value]}):
                        hashes.add(h)
            result_sets.append(hashes)
        if not result_sets:
            return []
        matched = set.intersection(*result_sets)
        out = []
        for h in sorted(matched):
            r = self.get(h)
            if r is not None:
                out.append(r)
            if len(out) >= limit:
                break
        return out


class NullTxIndexer:
    """state/txindex/null — indexing disabled."""

    def index(self, tx_result: dict, events=None) -> None:
        pass

    def get(self, h: bytes) -> Optional[dict]:
        return None

    def search(self, query, limit: int = 100) -> List[dict]:
        return []


class IndexerService(Service):
    """Subscribes to the event bus and feeds the indexer
    (state/txindex/indexer_service.go)."""

    SUBSCRIBER = "tx-indexer"

    def __init__(self, indexer, event_bus: tme.EventBus):
        super().__init__("indexer-service")
        self.indexer = indexer
        self.event_bus = event_bus
        self._task = None

    async def on_start(self) -> None:
        import asyncio

        sub = await self.event_bus.subscribe(
            self.SUBSCRIBER, tme.query_for_event(tme.EVENT_TX), buffer=10000
        )
        self._sub = sub

        async def run():
            async for msg in sub:
                data = msg.data.data  # Event.data
                self.indexer.index(
                    {
                        "height": data["height"],
                        "index": data["index"],
                        "tx": data["tx"],
                        "result": data["result"],
                    },
                    msg.events,
                )

        self._task = asyncio.create_task(run())

    async def on_stop(self) -> None:
        await self.event_bus.unsubscribe_all(self.SUBSCRIBER)
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
