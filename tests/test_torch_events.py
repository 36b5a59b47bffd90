"""The port's events and tx index (tendermint_tpu_torch: libs/events.py,
types/events.py, state/txindex.py) against the JAX package's.

The same query strings parse to the same conditions (or the same errors)
and match the same tag maps; the same publish/subscribe sequences deliver
the same messages and cancel the same subscriptions (a slow subscriber
"out of capacity"); the same tx results indexed give the same get and
search answers.  Every service started here is stopped.
"""

import numpy as np
import pytest

import tendermint_tpu.libs.events as jlibevents
import tendermint_tpu.libs.kvstore as jkvstore
import tendermint_tpu.state.txindex as jtxindex
import tendermint_tpu.types.events as jevents
from tendermint_tpu_torch.libs import events as plibevents
from tendermint_tpu_torch.libs import kvstore as pkvstore
from tendermint_tpu_torch.state import txindex as ptxindex
from tendermint_tpu_torch.types import events as pevents
from tendermint_tpu_torch.types.tx import tx_hash

from test_torch_chain_types import outcome

PKGS = {
    "port": (plibevents, pevents, ptxindex, pkvstore),
    "jax": (jlibevents, jevents, jtxindex, jkvstore),
}

QUERIES = [
    "tm.event='NewBlock'",
    "tm.event = 'Tx' AND tx.height > 5",
    "tx.height>=3 AND tx.height<=7",
    "tx.height<4.5",
    "app.key CONTAINS 'ab'",
    "app.creator EXISTS",
    "account.balance = -12.5 AND tm.event='Tx'",
    "  tx.hash = 'ABCD'  ",
    "name='a/b c' and x = 3",
    "tx.height",
    "tx.height >",
    "= 5",
    "tx.height = foo",
    "tx.height = 'unterminated",
    "tx.height = 5 AND",
    "",
]

TAGS = [
    {"tm.event": ["NewBlock"]},
    {"tm.event": ["Tx"], "tx.height": ["6"], "app.key": ["zabz"]},
    {"tm.event": ["Tx"], "tx.height": ["3"], "app.creator": ["x"], "app.key": ["b"]},
    {"tm.event": ["Tx"], "tx.height": ["not-a-number", "7"], "account.balance": ["-12.5"]},
    {"tx.hash": ["ABCD"], "name": ["a/b c"], "x": ["3"]},
    {"tx.height": ["4.5"]},
    {},
]


def _conds(q):
    return [(c.tag, c.op, c.operand) for c in q.conditions]


@pytest.mark.parametrize("query", QUERIES)
def test_query_parse_and_match_as_jax(query):
    def parse(pkg):
        lib = PKGS[pkg][0]
        r = outcome(lambda: lib.Query.parse(query))
        if r[0] != "ok":
            return r
        q = r[1]
        return ("ok", _conds(q), str(q), [q.matches(t) for t in TAGS])

    assert parse("port") == parse("jax")


def test_query_equality_and_built_source_match_jax():
    for lib in (plibevents, jlibevents):
        a, b = lib.Query.parse("x = 1"), lib.Query.parse("x = 1")
        assert a == b and hash(a) == hash(b) and a != lib.Query.parse("x = 2")
    built = [str(lib.Query([lib.Condition("a", "=", 1), lib.Condition("b", "EXISTS")]))
             for lib in (plibevents, jlibevents)]
    assert built[0] == built[1]


async def _pubsub_trace(pkg):
    """A publish/subscribe sequence: deliveries, duplicate and
    unknown subscriptions, a slow subscriber cancelled out of capacity,
    unsubscribe and unsubscribe_all, and stop."""
    lib = PKGS[pkg][0]
    server = lib.PubSubServer(buffer=4)
    await server.start()
    trace = []
    try:
        subs = {
            "fast": await server.subscribe("fast", "tm.event='Tx'", buffer=64),
            "slow": await server.subscribe("slow", "tm.event='Tx'", buffer=3),
            "blocks": await server.subscribe("fast", lib.Query.parse("tm.event='NewBlock'")),
        }
        trace.append(outcome(lambda: None))
        try:
            await server.subscribe("fast", "tm.event='Tx'")
        except ValueError as e:
            trace.append(("dup", str(e)))
        trace.append(("clients", server.num_clients()))
        for i, kind in enumerate(["Tx", "Tx", "NewBlock", "Tx", "Tx", "Tx", "NewBlock", "Tx"]):
            await server.publish({"i": i}, {"tm.event": [kind], "tx.height": [str(i)]})
            trace.append(("pub", i, kind, {k: (s.cancelled, s.cancel_reason, s.queue.qsize())
                                           for k, s in subs.items()}))
            if i % 3 == 2:
                got = await subs["fast"].next()
                trace.append(("fast got", got.data, got.events))
        # the slow subscriber: what was queued, then cancelled
        slow = []
        try:
            while True:
                slow.append((await subs["slow"].next()).data)
        except lib.SubscriptionCancelled as e:
            slow.append(("cancelled", str(e)))
        trace.append(("slow", slow))
        # a query is keyed by its source text: another spelling is a no-op
        await server.unsubscribe("fast", "tm.event = 'Tx'")
        trace.append(("other spelling", subs["fast"].cancelled))
        await server.unsubscribe("fast", "tm.event='Tx'")
        trace.append(("after unsubscribe", subs["fast"].cancelled, subs["fast"].cancel_reason,
                      server.num_clients()))
        drained = [m.data async for m in subs["fast"]]
        trace.append(("fast drained", drained))
        await server.unsubscribe_all("fast")
        trace.append(("blocks", subs["blocks"].cancelled, subs["blocks"].cancel_reason,
                      server.num_clients()))
        late = await server.subscribe("late", "x EXISTS")
    finally:
        await server.stop()
    trace.append(("stopped", late.cancelled, late.cancel_reason))
    return trace


async def test_pubsub_matches_jax_and_cancels_a_slow_subscriber():
    ours, theirs = await _pubsub_trace("port"), await _pubsub_trace("jax")
    assert ours == theirs
    slow = dict((t[0], t[1]) for t in ours if t[0] == "slow")["slow"]
    assert slow[-1] == ("cancelled", "out of capacity") and len(slow) == 4
    assert ours[-1] == ("stopped", True, "server stopped")


async def _bus_trace(pkg):
    lib, ev, _, _ = PKGS[pkg]
    bus = ev.EventBus()
    await bus.start()
    out = []
    try:
        sub_all = await bus.subscribe("all", "tm.event EXISTS", buffer=100)
        sub_tx = await bus.subscribe("tx", ev.query_for_event(ev.EVENT_TX))
        sub_h = await bus.subscribe("h", "tx.height = 7 AND app.key = 'k1'")
        out.append(("clients", bus.num_clients(), str(ev.query_for_event(ev.EVENT_NEW_BLOCK))))
        await bus.publish_new_block({"height": 7}, "bb", "eb", {"extra.key": ["v"]})
        await bus.publish_new_block_header({"height": 7})
        await bus.publish_new_round(7, 0, b"prop")
        await bus.publish_vote("vote")
        for name in ("new_round_step", "complete_proposal", "polka", "lock", "unlock", "relock",
                     "timeout_propose", "timeout_wait", "valid_block"):
            await getattr(bus, "publish_" + name)({"step": name})
        await bus.publish_validator_set_updates(["u"])
        for i, tx in enumerate((b"k0=a", b"k1=b")):
            await bus.publish_tx(7, i, tx, {"code": 0}, {"app.key": [f"k{i}"]})
        for sub in (sub_all, sub_tx, sub_h):
            got = []
            while not sub.queue.empty():
                m = await sub.next()
                got.append((m.data.type, m.data.data, m.events))
            out.append(got)
        await bus.unsubscribe("tx", ev.query_for_event(ev.EVENT_TX))
        await bus.unsubscribe_all("all")
        out.append(("clients", bus.num_clients()))
    finally:
        await bus.stop()
    return out


async def test_event_bus_matches_jax():
    ours, theirs = await _bus_trace("port"), await _bus_trace("jax")
    assert ours == theirs
    kinds = [k for k, _, _ in ours[1]]
    assert kinds[:4] == ["NewBlock", "NewBlockHeader", "NewRound", "Vote"] and len(kinds) == 16
    assert [e["tx.hash"] for _, _, e in ours[3]] == [[tx_hash(b"k1=b").hex().upper()]]
    assert (pevents.TX_HASH_KEY, pevents.TX_HEIGHT_KEY, pevents.EVENT_TYPE_KEY) == \
        ("tx.hash", "tx.height", "tm.event")


def _index(pkg, index_all_events=True):
    """Seeded tx results indexed: heights 1-6, tags with separators and
    escapes in keys and values."""
    _, _, txindex, kvstore = PKGS[pkg]
    rng = np.random.default_rng(9)
    idx = txindex.TxIndexer(kvstore.MemDB(), index_all_events=index_all_events)
    txs = []
    for h in range(1, 7):
        for i in range(4):
            tx = b"tx-%d-%d-" % (h, i) + rng.bytes(6)
            txs.append(tx)
            events = {"app.key": [f"k{i}", "a/b" if i == 1 else "plain"],
                      "app.amount": [str(int(rng.integers(0, 100)))],
                      "tx.hash": ["ignored"], "odd key/%": ["x y"]}
            idx.index({"height": h, "index": i, "tx": tx,
                       "result": {"code": i % 2, "data": b"", "log": ""}}, events)
    return idx, txs


SEARCHES = [
    "tx.height=3", "tx.height>4", "tx.height>=2 AND tx.height<3", "app.key='k1'",
    "app.key='a/b'", "app.key='k2' AND tx.height=5", "app.amount>50", "app.amount<=10",
    "app.key CONTAINS 'lai'", "app.key EXISTS", "'odd key/%' = 'x y'", "tx.hash='ignored'",
    "nothing='here'",
]


@pytest.mark.parametrize("index_all_events", [True, False])
def test_tx_indexer_get_and_search_match_jax(index_all_events):
    (ours, txs), (theirs, jtxs) = _index("port", index_all_events), _index("jax", index_all_events)
    assert txs == jtxs
    assert ours.db._data == theirs.db._data  # the same keys and values stored
    for tx in txs[:5] + [b"absent"]:
        assert ours.get(tx_hash(tx)) == theirs.get(tx_hash(tx))
    for q in SEARCHES:
        if q.startswith("'"):
            continue
        for limit in (100, 3):
            assert outcome(lambda: ours.search(q, limit)) == outcome(lambda: theirs.search(q, limit))
    h3 = ours.search("tx.height=3")
    assert sorted(r["index"] for r in h3) == [0, 1, 2, 3]
    assert len(ours.search("app.key='k1'")) == (6 if index_all_events else 0)
    null = ptxindex.NullTxIndexer()
    null.index({"tx": b"x"})
    assert null.get(b"x") is None and null.search("tx.height=1") == []


async def _indexer_service(pkg):
    lib, ev, txindex, kvstore = PKGS[pkg]
    import asyncio

    bus = ev.EventBus()
    idx = txindex.TxIndexer(kvstore.MemDB())
    svc = txindex.IndexerService(idx, bus)
    await bus.start()
    await svc.start()
    try:
        for h in (1, 2):
            for i, tx in enumerate((b"a%d" % h, b"b%d" % h)):
                await bus.publish_tx(h, i, tx, {"code": 0, "data": b"", "log": ""},
                                     {"app.key": [tx.decode()]})
        for _ in range(10):
            await asyncio.sleep(0)
        return [idx.search("tx.height=2"), idx.search("app.key='a1'"),
                idx.get(tx_hash(b"b1")), bus.num_clients()]
    finally:
        await svc.stop()
        await bus.stop()


async def test_indexer_service_matches_jax():
    ours, theirs = await _indexer_service("port"), await _indexer_service("jax")
    assert ours == theirs
    assert [r["tx"] for r in ours[0]] == [b"a2", b"b2"] and ours[2]["height"] == 1
