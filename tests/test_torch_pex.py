"""The port's peer exchange (tendermint_tpu_torch/p2p: trust.py,
pex/addrbook.py, pex/pex_reactor.py, and the node's PEX wiring) against
the JAX package's, tolerance 0.

- TrustMetric and TrustMetricStore under one injected clock: equal values.
- AddrBook: each package's book gets the same salt, the same draws (the
  JAX book reads the module-global `random`, seeded here; the port's book
  a random.Random with the same seed), the same wall clock and the same
  sequence of adds, goods, attempts, failures and bads over 300 addresses
  in strict and non-strict books.  Buckets, picks, selections, eviction
  and the saved file's bytes must be equal, and each package loads the
  other's file into the same buckets.
- PEXReactor: the request and reply frames are byte-equal, each receiver
  rule stops the peer with the JAX reason, and the ensure-peers step dials
  what the JAX step dials for the same book and seed.  One named
  deviation (ROADMAP 3.9): the port's sender spaces its next request from
  the reply, so a receiver that read the previous request late does not
  stop it for a flood, as the JAX pair does.
- Live nets on 127.0.0.1: two JAX and two port nodes that know only the
  seed mesh by PEX and commit the same blocks (tests/test_pex.py
  test_net_bootstraps_from_single_seed on a mixed net), and a port node in
  seed mode hangs up on a crawled peer after SEED_DISCONNECT_AFTER.
"""

import asyncio
import json
import random
import types

import pytest
import torch

import tendermint_tpu.p2p.pex.addrbook as jaddrbook
import tendermint_tpu.p2p.pex.pex_reactor as jpexmod
import tendermint_tpu.p2p.trust as jtrust
import tendermint_tpu_torch.p2p.pex.addrbook as paddrbook
import tendermint_tpu_torch.p2p.pex.pex_reactor as ppexmod
import tendermint_tpu_torch.p2p.trust as ptrust
from tendermint_tpu.encoding import codec as jcodec
from tendermint_tpu_torch.crypto import batch as batch_hook
from tendermint_tpu_torch.encoding import codec as pcodec

import test_torch_net as tnet

torch.set_num_threads(1)

SALT = "0123456789abcdef"
T_WALL = 1_700_000_000.0


def mk_addr(i: int, port: int = 26656) -> str:
    return f"{'%040x' % i}@10.{i % 7}.{i % 250}.{i // 250}:{port}"


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# -- the trust metric ----------------------------------------------------------


def test_trust_metric_values_equal_jax_under_one_clock():
    rng = random.Random(11)
    events = [(rng.uniform(0.0, 4.0), rng.random() < 0.6, rng.choice([1.0, 2.0, 0.5]))
              for _ in range(300)]
    out = {}
    for name, mod in (("jax", jtrust), ("port", ptrust)):
        clock = Clock(100.0)
        metric = mod.TrustMetric(interval_s=3.0, now_fn=clock)
        store = mod.TrustMetricStore(interval_s=3.0, now_fn=clock)
        seeded = mod.TrustMetric(interval_s=3.0, now_fn=clock, initial=0.25)
        store.seed("b" * 40, 0.3)
        vals = []
        for i, (dt, good, w) in enumerate(events):
            clock.t += dt
            (metric.good if good else metric.bad)(w)
            store.event(("a" * 40, "b" * 40)[i % 2], good, w)
            if i % 3 == 0:
                seeded.bad()
            vals.append((metric.value(), store.value("a" * 40), store.value("b" * 40),
                         seeded.value(), store.value("c" * 40)))
        clock.t += 1000.0  # a long idle stretch decays back toward trusted
        vals.append((metric.value(), store.value("a" * 40), seeded.value()))
        store.forget("a" * 40)
        vals.append(store.value("a" * 40))
        out[name] = vals
    assert out["port"] == out["jax"]


# -- the address book ----------------------------------------------------------


def make_books(strict, path_of=lambda name: ""):
    """(name, book, set_clock) for each package: the same salt, draws and
    wall clock.  The JAX book's draws come from the global `random`."""
    wall = Clock(T_WALL)
    jbook = jaddrbook.AddrBook(path_of("jax"), strict=strict, our_ids={"%040x" % 7})
    jbook._key = SALT
    pbook = paddrbook.AddrBook(path_of("port"), strict=strict, our_ids={"%040x" % 7},
                               key=SALT, rng=random.Random(5), now_fn=wall)
    return jbook, pbook, wall


def book_view(book):
    return {
        "addrs": {pid: ka.to_dict() for pid, ka in book.addrs.items()},
        "new": [sorted(b) for b in book.new_buckets],
        "old": [sorted(b) for b in book.old_buckets],
        "order_new": [list(b) for b in book.new_buckets],
    }


def drive(book, wall, rng_ops, selection_draws):
    """One sequence of book operations; returns what it observed."""
    seen = []
    srcs = ["%040x" % (10_000 + k) for k in range(5)]
    for i in range(1, 301):
        seen.append(book.add_address(mk_addr(i), src=srcs[i % 5] + f"@10.{i % 3}.0.1:1"))
    # one source group flooding one bucket: eviction bounds it
    for i in range(400, 400 + paddrbook.NEW_BUCKET_SIZE + 20):
        seen.append(book.add_address(f"{'%040x' % i}@10.9.0.1:{10000 + i}", src="onesrc"))
    seen.append(book.add_address(f"{'%040x' % 7}@1.2.3.4:26656"))  # ourselves
    for op, i in rng_ops:
        wall.t += 1.5
        pid = "%040x" % i
        if op == "good":
            book.mark_good(pid)
        elif op == "attempt":
            book.mark_attempt(mk_addr(i))
        elif op == "failed":
            book.mark_failed(pid)
        elif op == "bad":
            book.mark_bad(mk_addr(i))
        elif op == "readd":
            seen.append(book.add_address(mk_addr(i), src="latecomer"))
    wall.t += 120.0  # past every attempt's grace period
    for _ in range(selection_draws):
        seen.append(book.pick_address())
        seen.append(book.pick_address(bias_towards_new=90))
        seen.append(book.get_selection())
    seen.append((book.size(), book.need_more_addrs(), book.has_address(mk_addr(3))))
    seen.append(sorted((pid, book.trust_value(pid)) for pid in book.trust.metrics))
    return seen


@pytest.mark.parametrize("strict", [False, True])
def test_addrbook_equals_jax(strict, tmp_path, monkeypatch):
    ops_rng = random.Random(3)
    ops = [(ops_rng.choice(["good", "good", "attempt", "failed", "bad", "readd"]),
            ops_rng.randrange(1, 300)) for _ in range(260)]
    paths = {"jax": str(tmp_path / "jax" / "addrbook.json"),
             "port": str(tmp_path / "port" / "addrbook.json")}
    jbook, pbook, wall = make_books(strict, paths.get)
    jwall = Clock(T_WALL)
    monkeypatch.setattr(jaddrbook, "time", types.SimpleNamespace(time=jwall))
    random.seed(5)
    jseen = drive(jbook, jwall, ops, 12)
    pseen = drive(pbook, wall, ops, 12)
    assert pseen == jseen
    assert book_view(pbook) == book_view(jbook)
    assert all(len(b) <= paddrbook.NEW_BUCKET_SIZE for b in pbook.new_buckets)
    assert any(ka.is_old() for ka in pbook.addrs.values())
    # the saved files are byte-equal, and each package loads the other's
    jbook.save()
    pbook.save()
    raw = {k: open(p, "rb").read() for k, p in paths.items()}
    assert raw["port"] == raw["jax"]
    assert json.loads(raw["port"])["key"] == SALT
    jloaded = jaddrbook.AddrBook(paths["port"], strict=strict, our_ids={"%040x" % 7})
    ploaded = paddrbook.AddrBook(paths["jax"], strict=strict, our_ids={"%040x" % 7},
                                 rng=random.Random(9))
    assert book_view(ploaded) == book_view(jloaded)
    assert ploaded._key == SALT
    assert sorted(ploaded.trust.metrics) == sorted(jloaded.trust.metrics)


def test_addrbook_private_ids_and_group_key_equal_jax():
    for host, strict in (("127.0.0.1:5", True), ("127.0.0.1:5", False), ("10.2.3.4:1", True),
                         ("example.org:80", True), ("0.1.2.3:9", True)):
        assert paddrbook._group_key(host, strict) == jaddrbook._group_key(host, strict)
    out = {}
    for name, mod in (("jax", jaddrbook), ("port", paddrbook)):
        book = mod.AddrBook(strict=False, private_ids={"%040x" % 2})
        book._key = SALT
        for i in range(1, 6):
            book.add_address(mk_addr(i), src="s")
        if name == "jax":
            random.seed(1)
        else:
            book.rng = random.Random(1)
        out[name] = book.get_selection()
    assert out["port"] == out["jax"]
    assert mk_addr(2) not in out["port"]


# -- the reactor -----------------------------------------------------------------


class FakePeer:
    def __init__(self, pid, outbound=False, listen_addr="", socket_addr=""):
        self.id = pid
        self.outbound = outbound
        self.persistent = False
        self.socket_addr = socket_addr
        self.node_info = types.SimpleNamespace(listen_addr=listen_addr)
        self.sent = []

    async def send(self, chan, data):
        self.sent.append((chan, bytes(data)))
        return True


class FakeSwitch:
    def __init__(self, peers=()):
        self.node_id = "e" * 40
        self.peers = {p.id: p for p in peers}
        self._connecting = set()
        self.max_outbound = 4
        self.stopped = []
        self.graceful = []
        self.dialed = []

    def peer_list(self):
        return list(self.peers.values())

    async def stop_peer_for_error(self, peer, reason):
        self.stopped.append((peer.id, reason))

    async def stop_peer_gracefully(self, peer):
        self.graceful.append(peer.id)

    def spawn(self, coro, name=""):
        coro.close()
        self.dialed.append(name)

    async def dial_peer(self, addr):
        self.dialed.append(addr)


def reactor_pair(seeds=(), seed_mode=False):
    """Each package's reactor on a fake switch and a book with SALT; one
    clock each at 1000 s.  The JAX book and reactor draw from the global
    `random`, so the port's two share one random.Random with its seed."""
    out = {}
    for name, mod, bmod in (("jax", jpexmod, jaddrbook), ("port", ppexmod, paddrbook)):
        book = bmod.AddrBook(strict=False)
        book._key = SALT
        clock = Clock(1000.0)
        if name == "jax":
            r = mod.PEXReactor(book, seeds=list(seeds), seed_mode=seed_mode)
        else:
            book.rng = random.Random(4)
            r = mod.PEXReactor(book, seeds=list(seeds), seed_mode=seed_mode,
                               rng=book.rng, now_fn=clock)
        r.switch = FakeSwitch()
        out[name] = (r, clock)
    return out


async def run_both(scenario, monkeypatch, **kw):
    pair = reactor_pair(**kw)
    jclock = pair["jax"][1]
    monkeypatch.setattr(jpexmod, "time", types.SimpleNamespace(monotonic=jclock))
    random.seed(4)
    jout = await scenario(*pair["jax"])
    pout = await scenario(*pair["port"])
    return pout, jout


def test_pex_frames_are_byte_equal():
    addrs = [mk_addr(i) for i in range(1, 40)]
    for t, payload in (("pex_request", {}), ("pex_addrs", {"addrs": addrs}),
                       ("pex_addrs", {"addrs": []})):
        assert ppexmod._enc(t, payload) == jpexmod._enc(t, payload)
    assert pcodec.loads(jpexmod._enc("pex_addrs", {"addrs": addrs})) == {
        "t": "pex_addrs", "addrs": addrs}
    assert ppexmod.PEX_CHANNEL == jpexmod.PEX_CHANNEL == 0x00
    for a, b in zip(ppexmod.PEXReactor(paddrbook.AddrBook()).get_channels(),
                    jpexmod.PEXReactor(jaddrbook.AddrBook()).get_channels()):
        assert vars(a) == vars(b)


RULES = {
    "malformed": [b"\xc1\xff not a frame"],
    "flood": [("pex_request", {}), ("pex_request", {})],
    "unsolicited": [("pex_addrs", {"addrs": [mk_addr(1)]})],
    "oversized": ["request", ("pex_addrs", {"addrs": [mk_addr(i) for i in range(1, 252)]})],
    "unknown": [("pex_gossip", {"x": 1})],
    "served": ["request", ("pex_addrs", {"addrs": [mk_addr(i) for i in range(1, 30)]
                                         + ["no-at-sign", 5]}),
               ("pex_request", {})],
}


@pytest.mark.parametrize("rule", sorted(RULES))
async def test_receiver_rules_equal_jax(rule, monkeypatch):
    """Each frame sequence from one peer: the stop reasons, the frames sent
    back and the book afterwards equal the JAX reactor's."""

    async def scenario(r, clock):
        peer = FakePeer("a" * 40, outbound=True, socket_addr="a" * 40 + "@127.0.0.1:5")
        r.switch.peers[peer.id] = peer
        for i in range(40, 50):
            r.book.add_address(mk_addr(i), src="s")
        for step in RULES[rule]:
            clock.t += 1.0
            if step == "request":
                await r._request_addrs(peer)
            elif isinstance(step, bytes):
                await r.receive(0x00, peer, step)
            else:
                codec = pcodec if isinstance(r, ppexmod.PEXReactor) else jcodec
                await r.receive(0x00, peer, codec.dumps({"t": step[0], **step[1]}))
        return r.switch.stopped, peer.sent, sorted(r.book.addrs), sorted(
            ka.src for ka in r.book.addrs.values())

    pout, jout = await run_both(scenario, monkeypatch)
    assert pout == jout
    stopped = pout[0]
    want = {"malformed": "malformed pex message", "flood": "pex request flood",
            "unsolicited": "unsolicited pex response", "oversized": "oversized pex response",
            "unknown": "unknown pex message 'pex_gossip'"}.get(rule)
    assert stopped == ([("a" * 40, want)] if want else [])
    if rule == "served":
        assert len(pout[2]) == 10 + 29 and "a" * 40 in pout[3]


async def test_peer_lifecycle_and_ensure_peers_equal_jax(monkeypatch):
    """add_peer for an outbound and an inbound peer (the self-reported
    address), then the ensure-peers step with a book and a seed: the same
    book, requests and dials as the JAX reactor's; a seed-mode reactor
    hangs up on a crawled peer after SEED_DISCONNECT_AFTER."""
    seed = "f" * 40 + "@127.0.0.1:9"

    async def scenario(r, clock):
        out = r.book.add_address(mk_addr(5), src="s")
        outbound = FakePeer("b" * 40, outbound=True, socket_addr="b" * 40 + "@10.0.0.2:26656")
        inbound = FakePeer("c" * 40, listen_addr="tcp://0.0.0.0:26656",
                           socket_addr="c" * 40 + "@10.0.0.3:40000")
        unusable = FakePeer("d" * 40, listen_addr="tcp://0.0.0.0:0")
        for p in (outbound, inbound, unusable):
            r.switch.peers[p.id] = p
            await r.add_peer(p)
        for i in range(60, 70):
            r.book.add_address(mk_addr(i), src="s")
        clock.t += 100.0
        await r._ensure_peers()
        await r.remove_peer(inbound)
        return (out, sorted((pid, ka.addr, ka.src, ka.bucket_type, ka.attempts)
                            for pid, ka in r.book.addrs.items()),
                outbound.sent, inbound.sent, r.switch.dialed, sorted(r._requests_sent))

    pout, jout = await run_both(scenario, monkeypatch, seeds=[seed])
    assert pout == jout
    assert ("c" * 40, "c" * 40 + "@10.0.0.3:26656") in [x[:2] for x in pout[1]]

    async def crawl(r, clock):
        peer = FakePeer("a" * 40)
        r.switch.peers[peer.id] = peer
        await r.add_peer(peer)
        clock.t += jpexmod.SEED_DISCONNECT_AFTER / 2
        await r._ensure_peers()
        early = list(r.switch.graceful)
        clock.t += jpexmod.SEED_DISCONNECT_AFTER
        await r._ensure_peers()
        return early, r.switch.graceful

    pout, jout = await run_both(crawl, monkeypatch, seed_mode=True)
    assert pout == jout == ([], ["a" * 40])


# -- live nets -------------------------------------------------------------------


def pex_node(kind, tmp_path, name, seed, jg, pg):
    node = tnet._node(kind, tmp_path, name, seed, jg, pg)
    node.config.p2p.pex = True
    node.config.p2p.addr_book_strict = False
    return node


async def test_mixed_net_bootstraps_from_single_seed(tmp_path, monkeypatch):
    """tests/test_pex.py's single-seed bootstrap on a mixed net: the seed is
    a JAX node, and a port, a JAX and a port node know only the seed.  PEX
    must mesh all four and they must commit the same blocks."""
    for mod in (jpexmod, ppexmod):
        monkeypatch.setattr(mod, "FAST_ENSURE_INTERVAL", 0.2)
    kinds = ("jax", "port", "jax", "port")
    seeds = tnet._seeds(4, "pexmix")
    jg, pg = tnet._genesis(seeds)
    nodes = [pex_node(k, tmp_path, f"pex{i}", s, jg, pg)
             for i, (k, s) in enumerate(zip(kinds, seeds))]
    try:
        await nodes[0].start()
        seed_addr = f"{nodes[0].node_key.id}@{nodes[0].switch.transport.listen_addr}"
        for n in nodes[1:]:
            n.config.p2p.seeds = seed_addr
            await n.start()

        async def meshed():
            while not all(n.switch.num_peers() >= 3 for n in nodes):
                await asyncio.sleep(0.1)

        await asyncio.wait_for(meshed(), 60.0)
        assert all(n.addr_book.size() >= 3 for n in nodes)
        for n in nodes[1::2]:
            assert n.pex_reactor.seeds == [seed_addr]
        # the last joiner (a port node) learned the earlier joiners from the
        # seed (the earlier ones may learn later joiners by their dials)
        last = nodes[3].addr_book
        for n in nodes[1:3]:
            assert last.addrs[n.node_key.id].src == nodes[0].node_key.id
        await tnet._wait_height(nodes, 2, 60.0)
        assert len({tnet._block_hash(n, 1) for n in nodes}) == 1
        assert len({tnet._block_hash(n, 2) for n in nodes}) == 1
    finally:
        await tnet._stop(nodes)


async def test_seed_mode_port_node_hangs_up_after_the_crawl(tmp_path, monkeypatch):
    """A port node in seed mode serves a JAX node its book and then hangs up
    on it once SEED_DISCONNECT_AFTER (patched small) has passed."""
    for mod in (jpexmod, ppexmod):
        monkeypatch.setattr(mod, "FAST_ENSURE_INTERVAL", 0.2)
    monkeypatch.setattr(ppexmod, "SEED_DISCONNECT_AFTER", 0.5)
    seeds = tnet._seeds(2, "seedmode")
    jg, pg = tnet._genesis(seeds)
    seed = pex_node("port", tmp_path, "seed", seeds[0], jg, pg)
    seed.config.p2p.seed_mode = True
    # a seed knows other seeds (here one that is down): with a seed to fall
    # back on, the ensure-peers loop runs at FAST_ENSURE_INTERVAL from the start
    seed.config.p2p.seeds = f"{'ab' * 20}@127.0.0.1:1"
    joiner = pex_node("jax", tmp_path, "joiner", seeds[1], jg, pg)
    hung_up = []
    try:
        await seed.start()
        orig = seed.switch.stop_peer_gracefully

        async def graceful(peer):
            hung_up.append(peer.id)
            await orig(peer)

        seed.switch.stop_peer_gracefully = graceful
        joiner.config.p2p.seeds = f"{seed.node_key.id}@{seed.switch.transport.listen_addr}"
        await joiner.start()

        async def crawled():
            while joiner.node_key.id not in hung_up:
                await asyncio.sleep(0.05)

        await asyncio.wait_for(crawled(), 30.0)
        assert seed.addr_book.has_address(joiner.node_key.id)
    finally:
        await tnet._stop([joiner, seed])
        batch_hook.set_verifier(None)


async def test_request_spacing_survives_a_late_reader_where_jax_floods(monkeypatch):
    """ROADMAP 3.9: the receiver stamps a pex_request when its loop reads
    it.  A first request read 6 s late and a second sent 15 s after the
    first reach it 9 s apart, under REQUEST_INTERVAL: the JAX sender sends
    it and is stopped for a flood; the port's sender spaces its next
    request from the reply, so the receiver serves it."""
    stopped, served = {}, {}
    for name, mod, bmod in (("jax", jpexmod, jaddrbook), ("port", ppexmod, paddrbook)):
        clock = Clock(1000.0)
        if name == "jax":
            monkeypatch.setattr(jpexmod, "time", types.SimpleNamespace(monotonic=clock))
            sender, receiver = (mod.PEXReactor(bmod.AddrBook(strict=False)) for _ in range(2))
        else:
            sender, receiver = (mod.PEXReactor(bmod.AddrBook(strict=False), now_fn=clock)
                                for _ in range(2))
        for i in range(40, 50):
            receiver.book.add_address(mk_addr(i), src="s")
        to_r, to_s = FakePeer("b" * 40, outbound=True), FakePeer("a" * 40)
        sender.switch, receiver.switch = FakeSwitch([to_r]), FakeSwitch([to_s])

        served[name] = 0

        async def deliver(src_peer, dst, dst_peer):
            while src_peer.sent:
                _, frame = src_peer.sent.pop(0)
                served[name] += dst is sender
                await dst.receive(0x00, dst_peer, frame)

        await sender._request_addrs(to_r)
        clock.t += 6.0  # the receiver's loop reads the request late
        await deliver(to_r, receiver, to_s)
        await deliver(to_s, sender, to_r)
        for _ in range(2):
            clock.t += 9.0  # 15 s after the first request, then 24 s
            await sender._request_addrs(to_r)
            await deliver(to_r, receiver, to_s)
            await deliver(to_s, sender, to_r)
        stopped[name] = receiver.switch.stopped
    assert stopped["jax"] == [("a" * 40, "pex request flood")] and served["jax"] == 1
    assert stopped["port"] == [] and served["port"] == 2
