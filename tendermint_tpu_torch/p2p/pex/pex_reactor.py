"""PEX reactor: peer discovery over channel 0x00 (the port's copy of
tendermint_tpu/p2p/pex/pex_reactor.py; the same frames, byte for byte).

Reference parity: p2p/pex/pex_reactor.go:135 — request/response address
exchange, the ensure-peers routine topping up outbound connections from
the address book, rate-limited requests (a peer may only be asked once per
interval, unsolicited responses are punished), and seed mode (crawl:
connect, harvest addresses, disconnect).

Redesign notes: the reference runs ensurePeers on a 30 s ticker and
tracks per-peer request times in sync.Maps; here a single asyncio task
owns the loop and plain dicts suffice (single-loop ownership).

The JAX reactor draws its seed fallback and the peer it asks from the
module-global `random` and reads time.monotonic; here they come from the
reactor's own `rng` (a random.Random) and `now_fn`.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Dict, Optional

from ...encoding import codec
from ...libs.log import get_logger
from ..base_reactor import Reactor
from ..conn.connection import ChannelDescriptor
from .addrbook import AddrBook

PEX_CHANNEL = 0x00

ENSURE_PEERS_INTERVAL = 30.0  # pex_reactor.go defaultEnsurePeersPeriod
FAST_ENSURE_INTERVAL = 2.0  # while below target and book non-empty
REQUEST_INTERVAL = 10.0  # receiver-enforced min seconds between requests
SEED_DISCONNECT_AFTER = 10.0  # seedDisconnectWaitPeriod (shortened)
MAX_MSG_SIZE = 64 * 1024


def _enc(t: str, payload: dict) -> bytes:
    return codec.dumps({"t": t, **payload})


class PEXReactor(Reactor):
    """p2p/pex/pex_reactor.go:135."""

    def __init__(
        self,
        book: AddrBook,
        seeds: Optional[list] = None,
        seed_mode: bool = False,
        ensure_interval: float = ENSURE_PEERS_INTERVAL,
        rng: Optional[random.Random] = None,
        now_fn=time.monotonic,
    ):
        super().__init__("PEX")
        self.book = book
        self.seeds = [s for s in (seeds or []) if s]
        self.seed_mode = seed_mode
        self.ensure_interval = ensure_interval
        self.rng = rng if rng is not None else random.Random()
        self._now = now_fn
        self.log = get_logger("pex")
        self._last_request_from: Dict[str, float] = {}  # peer id -> mono time
        self._last_request_to: Dict[str, float] = {}  # stay under the peer's limit
        self._requests_sent: set = set()  # peer ids we asked and await
        self._seed_peers_since: Dict[str, float] = {}

    def get_channels(self):
        return [
            ChannelDescriptor(
                id=PEX_CHANNEL, priority=1, send_queue_capacity=10,
                recv_message_capacity=MAX_MSG_SIZE,
            )
        ]

    async def on_start(self) -> None:
        self.spawn(self._ensure_peers_routine(), "ensure-peers")

    async def on_stop(self) -> None:
        # off the loop: the save is two fsyncs (file + directory — rename
        # durability) and stop runs mid-teardown while peer task
        # cancellation cascades drain; blocking the loop here starves them
        await asyncio.get_event_loop().run_in_executor(None, self.book.save)

    # -- peer lifecycle ----------------------------------------------------

    async def add_peer(self, peer) -> None:
        if peer.outbound:
            # outbound dial succeeded: the address is good
            if peer.socket_addr:
                self.book.add_address(peer.socket_addr, src=self.switch.node_id)
                self.book.mark_good(peer.id)
            if self.book.need_more_addrs():
                await self._request_addrs(peer)
        else:
            # inbound peer advertises its listen addr via NodeInfo
            self_addr = self._self_reported_addr(peer)
            if self_addr:
                self.book.add_address(self_addr, src=peer.id)
        if self.seed_mode:
            self._seed_peers_since[peer.id] = self._now()

    async def remove_peer(self, peer, reason=None) -> None:
        self._requests_sent.discard(peer.id)
        self._last_request_from.pop(peer.id, None)
        self._last_request_to.pop(peer.id, None)
        self._seed_peers_since.pop(peer.id, None)

    def _self_reported_addr(self, peer) -> Optional[str]:
        la = peer.node_info.listen_addr
        if not la or la.endswith(":0"):
            return None
        host_of_conn = peer.socket_addr.rsplit(":", 1)[0].split("@")[-1] if peer.socket_addr else ""
        host, _, port = la.rpartition(":")
        host = host.split("://")[-1] or host_of_conn
        if host in ("0.0.0.0", "::", ""):
            if not host_of_conn:
                return None
            host = host_of_conn
        return f"{peer.id}@{host}:{port}"

    # -- messages ----------------------------------------------------------

    async def _request_addrs(self, peer) -> None:
        now = self._now()
        if peer.id in self._requests_sent:
            return
        if now - self._last_request_to.get(peer.id, -1e9) < REQUEST_INTERVAL * 1.5:
            return  # the peer punishes request floods; stay well under
        self._last_request_to[peer.id] = now
        self._requests_sent.add(peer.id)
        await peer.send(PEX_CHANNEL, _enc("pex_request", {}))

    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            msg = codec.loads(msg_bytes)
            kind = msg.get("t")
        except Exception:
            await self.switch.stop_peer_for_error(peer, "malformed pex message")
            return
        if kind == "pex_request":
            now = self._now()
            last = self._last_request_from.get(peer.id, 0.0)
            if now - last < REQUEST_INTERVAL:
                await self.switch.stop_peer_for_error(peer, "pex request flood")
                return
            self._last_request_from[peer.id] = now
            await peer.send(PEX_CHANNEL, _enc("pex_addrs", {"addrs": self.book.get_selection()}))
        elif kind == "pex_addrs":
            if peer.id not in self._requests_sent:
                # unsolicited address dump: classic book-poisoning vector
                await self.switch.stop_peer_for_error(peer, "unsolicited pex response")
                return
            self._requests_sent.discard(peer.id)
            # the next request waits REQUEST_INTERVAL * 1.5 from this reply,
            # not from the request: the peer stamped the request when its
            # loop read it, maybe seconds late, and a send-time spacing then
            # reaches it under REQUEST_INTERVAL (ROADMAP 3.9)
            self._last_request_to[peer.id] = self._now()
            addrs = msg.get("addrs") or []
            if not isinstance(addrs, list) or len(addrs) > 250:
                await self.switch.stop_peer_for_error(peer, "oversized pex response")
                return
            for addr in addrs:
                if isinstance(addr, str) and "@" in addr:
                    self.book.add_address(addr, src=peer.id)
        else:
            await self.switch.stop_peer_for_error(peer, f"unknown pex message {kind!r}")

    # -- ensure-peers loop (pex_reactor.go:545) ----------------------------

    def _num_outbound_needed(self) -> int:
        out = sum(1 for p in self.switch.peer_list() if p.outbound)
        dialing = len(self.switch._connecting)
        return self.switch.max_outbound - out - dialing

    async def _ensure_peers_routine(self) -> None:
        # small initial delay so the node's own listeners are up
        await asyncio.sleep(0.1)
        while True:
            try:
                await self._ensure_peers()
            except Exception as e:  # discovery must never die
                self.log.error("ensure peers failed", err=repr(e))
            needed = self._num_outbound_needed()
            fast = needed > 0 and (not self.book.is_empty() or self.seeds)
            await asyncio.sleep(FAST_ENSURE_INTERVAL if fast else self.ensure_interval)

    async def _ensure_peers(self) -> None:
        if self.seed_mode:
            await self._seed_disconnect_stale()
        needed = self._num_outbound_needed()
        if needed <= 0:
            return
        tried = set()
        for _ in range(needed * 3):
            addr = self.book.pick_address()
            if addr is None:
                break
            pid = addr.split("@", 1)[0]
            if pid in tried or pid in self.switch.peers or pid in self.switch._connecting:
                continue
            tried.add(pid)
            self.book.mark_attempt(pid)
            self.switch.spawn(self._dial_and_mark(addr), f"pex-dial-{pid[:8]}")
            needed -= 1
            if needed <= 0:
                break
        # below target and book exhausted: fall back to configured seeds
        if needed > 0 and self.seeds:
            addr = self.rng.choice(self.seeds)
            pid = addr.split("@", 1)[0]
            if pid not in self.switch.peers and pid not in tried:
                self.switch.spawn(self._dial_and_mark(addr), "pex-dial-seed")
        # ask a random existing peer for more addresses
        if self.book.need_more_addrs():
            peers = self.switch.peer_list()
            if peers:
                await self._request_addrs(self.rng.choice(peers))

    async def _dial_and_mark(self, addr: str) -> None:
        # the attempt was already marked at pick time in _ensure_peers —
        # marking again here would double-count failures and evict
        # transiently-down peers twice as fast as addrbook.go intends
        await self.switch.dial_peer(addr)
        # success is marked in add_peer

    async def _seed_disconnect_stale(self) -> None:
        """Seed crawl: serve addresses, then hang up (pex_reactor.go
        crawlPeers / attemptDisconnects)."""
        now = self._now()
        for peer in self.switch.peer_list():
            since = self._seed_peers_since.get(peer.id)
            if peer.persistent or since is None:
                continue
            if now - since > SEED_DISCONNECT_AFTER:
                await self.switch.stop_peer_gracefully(peer)
