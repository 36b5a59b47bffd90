"""Switch: the peer-lifecycle hub owning reactors and connections (the
port's copy of tendermint_tpu/p2p/switch.py, with the chaos link layer:
`fuzz_config` or a `link_policies` table wraps every added peer's sends).

Reference parity: p2p/switch.go (Switch:69, AddReactor:158, OnStart:224,
Broadcast:262, StopPeerForError:323, reconnectToPeer:376 with exponential
backoff, persistent/unconditional peer policies).
"""

from __future__ import annotations

import asyncio
import random
from typing import Dict, List, Optional

from ..libs.log import get_logger
from ..libs.service import Service
from .base_reactor import Reactor
from .conn.connection import ChannelDescriptor
from .node_info import NodeInfo
from .peer import Peer
from .transport import Transport, parse_peer_addr

RECONNECT_ATTEMPTS = 20
RECONNECT_BASE_INTERVAL = 3.0


class SwitchError(Exception):
    pass


class Switch(Service):
    def __init__(
        self,
        transport: Transport,
        max_inbound: int = 40,
        max_outbound: int = 10,
        fuzz_config: Optional[dict] = None,
        link_policies=None,  # chaos.link.LinkPolicyTable (runtime fault layer)
        unconditional_peer_ids: Optional[set] = None,
        allow_duplicate_ip: bool = True,  # node passes config (default false)
    ):
        super().__init__("p2p-switch")
        self.transport = transport
        # chaos layer: an explicit LinkPolicyTable wins; a legacy
        # [p2p] test_fuzz config maps to a wildcard-policy table
        self.link_policies = link_policies
        if self.link_policies is None and fuzz_config is not None:
            from .fuzz import table_from_fuzz_config

            self.link_policies = table_from_fuzz_config(fuzz_config)
        # switch.go:69 policies: unconditional peers bypass the caps;
        # dup-IP inbound is rejected unless allowed (transport.go:376)
        self.unconditional_peer_ids = unconditional_peer_ids or set()
        self.allow_duplicate_ip = allow_duplicate_ip
        # filter callbacks: fn(node_info, conn) raises/returns reason str to
        # reject (the reference's ABCI peer filters, node.go:498)
        self.peer_filters: List = []
        self.reactors: Dict[str, Reactor] = {}
        self.reactors_by_ch: Dict[int, Reactor] = {}
        self.channel_descs: List[ChannelDescriptor] = []
        self.peers: Dict[str, Peer] = {}
        self.persistent_addrs: Dict[str, str] = {}  # id -> addr
        self.max_inbound = max_inbound
        self.max_outbound = max_outbound
        self.log = get_logger("p2p")
        self.addr_book = None
        self._reconnecting: set = set()
        self._connecting: set = set()
        # ids whose stop is in flight: a replacement connection must not be
        # admitted until the old peer's reactor teardown completes, or the
        # deferred remove_peer would tear down the REPLACEMENT's state
        # (same id, different object) and wedge gossip to a live peer
        self._stopping: set = set()
        self._admitting_inbound: List = []  # (node_id, ip) in-flight tokens
        from ..libs.metrics import P2PMetrics

        self.metrics = P2PMetrics()  # nop; node swaps in prometheus

    # -- reactor registry (switch.go:158) ----------------------------------
    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        for desc in reactor.get_channels():
            if desc.id in self.reactors_by_ch:
                raise SwitchError(f"channel {desc.id:#x} already registered")
            self.reactors_by_ch[desc.id] = reactor
            self.channel_descs.append(desc)
        self.reactors[name] = reactor
        reactor.set_switch(self)
        self.transport.node_info.channels = bytes(d.id for d in self.channel_descs)
        return reactor

    def reactor(self, name: str) -> Optional[Reactor]:
        return self.reactors.get(name)

    @property
    def node_info(self) -> NodeInfo:
        return self.transport.node_info

    @property
    def node_id(self) -> str:
        return self.transport.node_info.node_id

    # -- lifecycle ---------------------------------------------------------
    async def on_start(self) -> None:
        for reactor in self.reactors.values():
            await reactor.start()
        self.spawn(self._accept_routine(), "accept")

    async def on_stop(self) -> None:
        self.transport.close()
        for peer in list(self.peers.values()):
            await self._stop_and_remove_peer(peer, "switch stopping")
        for reactor in self.reactors.values():
            if reactor.is_running:
                await reactor.stop()

    # -- inbound -----------------------------------------------------------
    async def _accept_routine(self) -> None:
        while True:
            conn, ni = await self.transport.accept()
            unconditional = ni.node_id in self.unconditional_peer_ids
            # cap/dup-IP checks count IN-FLIGHT admissions too: with
            # concurrent admission, checking self.peers alone would let a
            # burst of simultaneous connections bypass both policies
            n_inbound = (
                sum(1 for p in self.peers.values() if not p.outbound)
                + len(self._admitting_inbound)
            )
            if n_inbound >= self.max_inbound and not unconditional:
                self.log.info("rejecting inbound: full", peer=ni.node_id[:12])
                conn.close()
                continue
            ip = getattr(conn, "remote_ip", "")
            if not self.allow_duplicate_ip and not unconditional:
                if ip and (
                    any(p.remote_ip == ip for p in self.peers.values())
                    or any(aip == ip for _, aip in self._admitting_inbound)
                ):
                    self.log.info("rejecting inbound: duplicate IP", ip=ip)
                    conn.close()
                    continue
            # admit concurrently: peer filters may await (ABCI query, up to
            # 5s each) and must not serialize the accept loop
            token = (ni.node_id, ip)
            self._admitting_inbound.append(token)
            self.spawn(
                self._admit_inbound(conn, ni, token), f"admit-{ni.node_id[:8]}"
            )

    async def _admit_inbound(self, conn, ni: NodeInfo, token) -> None:
        try:
            await self._add_peer_conn(conn, ni, outbound=False)
        finally:
            self._admitting_inbound.remove(token)

    # -- outbound ----------------------------------------------------------
    async def dial_peer(self, addr: str, persistent: bool = False) -> Optional[Peer]:
        """Dial 'id@host:port'."""
        pid, hostport = parse_peer_addr(addr)
        if pid and pid in self.peers:
            return self.peers[pid]
        if persistent and pid:
            self.persistent_addrs[pid] = addr
        try:
            conn, ni = await self.transport.dial(hostport, expected_id=pid)
        except Exception as e:
            self.log.info("dial failed", addr=addr, err=str(e))
            if self.addr_book is not None and pid:
                # trust feed: failed dials decay the peer's score, which
                # dial-priority selection consults (p2p/trust parity)
                self.addr_book.mark_failed(pid)
            if persistent and pid:
                self._maybe_reconnect(pid)
            return None
        return await self._add_peer_conn(conn, ni, outbound=True, persistent=persistent, addr=addr)

    async def dial_peers_async(self, addrs: List[str], persistent: bool = True) -> None:
        for addr in addrs:
            if addr:
                self.spawn(self.dial_peer(addr, persistent=persistent), f"dial-{addr[:16]}")

    async def _add_peer_conn(
        self, conn, ni: NodeInfo, outbound: bool, persistent: bool = False, addr: str = ""
    ) -> Optional[Peer]:
        # reserve the id synchronously — simultaneous inbound+outbound to the
        # same peer must not both pass the check across the awaits below.
        # An id mid-STOP is refused too: admitting now would let the old
        # peer's deferred teardown destroy the new peer's reactor state
        # (the remote's persistent redial retries in milliseconds).
        if (
            ni.node_id in self.peers
            or ni.node_id in self._connecting
            or ni.node_id in self._stopping
        ):
            conn.close()
            return self.peers.get(ni.node_id)
        self._connecting.add(ni.node_id)
        try:
            return await self._add_peer_conn_locked(conn, ni, outbound, persistent, addr)
        finally:
            self._connecting.discard(ni.node_id)

    async def _add_peer_conn_locked(
        self, conn, ni: NodeInfo, outbound: bool, persistent: bool, addr: str
    ) -> Optional[Peer]:
        for filt in self.peer_filters:
            try:
                reason = filt(ni, conn)
                if asyncio.iscoroutine(reason):
                    reason = await reason
            except Exception as e:
                # fail CLOSED: a broken/slow filter must reject, not admit
                # (str(e) can be empty — repr never is)
                reason = repr(e)
            if reason:
                self.log.info("peer filtered", peer=ni.node_id[:12], reason=reason)
                conn.close()
                return None
        def _count_send_bytes(chan_id: int, n: int, peer_id: str = ni.node_id) -> None:
            # mirrors the receive-side accounting in _on_peer_receive
            self.metrics.peer_send_bytes_total.labels(
                chain_id=self.node_info.network, peer_id=peer_id, chID=str(chan_id)
            ).inc(n)

        peer = Peer(
            conn,
            ni,
            self.channel_descs,
            on_receive=self._on_peer_receive,
            on_error=self._on_peer_error,
            outbound=outbound,
            persistent=persistent or ni.node_id in self.persistent_addrs,
            socket_addr=addr,
            on_send_bytes=_count_send_bytes,
        )
        if self.link_policies is not None:
            self.link_policies.install(peer)
        for reactor in self.reactors.values():
            await reactor.init_peer(peer)
        await peer.start()
        self.peers[ni.node_id] = peer
        for reactor in self.reactors.values():
            await reactor.add_peer(peer)
        self.metrics.peers.set(len(self.peers))
        self.log.info("added peer", peer=ni.node_id[:12], outbound=outbound, total=len(self.peers))
        return peer

    # -- demux + errors ----------------------------------------------------
    async def _on_peer_receive(self, chan_id: int, peer: Peer, msg: bytes) -> None:
        reactor = self.reactors_by_ch.get(chan_id)
        if reactor is None:
            await self.stop_peer_for_error(peer, f"unknown channel {chan_id:#x}")
            return
        self.metrics.peer_receive_bytes_total.labels(
            chain_id=self.node_info.network, peer_id=peer.id, chID=str(chan_id)
        ).inc(len(msg))
        fuzz = getattr(peer, "fuzz", None)
        if fuzz is not None and fuzz.drop_recv():
            return  # chaos: inbound message lost
        await reactor.receive(chan_id, peer, msg)

    async def _on_peer_error(self, peer: Peer, err: Exception) -> None:
        await self.stop_peer_for_error(peer, str(err))

    async def stop_peer_for_error(self, peer: Peer, reason: str) -> None:
        """switch.go:323 + persistent reconnect :376.

        When invoked from inside one of the peer's own connection tasks
        (recv delivering the offending message, ping noticing the error),
        the stop is detached onto a switch task: stopping inline would have
        mconn.stop() await the cancellation of the very task this call
        chain is suspended in — a cycle only the 10 s stop timeout breaks,
        parking a half-stopped peer past test/node teardown."""
        if self.peers.get(peer.id) is not peer:
            # identity, not membership: the table entry may already be a
            # NEWER connection with the same id — its state is not ours
            # to touch
            return
        self.log.info("stopping peer for error", peer=peer.id[:12], err=reason)
        if self.addr_book is not None:
            # trust feed: a peer stopped for cause is bad conduct
            self.addr_book.mark_failed(peer.id)
        if asyncio.current_task() in peer.mconn._tasks:
            if self._stopped:
                # Switch teardown in progress: spawn() would refuse (its
                # cancel pass already ran) and the peer would end up popped
                # but never stopped.  Leave it in the table — on_stop's
                # sweep stops every listed peer from the stop task, where
                # inline stopping is safe.
                return
            # The peer stays in self.peers until _stop_and_remove_peer
            # pops it, so a not-yet-run task is still covered by the
            # on_stop sweep if the switch stops first.
            self.spawn(
                self._finish_stop_peer(peer, reason), f"peer-err-{peer.id[:8]}"
            )
            return
        await self._stop_and_remove_peer(peer, reason)
        if peer.persistent:
            self._maybe_reconnect(peer.id)

    async def _finish_stop_peer(self, peer: Peer, reason: str) -> None:
        if self.peers.get(peer.id) is not peer:
            return  # a second conn-task error already detached a stop
        await self._stop_and_remove_peer(peer, reason)
        if peer.persistent:
            self._maybe_reconnect(peer.id)

    async def stop_peer_gracefully(self, peer: Peer) -> None:
        await self._stop_and_remove_peer(peer, None)

    async def _stop_and_remove_peer(self, peer: Peer, reason: Optional[str]) -> None:
        if self.peers.get(peer.id) is not peer:
            # a replacement connection owns the slot (or it is already
            # gone): stop THIS object only — popping the table / calling
            # reactor.remove_peer here would tear down the replacement's
            # per-peer state and leave a live connection with no gossip
            # routines (measured: a 2-val net wedged at height 0 forever)
            if peer.is_running:
                await peer.stop()
            return
        # hold the id until reactor teardown completes: peer.stop() and
        # reactor.remove_peer await, and a new connection with this id
        # admitted in between would be destroyed by OUR teardown
        self._stopping.add(peer.id)
        try:
            self.peers.pop(peer.id, None)
            self.metrics.peers.set(len(self.peers))
            if peer.is_running:
                await peer.stop()
            for reactor in self.reactors.values():
                await reactor.remove_peer(peer, reason)
        finally:
            self._stopping.discard(peer.id)

    def _maybe_reconnect(self, peer_id: str) -> None:
        addr = self.persistent_addrs.get(peer_id)
        if addr is None or peer_id in self._reconnecting:
            return
        self._reconnecting.add(peer_id)
        self.spawn(self._reconnect_routine(peer_id, addr), f"reconnect-{peer_id[:8]}")

    async def _reconnect_routine(self, peer_id: str, addr: str) -> None:
        """Exponential backoff with jitter (switch.go:376)."""
        try:
            for attempt in range(RECONNECT_ATTEMPTS):
                backoff = RECONNECT_BASE_INTERVAL * (1.3**attempt) * (0.8 + 0.4 * random.random())
                await asyncio.sleep(min(backoff, 60.0))
                if peer_id in self.peers or not self.is_running:
                    return
                peer = await self.dial_peer(addr, persistent=True)
                if peer is not None:
                    return
        finally:
            self._reconnecting.discard(peer_id)

    # -- broadcast (switch.go:262) ----------------------------------------
    async def broadcast(self, chan_id: int, msg: bytes) -> None:
        await asyncio.gather(
            *(p.send(chan_id, msg) for p in list(self.peers.values())), return_exceptions=True
        )

    def num_peers(self) -> int:
        return len(self.peers)

    def peer_list(self) -> List[Peer]:
        return list(self.peers.values())
