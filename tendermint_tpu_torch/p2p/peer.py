"""Peer: a connected remote node (the port's copy of tendermint_tpu/p2p/peer.py).

Reference parity: p2p/peer.go (Peer iface:18, peer struct wrapping
MConnection + NodeInfo + per-peer metadata store).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..libs.log import get_logger
from ..libs.service import Service
from .conn.connection import ChannelDescriptor, MConnection
from .node_info import NodeInfo


class Peer(Service):
    def __init__(
        self,
        conn,  # SecretConnection or stream adapter
        node_info: NodeInfo,
        channel_descs: List[ChannelDescriptor],
        on_receive,  # async fn(chan_id, peer, msg_bytes)
        on_error,  # async fn(peer, err)
        outbound: bool,
        persistent: bool = False,
        socket_addr: str = "",
        mconfig: Optional[dict] = None,
        on_send_bytes=None,  # fn(chan_id, n) — switch wires send accounting
    ):
        super().__init__(f"peer-{node_info.node_id[:8]}")
        self.node_info = node_info
        self.outbound = outbound
        self.persistent = persistent
        self.socket_addr = socket_addr
        self._on_send_bytes = on_send_bytes
        self.remote_ip = getattr(conn, "remote_ip", "")
        self.log = get_logger(f"peer:{node_info.node_id[:8]}")
        self._data: Dict[str, object] = {}  # reactor scratch (peer.Set/Get)

        async def _recv(chan_id: int, msg: bytes):
            await on_receive(chan_id, self, msg)

        async def _err(e: Exception):
            await on_error(self, e)

        self.mconn = MConnection(conn, channel_descs, _recv, _err, **(mconfig or {}))

    @property
    def id(self) -> str:
        return self.node_info.node_id

    @property
    def gossip_version(self) -> int:
        """Negotiated consensus-gossip capability (p2p/node_info.py
        GOSSIP_BATCH_VERSION); 0 for peers that never advertised one.
        Defensive int-coerce: the comparison sites run inside gossip
        routines, where a TypeError would kill the task and wedge the
        peer (validate_basic rejects non-ints at handshake too)."""
        v = getattr(self.node_info, "gossip_version", 0)
        return v if isinstance(v, int) and not isinstance(v, bool) else 0

    async def on_start(self) -> None:
        await self.mconn.start()

    async def on_stop(self) -> None:
        if self.mconn.is_running:
            await self.mconn.stop()

    async def send(self, chan_id: int, msg: bytes) -> bool:
        ok = await self.mconn.send(chan_id, msg)
        # counted on acceptance into the channel queue, the send-side
        # mirror of the switch's receive accounting (p2p/metrics.go
        # PeerSendBytesTotal; the reference likewise counts at Send)
        if ok and self._on_send_bytes is not None:
            self._on_send_bytes(chan_id, len(msg))
        return ok

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        ok = self.mconn.try_send(chan_id, msg)
        if ok and self._on_send_bytes is not None:
            self._on_send_bytes(chan_id, len(msg))
        return ok

    def get(self, key: str):
        return self._data.get(key)

    def set(self, key: str, value) -> None:
        self._data[key] = value

    def __repr__(self) -> str:
        return f"Peer({self.id[:12]} out={self.outbound})"
