"""Reactor interface (the port's copy of tendermint_tpu/p2p/base_reactor.py).

Reference parity: p2p/base_reactor.go:15 — a protocol service multiplexed
over per-peer channels: declares ChannelDescriptors, gets peer lifecycle
callbacks, and receives demuxed messages.
"""

from __future__ import annotations

from typing import List, Optional

from ..libs.service import Service
from .conn.connection import ChannelDescriptor


class Reactor(Service):
    def __init__(self, name: str):
        super().__init__(name)
        self.switch = None

    def set_switch(self, switch) -> None:
        self.switch = switch

    def get_channels(self) -> List[ChannelDescriptor]:
        return []

    async def init_peer(self, peer) -> None:
        """Called before the peer starts (InitPeer)."""

    async def add_peer(self, peer) -> None:
        """Called once the peer is running (AddPeer)."""

    async def remove_peer(self, peer, reason: Optional[str] = None) -> None:
        """Called when the peer is stopped (RemovePeer)."""

    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        """Inbound message on one of this reactor's channels."""
