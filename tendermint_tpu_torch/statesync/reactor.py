"""Statesync reactor: IO around the syncer + snapshot serving (the port's
copy of tendermint_tpu/statesync/reactor.py; its frames' bytes equal the
JAX package's, so either package's node serves the other's syncer).

Reference parity: statesync/reactor.go — two channels (snapshot discovery
0x60, chunk transfer 0x61); every node SERVES its app's snapshots to
bootstrapping peers, and a node started with `[statesync] enable` on an
empty store additionally runs a StateSyncer that restores the best peer
snapshot, then hands the verified state to the fastsync tail.

Event-driven from day one: there are no polling ticks — the syncer's loop
sleeps on an asyncio.Event set by snapshot offers, chunk arrivals and
peer changes (a 250 ms repair tick survives only to reap chunk-request
timeouts).
"""

from __future__ import annotations

import asyncio
from typing import List, Optional

from ..abci import types as abci
from ..encoding import codec
from ..libs.log import get_logger
from ..p2p import ChannelDescriptor, Reactor
from ..p2p import behaviour

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61

# caps mirror the reference reactor: a peer may advertise at most this
# many snapshots per response, and chunks are bounded by the app's
# chunking (recv capacity gives 16 MiB headroom)
MAX_SNAPSHOTS_PER_RESPONSE = 10
CHUNK_RECV_CAPACITY = 16 << 20


def _enc(kind: str, fields: dict) -> bytes:
    return codec.dumps({"k": kind, **fields})


def _dec(msg_bytes: bytes):
    d = codec.loads(msg_bytes)
    return d.pop("k"), d


class StateSyncReactor(Reactor):
    def __init__(self, proxy_app, syncer=None, on_done=None):
        """`proxy_app` is the node's AppConns (snapshot calls ride the
        query connection); `syncer` is set only on a bootstrapping node;
        `on_done(state_or_none)` is the node's handover callback."""
        super().__init__("statesync-reactor")
        self.proxy_app = proxy_app
        self.syncer = syncer
        self.on_done = on_done
        self.log = get_logger("statesync")
        self.reporter = None  # SwitchReporter once the switch is known
        self.syncing = syncer is not None

    def get_channels(self) -> List[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                id=SNAPSHOT_CHANNEL, priority=5, send_queue_capacity=10,
            ),
            ChannelDescriptor(
                id=CHUNK_CHANNEL, priority=3, send_queue_capacity=16,
                recv_message_capacity=CHUNK_RECV_CAPACITY,
            ),
        ]

    async def on_start(self) -> None:
        if self.syncer is not None:
            self.syncer.request_chunk = self._request_chunk
            self.syncer.report_bad_peer = self._report_bad_peer
            self.syncer.refresh_snapshots = self._broadcast_snapshot_request
            self.spawn(self._sync_routine(), "statesync")

    async def _broadcast_snapshot_request(self) -> None:
        if self.switch is not None:
            await self.switch.broadcast(SNAPSHOT_CHANNEL, _enc("snapshots_request", {}))

    # -- peer lifecycle ----------------------------------------------------
    async def add_peer(self, peer) -> None:
        if self.syncing and self.syncer is not None:
            self.syncer.add_peer(peer.id)
            await peer.send(SNAPSHOT_CHANNEL, _enc("snapshots_request", {}))

    async def remove_peer(self, peer, reason=None) -> None:
        if self.syncer is not None:
            self.syncer.remove_peer(peer.id)

    async def _report(self, b) -> None:
        if self.reporter is None:
            self.reporter = behaviour.SwitchReporter(self.switch)
        await self.reporter.report(b)

    async def _report_bad_peer(self, peer_id: str, reason: str) -> None:
        await self._report(behaviour.bad_message(peer_id, reason))

    # -- IO callbacks for the syncer ---------------------------------------
    async def _request_chunk(self, peer_id: str, height: int, format_: int, index: int) -> bool:
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is None:
            return False
        return peer.try_send(
            CHUNK_CHANNEL,
            _enc("chunk_request", {"height": height, "format": format_, "index": index}),
        )

    # -- receive -----------------------------------------------------------
    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        try:
            kind, msg = _dec(msg_bytes)
        except Exception:
            await self._report(behaviour.bad_message(peer.id, "malformed statesync message"))
            return
        try:
            if chan_id == SNAPSHOT_CHANNEL and kind == "snapshots_request":
                await self._serve_snapshots(peer)
            elif chan_id == SNAPSHOT_CHANNEL and kind == "snapshots_response":
                self._on_snapshots(peer, msg)
            elif chan_id == CHUNK_CHANNEL and kind == "chunk_request":
                await self._serve_chunk(peer, msg)
            elif chan_id == CHUNK_CHANNEL and kind == "chunk_response":
                self._on_chunk(peer, msg)
            else:
                await self._report(
                    behaviour.bad_message(peer.id, f"unexpected statesync message {kind!r}")
                )
        except (KeyError, TypeError, ValueError):
            await self._report(behaviour.bad_message(peer.id, "invalid statesync fields"))

    async def _serve_snapshots(self, peer) -> None:
        res = await self.proxy_app.query().list_snapshots(abci.RequestListSnapshots())
        snaps = [
            {
                "height": s.height, "format": s.format, "chunks": s.chunks,
                "hash": s.hash, "metadata": s.metadata,
            }
            for s in res.snapshots[-MAX_SNAPSHOTS_PER_RESPONSE:]
        ]
        await peer.send(SNAPSHOT_CHANNEL, _enc("snapshots_response", {"snapshots": snaps}))

    def _on_snapshots(self, peer, msg) -> None:
        if self.syncer is None:
            return
        for s in msg["snapshots"][:MAX_SNAPSHOTS_PER_RESPONSE]:
            # field types are attacker-controlled: bytes() on a peer-sent
            # int would ALLOCATE that many zero bytes (remote OOM), so
            # require actual bytes and sane sizes or report the peer
            if not isinstance(s.get("hash"), bytes) or not isinstance(
                s.get("metadata"), bytes
            ):
                raise ValueError("snapshot hash/metadata must be bytes")
            if len(s["hash"]) != 32 or len(s["metadata"]) > 2 << 20:
                raise ValueError("snapshot hash/metadata out of bounds")
            self.syncer.add_snapshot(
                peer.id,
                abci.Snapshot(
                    height=int(s["height"]), format=int(s["format"]),
                    chunks=int(s["chunks"]), hash=s["hash"],
                    metadata=s["metadata"],
                ),
            )

    async def _serve_chunk(self, peer, msg) -> None:
        height, format_, index = int(msg["height"]), int(msg["format"]), int(msg["index"])
        res = await self.proxy_app.query().load_snapshot_chunk(
            abci.RequestLoadSnapshotChunk(height=height, format=format_, chunk=index)
        )
        await peer.send(
            CHUNK_CHANNEL,
            _enc("chunk_response", {
                "height": height, "format": format_, "index": index,
                "chunk": res.chunk, "missing": not res.chunk,
            }),
        )

    def _on_chunk(self, peer, msg) -> None:
        if self.syncer is None:
            return
        # same bytes()-allocation hazard as snapshots: never coerce
        if not isinstance(msg.get("chunk"), bytes):
            raise ValueError("chunk must be bytes")
        self.syncer.on_chunk(
            peer.id, int(msg["height"]), int(msg["format"]), int(msg["index"]),
            msg["chunk"], bool(msg["missing"]),
        )

    # -- bootstrap routine -------------------------------------------------
    async def _sync_routine(self) -> None:
        state = None
        try:
            state = await self.syncer.run()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.log.error("statesync failed", err=repr(e))
        self.syncing = False
        if state is not None:
            self.syncer.recorder.record("statesync.handover", height=state.last_block_height)
            self.log.info("statesync: handing over to fastsync", height=state.last_block_height)
        else:
            self.log.info("statesync: falling back to fastsync from local state")
        if self.on_done is not None:
            try:
                await self.on_done(state)
            except Exception as e:  # a broken handover must be LOUD
                self.log.error("statesync handover failed", err=repr(e))
                raise
