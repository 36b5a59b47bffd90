"""Mempool reactor: tx gossip with per-peer flowrate pacing (the port's copy
of tendermint_tpu/mempool_reactor.py).

Reference parity: mempool/reactor.go (channel 0x30:20,
broadcastTxRoutine:188 walking the clist per peer and skipping the
originating sender, Receive:157 feeding CheckTx).

QoS (overload robustness): outbound tx frames to each peer are capped at
`mempool.broadcast_batch_bytes` and token-bucket paced to
`mempool.broadcast_rate_bytes` bytes/sec (libs/flowrate.TokenBucket), so
an ingress firehose fans out as a bounded stream per link instead of
saturating every peer connection ahead of consensus traffic.

A tx that is not bytes is the peer's fault and stops it before check_tx
runs (in the JAX reactor check_tx raises TypeError on it, which stops the
peer the same way).  Deviation (ROADMAP 3): a peer's tx whose check_tx
fails in the verify engine itself (crypto.batch.EngineError, from the
signed-tx lane) is this node's fault: it is logged at ERROR and raised as
p2p.LocalFault, which fails the connection's receive task (the JAX
mempool reads it as a bad signature).  Any other exception reaches the
connection, which stops the peer, as in the JAX reactor.
"""

from __future__ import annotations

import asyncio
from typing import List

from .crypto.batch import EngineError
from .encoding import codec
from .libs.flowrate import TokenBucket
from .libs.log import get_logger
from .mempool import Mempool, MempoolError
from .p2p import ChannelDescriptor, LocalFault, Reactor

MEMPOOL_CHANNEL = 0x30


def chunk_txs(txs: List[bytes], max_bytes: int) -> List[List[bytes]]:
    """Split a tx list into frames of <= max_bytes payload each (one
    oversized tx still rides alone — the mempool's max_tx_bytes bounds
    it).  Pure so the framing policy is testable without a peer."""
    frames: List[List[bytes]] = []
    cur: List[bytes] = []
    cur_bytes = 0
    for tx in txs:
        if cur and cur_bytes + len(tx) > max_bytes:
            frames.append(cur)
            cur, cur_bytes = [], 0
        cur.append(tx)
        cur_bytes += len(tx)
    if cur:
        frames.append(cur)
    return frames


class MempoolReactor(Reactor):
    def __init__(self, mempool: Mempool, broadcast: bool = True, config=None):
        super().__init__("mempool-reactor")
        cfg = config or {}
        self.mempool = mempool
        self.broadcast = broadcast
        self.rate_bytes = cfg.get("broadcast_rate_bytes", 0)
        self.batch_bytes = cfg.get("broadcast_batch_bytes", 65536)
        self.log = get_logger("mempool-reactor")
        self._routines = {}

    def get_channels(self) -> List[ChannelDescriptor]:
        return [ChannelDescriptor(id=MEMPOOL_CHANNEL, priority=5, send_queue_capacity=128)]

    async def add_peer(self, peer) -> None:
        if self.broadcast:
            self._routines[peer.id] = self.spawn(
                self._broadcast_tx_routine(peer), f"mempool-bcast-{peer.id[:8]}"
            )

    async def remove_peer(self, peer, reason=None) -> None:
        task = self._routines.pop(peer.id, None)
        if task is not None:
            task.cancel()

    async def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        """reactor.go:157 — peer txs into CheckTx with the sender marked."""
        try:
            txs = codec.loads(msg_bytes)["txs"]
        except Exception:
            await self.switch.stop_peer_for_error(peer, "malformed mempool message")
            return
        if not isinstance(txs, list) or not all(isinstance(tx, bytes) for tx in txs):
            await self.switch.stop_peer_for_error(peer, "malformed mempool message")
            return
        for tx in txs:
            try:
                await self.mempool.check_tx(tx, sender=peer.id)
            except MempoolError:
                pass  # duplicates/full are not peer faults
            except EngineError as e:
                self.log.error("check_tx of a peer's tx failed", peer=peer.id[:12], err=repr(e))
                raise LocalFault(f"check_tx of a peer's tx failed: {e!r}") from e

    async def _broadcast_tx_routine(self, peer) -> None:
        """reactor.go:188 — stream mempool txs to the peer, skipping txs it
        sent us.  Frames are byte-capped and paced by a per-peer token
        bucket (debit discipline: a frame larger than the burst spreads
        out instead of never qualifying)."""
        bucket = (
            TokenBucket(self.rate_bytes, 2 * self.rate_bytes)
            if self.rate_bytes > 0
            else None
        )
        seq = 0
        while True:
            mtxs = await self.mempool.next_txs_after(seq)
            batch = []
            for mtx in mtxs:
                seq = max(seq, mtx.seq)
                if peer.id in mtx.senders:
                    continue
                batch.append(mtx.tx)
            for frame in chunk_txs(batch, self.batch_bytes):
                data = codec.dumps({"txs": frame})
                if bucket is not None:
                    wait = bucket.debit(len(data))
                    if wait > 0:
                        await asyncio.sleep(wait)
                ok = await peer.send(MEMPOOL_CHANNEL, data)
                if not ok:
                    return
            await asyncio.sleep(0.01)
