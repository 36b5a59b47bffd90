"""MConnection: N priority-weighted byte-ID channels over one connection (the
port's copy of tendermint_tpu/p2p/conn/connection.py).

Reference parity: p2p/conn/connection.go (MConnection:77, Channel:734,
ChannelDescriptor:710, sendRoutine:419 with least-recently-sent-by-priority
packet scheduling, recvRoutine:553 demuxing to reactor callbacks, ping/pong
keepalive, 64KiB max packets :898).  Like the node that builds it, the
connection runs unthrottled: it keeps the flowrate meters and no limit.

Wire format per packet: msgpack {"t": "msg"|"ping"|"pong", "c": channel,
"f": eof-flag, "d": bytes} framed by the secret connection's message layer, written by the port's
encoding/msgpack.py (the bytes the `msgpack` package writes).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ...encoding import msgpack
from ...libs.flowrate import Meter
from ...libs.log import get_logger
from ...libs.service import Service

DEFAULT_MAX_PACKET_PAYLOAD_SIZE = 1024
MAX_PACKET_PAYLOAD_SIZE_CAP = 64 * 1024  # conn/connection.go:898
DEFAULT_SEND_QUEUE_CAPACITY = 1
DEFAULT_RECV_BUFFER_CAPACITY = 4096
DEFAULT_RECV_MESSAGE_CAPACITY = 22 * 1024 * 1024
PING_INTERVAL = 10.0
PONG_TIMEOUT = 45.0
FLUSH_THROTTLE = 0.02


class LocalFault(Exception):
    """A fault of this node, not of the peer: the verify engine raised while
    a reactor handled a peer's message.  The JAX reactors read such an error
    as the peer's (the frame is dropped, or the vote reads as badly signed);
    the port's raise this instead, and the connection's receive task
    re-raises it and fails, so an engine fault is never hidden behind a
    peer disconnect."""


@dataclass
class ChannelDescriptor:
    """conn/connection.go:710."""

    id: int
    priority: int = 1
    send_queue_capacity: int = DEFAULT_SEND_QUEUE_CAPACITY
    recv_buffer_capacity: int = DEFAULT_RECV_BUFFER_CAPACITY
    recv_message_capacity: int = DEFAULT_RECV_MESSAGE_CAPACITY


class _Channel:
    """conn/connection.go:734 — per-channel send queue + recv assembly."""

    def __init__(self, desc: ChannelDescriptor, max_payload: int):
        self.desc = desc
        self.max_payload = max_payload
        self.send_queue: asyncio.Queue = asyncio.Queue(maxsize=max(desc.send_queue_capacity, 1))
        self.sending: bytes = b""
        self.recently_sent = 0  # exponentially decayed for priority fairness
        self.recv_buf = b""

    def is_send_pending(self) -> bool:
        return self.sending != b"" or not self.send_queue.empty()

    def next_packet(self) -> dict:
        if not self.sending and not self.send_queue.empty():
            self.sending = self.send_queue.get_nowait()
        chunk = self.sending[: self.max_payload]
        self.sending = self.sending[self.max_payload :]
        eof = len(self.sending) == 0
        self.recently_sent += len(chunk)
        return {"t": "msg", "c": self.desc.id, "f": eof, "d": chunk}

    def recv_packet(self, packet: dict) -> Optional[bytes]:
        """Returns the full message when the eof packet arrives."""
        if len(packet["d"]) > self.max_payload:
            raise ConnectionError(
                f"packet payload exceeds max on channel {self.desc.id:#x}"
            )
        self.recv_buf += packet["d"]
        if len(self.recv_buf) > self.desc.recv_message_capacity:
            raise ConnectionError(
                f"received message exceeds capacity on channel {self.desc.id:#x}"
            )
        if packet["f"]:
            msg, self.recv_buf = self.recv_buf, b""
            return msg
        return None


class MConnection(Service):
    """conn: an object with async write_msg(bytes)/read_msg()->bytes
    (SecretConnection or a plain stream adapter)."""

    def __init__(
        self,
        conn,
        channel_descs: List[ChannelDescriptor],
        on_receive: Callable[[int, bytes], "object"],
        on_error: Callable[[Exception], "object"],
        max_packet_payload: int = DEFAULT_MAX_PACKET_PAYLOAD_SIZE,
    ):
        super().__init__("mconn")
        self.conn = conn
        self.on_receive = on_receive  # async fn(chan_id, msg_bytes)
        self.on_error = on_error  # async fn(err)
        self.max_packet_payload = min(max_packet_payload, MAX_PACKET_PAYLOAD_SIZE_CAP)
        self.channels: Dict[int, _Channel] = {
            d.id: _Channel(d, self.max_packet_payload) for d in channel_descs
        }
        self.log = get_logger("mconn")
        self._send_signal = asyncio.Event()
        self._pong_pending = False
        self._last_msg_recv = time.monotonic()
        self.send_meter = Meter()  # libs/flowrate — net_info ConnectionStatus
        self.recv_meter = Meter()
        self._stopping = False

    def status(self) -> dict:
        """conn.ConnectionStatus flavor (connection.go:560)."""
        return {
            "send_monitor": self.send_meter.status(),
            "recv_monitor": self.recv_meter.status(),
            "channels": [
                {
                    "id": ch.desc.id,
                    "send_queue_size": ch.send_queue.qsize(),
                    "priority": ch.desc.priority,
                    "recently_sent": ch.recently_sent,
                }
                for ch in self.channels.values()
            ],
        }

    async def on_start(self) -> None:
        self.spawn(self._send_routine(), "send")
        self.spawn(self._recv_routine(), "recv")
        self.spawn(self._ping_routine(), "ping")

    async def on_stop(self) -> None:
        self._stopping = True
        self.conn.close()

    # -- sending -----------------------------------------------------------
    async def send(self, chan_id: int, msg: bytes) -> bool:
        """Queue msg on channel; blocks on a full queue (peer backpressure).
        Returns False for unknown channels (connection.go Send)."""
        ch = self.channels.get(chan_id)
        if ch is None or not self.is_running:
            return False
        await ch.send_queue.put(bytes(msg))
        self._send_signal.set()
        return True

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        """Non-blocking send; False if the queue is full (TrySend)."""
        ch = self.channels.get(chan_id)
        if ch is None or not self.is_running:
            return False
        try:
            ch.send_queue.put_nowait(bytes(msg))
        except asyncio.QueueFull:
            return False
        self._send_signal.set()
        return True

    def can_send(self, chan_id: int) -> bool:
        ch = self.channels.get(chan_id)
        return ch is not None and not ch.send_queue.full()

    def _pick_channel(self) -> Optional[_Channel]:
        """Least ratio of recently-sent to priority (sendPacketMsg
        connection.go:470)."""
        best, best_ratio = None, None
        for ch in self.channels.values():
            if not ch.is_send_pending():
                continue
            ratio = ch.recently_sent / ch.desc.priority
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    async def _send_routine(self) -> None:
        try:
            while True:
                ch = self._pick_channel()
                if ch is None:
                    if self._pong_pending:
                        self._pong_pending = False
                        await self._write_packet({"t": "pong"})
                        continue
                    self._send_signal.clear()
                    try:
                        # idle backstop only: sends AND pong-pending set the
                        # signal, so nothing waits on this timeout.  It was
                        # 0.1 s, which at a 100-node rig's ~700 connections
                        # meant ~7000 no-op wakeups (each a wait_for task)
                        # per second of pure idle churn on the event loop.
                        await asyncio.wait_for(self._send_signal.wait(), timeout=2.0)
                    except asyncio.TimeoutError:
                        pass
                    # decay recently-sent so bursts don't starve low-priority
                    for c in self.channels.values():
                        c.recently_sent = int(c.recently_sent * 0.8)
                    continue
                packet = ch.next_packet()
                await self._write_packet(packet)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if not self._stopping:
                await self._flush_error(e)

    async def _write_packet(self, packet: dict) -> None:
        data = msgpack.packb(packet)
        self.send_meter.update(len(data))
        await self.conn.write_msg(data)

    # -- receiving ---------------------------------------------------------
    async def _recv_routine(self) -> None:
        # inbound packets are capped like outbound ones — a peer must not be
        # able to force multi-MB allocations with one oversized frame
        max_packet = self.max_packet_payload + 1024  # payload + framing slack
        try:
            while True:
                raw = await self.conn.read_msg(max_size=max_packet)
                self.recv_meter.update(len(raw))
                packet = msgpack.unpackb(raw)
                self._last_msg_recv = time.monotonic()
                t = packet.get("t")
                if t == "ping":
                    self._pong_pending = True
                    self._send_signal.set()
                elif t == "pong":
                    pass
                elif t == "msg":
                    ch = self.channels.get(packet["c"])
                    if ch is None:
                        raise ConnectionError(f"unknown channel {packet['c']:#x}")
                    msg = ch.recv_packet(packet)
                    if msg is not None:
                        await self.on_receive(ch.desc.id, msg)
                else:
                    raise ConnectionError(f"unknown packet type {t!r}")
        except asyncio.CancelledError:
            raise
        except LocalFault:
            # this node's fault, not the peer's (p2p/base_reactor.py): the
            # task fails with it instead of stopping the peer
            raise
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            if not self._stopping:
                await self._flush_error(e)
        except Exception as e:
            if not self._stopping:
                await self._flush_error(e)

    async def _ping_routine(self) -> None:
        while True:
            await asyncio.sleep(PING_INTERVAL)
            await self._write_packet({"t": "ping"})
            if time.monotonic() - self._last_msg_recv > PONG_TIMEOUT:
                await self._flush_error(ConnectionError("pong timeout"))
                return

    async def _flush_error(self, e: Exception) -> None:
        if self.on_error is not None:
            await self.on_error(e)
