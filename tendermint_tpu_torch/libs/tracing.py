"""Flight recorder: an always-on ring buffer of hot-path span events (the
recorder part of tendermint_tpu/libs/tracing.py; its on-disk spool, merge
and export tools are not part of the port).

Event kinds the port emits (crypto/batch_verifier.py):

    verify.enqueue        pending                  vote entered the batcher
    verify.enqueue_batch  n, pending               whole batch entered as one arrival
    verify.direct_batch   n                        pre-batched frame sent straight to the engine
    verify.flush          batch, wait_ms, quantum_ms, shards   batcher coalesced a flush
    verify.dispatch       n, bucket, path, host_prep_ms, device_ms, shards
    verify.bucket_compile bucket, ms, ok, shards   background kernel-library build done
    verify.chunked        selected, rtt_ms, prep_ms, shards    RTT-probe decision
    verify.table          hit, n                   TableCache lookup
    verify.table_rebuild  set_key, validators, ms, ok, shards  proactive table build done

Events are flat dicts {"seq", "t_ns", "kind", **fields}; `t_ns` is
time.monotonic_ns().  `record` on a disabled recorder (or NOP) is one
attribute check; enabled it is one uncontended lock, one clock read and one
list store.  Writers may be the event loop, the flush executor and build
threads at once; the lock makes seq order equal timestamp order.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence


class NopRecorder:
    """Disabled-path recorder: accepts events and drops them."""

    enabled = False
    size = 0
    sample_high_rate = 1

    def record(self, kind: str, **fields) -> None:
        pass

    def record_sampled(self, kind: str, **fields) -> None:
        pass

    def events(self, since: int = 0, kinds=None) -> List[dict]:
        return []

    def snapshot(self, since: int = 0, kinds=None) -> dict:
        return {"enabled": False, "size": 0, "next_seq": 0, "events": []}


NOP = NopRecorder()


class FlightRecorder:
    """Fixed-size ring of span events; `enabled=False` degrades to the nop
    fast path while keeping one object type at every call site."""

    __slots__ = (
        "size", "enabled", "sample_high_rate", "_buf", "_seq", "_lock",
        "_sample_counts", "_wall_ns_fn", "anchor_mono_ns", "anchor_wall_ns",
    )

    def __init__(
        self,
        size: int = 8192,
        enabled: bool = True,
        sample_high_rate: int = 1,
        wall_ns_fn: Callable[[], int] = time.time_ns,
    ):
        if size < 1:
            raise ValueError("flight recorder size must be >= 1")
        if sample_high_rate < 1:
            raise ValueError("trace_sample_high_rate must be >= 1")
        self.size = size
        self.enabled = enabled
        self.sample_high_rate = sample_high_rate
        self._buf: List[Optional[tuple]] = [None] * size
        self._seq = 0  # next sequence number; monotonic, never wraps
        self._lock = threading.Lock()
        self._sample_counts: dict = {}
        # monotonic -> wall anchor, so dumps of two processes can be
        # placed on one wall timeline
        self._wall_ns_fn = wall_ns_fn
        self.anchor_mono_ns = time.monotonic_ns()
        self.anchor_wall_ns = wall_ns_fn()

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        with self._lock:
            i = self._seq
            self._seq = i + 1
            self._buf[i % self.size] = (i, time.monotonic_ns(), kind, fields)

    def record_sampled(self, kind: str, **fields) -> None:
        """1-in-N recording for high-rate kinds.  The stored event carries
        `sampled=N` so consumers can re-scale counts; N=1 is a plain
        record."""
        if not self.enabled:
            return
        n = self.sample_high_rate
        if n <= 1:
            self.record(kind, **fields)
            return
        with self._lock:
            c = self._sample_counts.get(kind, 0) + 1
            self._sample_counts[kind] = 0 if c >= n else c
            if c != 1:  # store the 1st of every N
                return
            fields["sampled"] = n
            i = self._seq
            self._seq = i + 1
            self._buf[i % self.size] = (i, time.monotonic_ns(), kind, fields)

    def events(self, since: int = 0, kinds: Optional[Sequence[str]] = None) -> List[dict]:
        """Events still in the ring with seq >= since, oldest first.
        `kinds` filters by prefix match."""
        out = []
        pref = tuple(kinds) if kinds else None
        for ev in self._buf:
            if ev is not None and ev[0] >= since:
                if pref is not None and not ev[2].startswith(pref):
                    continue
                out.append(ev)
        out.sort(key=lambda ev: ev[0])
        return [
            {"seq": seq, "t_ns": t_ns, "kind": kind, **fields}
            for seq, t_ns, kind, fields in out
        ]

    def snapshot(self, since: int = 0, kinds: Optional[Sequence[str]] = None) -> dict:
        """The events since `since` with the ring's bookkeeping: `next_seq`
        lets a poller pass it back as `since`; `dropped` counts events that
        aged out of the ring; `anchor` is re-sampled here."""
        events = self.events(since, kinds)
        mono = time.monotonic_ns()
        wall = self._wall_ns_fn()
        return {
            "enabled": self.enabled,
            "size": self.size,
            "next_seq": self._seq,
            "since": since,
            "dropped": max(0, self._seq - self.size),
            "anchor": {"mono_ns": mono, "wall_ns": wall},
            "events": events,
        }

    @property
    def dropped(self) -> int:
        """Events that have aged out of the ring since start."""
        return max(0, self._seq - self.size)


#: The statesync bootstrap chain every snapshot restore must record, in
#: order — the statesync-smoke acceptance gate.
STATESYNC_CHAIN = ("statesync.offer", "statesync.chunk", "statesync.restore", "statesync.handover")


def statesync_bootstrap_ms(events: List[dict]) -> Optional[float]:
    """Wall milliseconds from the (first) snapshot offer to the fastsync
    handover, measured from real recorder spans — the number bench.py
    reports as `statesync_bootstrap_ms`.  None unless the full
    offer→chunk→restore→handover chain is present in order."""
    first: dict = {}
    last: dict = {}
    for ev in events:
        k = ev.get("kind")
        if k in STATESYNC_CHAIN:
            first.setdefault(k, ev["t_ns"])
            last[k] = ev["t_ns"]
    if any(k not in first for k in STATESYNC_CHAIN):
        return None
    o, c, r, h = (first[STATESYNC_CHAIN[0]], first[STATESYNC_CHAIN[1]],
                  last[STATESYNC_CHAIN[2]], last[STATESYNC_CHAIN[3]])
    if not (o <= c <= r <= h):
        return None
    return (h - o) / 1e6
