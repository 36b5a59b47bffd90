"""StorageHealth: one sink for storage-fault observations (the port's copy
of the class in tendermint_tpu/libs/watchdog.py; the health watchdog that
reads it is not ported yet, ROADMAP 1.8).

The block store reports corruption, quarantine and refills here; the
counters and the statvfs free-space probe are what a node's `disk_fault` /
`disk_pressure` detectors and `storage_info` read.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional


class StorageHealth:
    """One sink for every storage-fault observation in the node — the WAL,
    block store, state store, mempool journal, privval and the consensus
    halt path all report here — plus the free-space probe.  The watchdog's
    `disk_fault` / `disk_pressure` detectors read it; `storage_info` and
    debug bundles serve its summary.  Thread-light: counters only, safe to
    bump from executor threads."""

    def __init__(self, data_dir: Optional[str] = None, metrics=None):
        self.data_dir = data_dir
        self.metrics = metrics  # StorageMetrics (node wires after provider)
        self.write_errors: Dict[str, int] = {}
        self.corruptions: Dict[str, int] = {}
        self.halts: Dict[str, str] = {}  # component -> reason (sticky)
        self.quarantined: Dict[str, int] = {}  # store -> live count
        self.refills = 0
        self.last_error: Optional[dict] = None  # {mono, store, err}
        self.last_scan: Optional[dict] = None

    # -- observation sinks ---------------------------------------------------
    def note_write_error(self, store: str, err: BaseException) -> None:
        self.write_errors[store] = self.write_errors.get(store, 0) + 1
        self.last_error = {"mono": time.monotonic(), "store": store, "err": repr(err)}
        if self.metrics is not None:
            self.metrics.write_errors.labels(store=store).inc()

    def note_corruption(self, store: str, detail: str) -> None:
        self.corruptions[store] = self.corruptions.get(store, 0) + 1
        self.last_error = {"mono": time.monotonic(), "store": store, "err": detail}
        if self.metrics is not None:
            self.metrics.corruptions.labels(store=store).inc()

    def set_quarantined(self, store: str, total: int) -> None:
        """Single source of truth for the quarantine gauge: callers pass
        the store's CURRENT quarantine-set size (prune can silently drop
        entries, so an incremental counter would drift into phantoms)."""
        self.quarantined[store] = total
        if self.metrics is not None:
            self.metrics.quarantined.set(total)

    def note_quarantine(
        self, store: str, height: int, reason: str, total: Optional[int] = None
    ) -> None:
        self.set_quarantined(
            store, total if total is not None else self.quarantined.get(store, 0) + 1
        )
        self.note_corruption(store, f"height {height} quarantined: {reason}")

    def note_refill(
        self, store: str, height: int, total: Optional[int] = None
    ) -> None:
        self.refills += 1
        self.set_quarantined(
            store,
            total if total is not None else max(0, self.quarantined.get(store, 0) - 1),
        )
        if self.metrics is not None:
            self.metrics.refills.inc()

    def note_halt(self, component: str, reason: str) -> None:
        self.halts[component] = reason

    def note_scan(self, report: dict) -> None:
        self.last_scan = report
        if self.metrics is not None:
            self.metrics.integrity_scan_seconds.set(report.get("ms", 0.0) / 1000.0)
            self.metrics.quarantined.set(len(report.get("quarantined", ())))

    # -- read surface --------------------------------------------------------
    def total_faults(self) -> int:
        return sum(self.write_errors.values()) + sum(self.corruptions.values())

    def free_bytes(self) -> Optional[int]:
        """statvfs headroom of the data dir (None: memdb node / probe
        failed — and a probe failing on a real dir is itself suspicious,
        but not enough signal to alarm on)."""
        if not self.data_dir:
            return None
        try:
            st = os.statvfs(self.data_dir)
        except OSError:
            return None
        free = st.f_bavail * st.f_frsize
        if self.metrics is not None:
            self.metrics.free_bytes.set(free)
        return free

    def summary(self) -> dict:
        return {
            "write_errors": dict(self.write_errors),
            "corruptions": dict(self.corruptions),
            "halts": dict(self.halts),
            "quarantined": dict(self.quarantined),
            "refills": self.refills,
            "last_error": dict(self.last_error) if self.last_error else None,
            "last_scan": dict(self.last_scan) if self.last_scan else None,
            "free_bytes": self.free_bytes(),
        }
