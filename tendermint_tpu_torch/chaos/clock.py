"""Pluggable consensus time source + per-node clock-skew injection (the
port's copy of tendermint_tpu/chaos/clock.py).

The consensus state machine reads time through exactly one object (its
`clock` attribute) instead of the `time` module, so a scenario can skew ONE
node's notion of wall-clock time without touching the process clock or any
other node, and a test can pin it.

Only the WALL clock (`time_ns`) skews.  `monotonic` stays honest: it feeds
timeout scheduling and span math, where a skew would model a broken CPU
rather than a wrong wall clock.

`metrics` and `recorder` are duck-typed: anything with
`clock_skew_seconds.set` and `record(kind, **fields)`.
"""

from __future__ import annotations

import time


class Clock:
    """The honest system clock — consensus' default time source."""

    def time_ns(self) -> int:
        return time.time_ns()

    def monotonic(self) -> float:
        return time.monotonic()


SYSTEM_CLOCK = Clock()


class SkewedClock(Clock):
    """Wall clock offset by a runtime-adjustable skew (seconds; may be
    negative)."""

    def __init__(self, skew_s: float = 0.0, metrics=None, recorder=None):
        self.skew_ns = int(skew_s * 1e9)
        self.metrics = metrics
        self.recorder = recorder
        self._publish(skew_s)

    def set_skew(self, skew_s: float) -> None:
        self.skew_ns = int(skew_s * 1e9)
        self._publish(skew_s)

    @property
    def skew_s(self) -> float:
        return self.skew_ns / 1e9

    def _publish(self, skew_s: float) -> None:
        if self.metrics is not None:
            self.metrics.clock_skew_seconds.set(skew_s)
        if self.recorder is not None:
            self.recorder.record("chaos.skew", skew_s=skew_s)

    def time_ns(self) -> int:
        return time.time_ns() + self.skew_ns
