"""Timeout ticker: single-timer scheduler over (height, round, step) (the
port's copy of tendermint_tpu/consensus/ticker.py).

Reference parity: consensus/ticker.go (TimeoutTicker:17, timeoutRoutine:94)
— a new ScheduleTimeout for a later H/R/S replaces the pending timer.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Optional

from ..libs.service import Service


@dataclass(frozen=True)
class TimeoutInfo:
    duration: float  # seconds; may be <= 0 (fire immediately)
    height: int
    round: int
    step: int


class TimeoutTicker(Service):
    def __init__(self):
        super().__init__("timeout-ticker")
        self.tock: asyncio.Queue = asyncio.Queue(maxsize=10)
        self._timer_task: Optional[asyncio.Task] = None
        self._current: Optional[TimeoutInfo] = None

    async def on_stop(self) -> None:
        timer = self._timer_task
        self._stop_timer()
        if timer is not None:
            # reap the cancelled timer so it cannot outlive the service
            try:
                await timer
            except asyncio.CancelledError:
                pass

    def chan(self) -> asyncio.Queue:
        return self.tock

    def _stop_timer(self) -> None:
        if self._timer_task is not None and not self._timer_task.done():
            self._timer_task.cancel()
        self._timer_task = None

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        """Replace the pending timer iff ti is for a later H/R/S
        (ticker.go:94 timeoutRoutine semantics)."""
        if self._stopped:
            return  # a timer scheduled on a dead ticker would leak
        cur = self._current
        if cur is not None and self._timer_task is not None and not self._timer_task.done():
            if (ti.height, ti.round, ti.step) <= (cur.height, cur.round, cur.step):
                return
        self._stop_timer()
        self._current = ti
        self._timer_task = asyncio.get_event_loop().create_task(self._fire_after(ti))

    async def _fire_after(self, ti: TimeoutInfo) -> None:
        if ti.duration > 0:
            await asyncio.sleep(ti.duration)
        try:
            self.tock.put_nowait(ti)
        except asyncio.QueueFull:
            pass


class MockTicker:
    """Test ticker that fires only when manually pumped — the reference's
    mockTicker (consensus/common_test.go) lets tests drive rounds
    deterministically."""

    def __init__(self):
        self.tock: asyncio.Queue = asyncio.Queue()
        self.scheduled = []
        self.fire_on_schedule = {1}  # steps that auto-fire (NewHeight)

    async def start(self):
        pass

    async def stop(self):
        pass

    def chan(self) -> asyncio.Queue:
        return self.tock

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        self.scheduled.append(ti)
        if ti.step in self.fire_on_schedule:
            self.tock.put_nowait(ti)

    def fire(self, ti: TimeoutInfo) -> None:
        self.tock.put_nowait(ti)
