"""Service lifecycle template (a copy of tendermint_tpu/libs/service.py).

Counterpart of the reference's `service.Service` / `BaseService`
(reference: libs/service/service.go): one Start/Stop/Quit lifecycle where
`on_start` may spawn asyncio tasks that are tracked and cancelled on stop.
The scheduler profiler's wrapping of spawned tasks (libs/loopprof.py in the
JAX package) is not part of the port.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Coroutine, Optional


class AlreadyStartedError(RuntimeError):
    pass


class AlreadyStoppedError(RuntimeError):
    pass


class Service:
    """Start/Stop/Quit lifecycle with on_start/on_stop template methods.

    Mirrors the reference BaseService (libs/service/service.go:99): Start
    is idempotent-error (starting twice raises), Stop cancels spawned
    tasks and fires `wait_stopped`.
    """

    def __init__(self, name: str = ""):
        self._name = name or type(self).__name__
        self._started = False
        self._stopped = False
        self._quit: Optional[asyncio.Event] = None
        self._tasks: list[asyncio.Task] = []
        self.logger = logging.getLogger(self._name)

    # -- template methods -------------------------------------------------
    async def on_start(self) -> None:  # override
        pass

    async def on_stop(self) -> None:  # override
        pass

    # -- lifecycle ---------------------------------------------------------
    @property
    def name(self) -> str:
        return self._name

    @property
    def is_running(self) -> bool:
        return self._started and not self._stopped

    async def start(self) -> None:
        if self._started:
            raise AlreadyStartedError(self._name)
        if self._stopped:
            raise AlreadyStoppedError(self._name)
        self._quit = asyncio.Event()
        self._started = True
        self.logger.debug("service starting")
        await self.on_start()

    # Stop must terminate even if a task or an on_stop override misbehaves:
    # a wedged child must never deadlock the whole shutdown tree.
    STOP_TIMEOUT = 10.0

    async def stop(self) -> None:
        if self._stopped:
            # a concurrent stop is (or was) in flight: wait for it, so that
            # "await svc.stop()" means the service really finished
            await self.wait_stopped()
            return
        self._stopped = True
        self.logger.debug("service stopping")
        try:
            await asyncio.wait_for(self.on_stop(), self.STOP_TIMEOUT)
        except asyncio.TimeoutError:
            self.logger.error("on_stop timed out after %.0fs; forcing", self.STOP_TIMEOUT)
        finally:
            # never cancel or await the task this stop() runs inside (a
            # service stopping itself from one of its own tasks)
            current = asyncio.current_task()
            others = [t for t in self._tasks if t is not current]
            for t in others:
                t.cancel()
            if others:
                # one collective bounded wait (asyncio.wait, not per-task
                # wait_for, whose timeout path can wait without bound on a
                # task that refuses its cancel); stragglers are abandoned
                try:
                    await asyncio.wait(others, timeout=self.STOP_TIMEOUT)
                except Exception:
                    pass
            self._tasks.clear()
            if self._quit is not None:
                self._quit.set()

    def spawn(self, coro: Coroutine, name: str = "") -> asyncio.Task:
        """Spawn a task owned by this service; cancelled on stop.  Called
        from the service's own coroutines, so a loop is running."""
        task = asyncio.get_running_loop().create_task(coro, name=name or self._name)
        if self._stopped:
            # stop already ran (or is running) its cancel pass: a task
            # spawned now would never be cancelled and would outlive it
            task.cancel()
            return task
        self._tasks.append(task)
        task.add_done_callback(self._on_task_done)
        return task

    def _on_task_done(self, task: asyncio.Task) -> None:
        try:
            self._tasks.remove(task)
        except ValueError:
            pass
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None and not self._stopped:
            self.logger.error("task %s crashed: %r", task.get_name(), exc, exc_info=exc)

    async def wait_stopped(self) -> None:
        if self._quit is not None:
            await self._quit.wait()


async def wait_event(event: asyncio.Event, timeout: float) -> bool:
    """Wait for an Event with a timeout; True iff the event fired.

    asyncio.wait, not wait_for: a cancellation landing in the same tick the
    event completes must not be swallowed.  The waiter task is cancelled on
    every exit path, including the caller's own cancellation, so no
    orphaned `Event.wait` task leaks.  Callers clear the event themselves."""
    waiter = asyncio.ensure_future(event.wait())
    try:
        done, _ = await asyncio.wait({waiter}, timeout=timeout)
        return bool(done)
    finally:
        if not waiter.done():
            waiter.cancel()
