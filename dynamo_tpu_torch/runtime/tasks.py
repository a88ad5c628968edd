"""Detached asyncio tasks that are neither lost nor silent, and the
hierarchical task tracker: port of ``dynamo_tpu.runtime.tasks`` (ref:
lib/runtime/src/utils/tasks/tracker.rs — pluggable schedulers,
OnErrorPolicy, retries, cascading cancellation, metrics). Pure asyncio, so
a copy.

Trackers form a tree: a child shares (or overrides) the parent's scheduler
and error policy, and cancelling a parent cascades to every descendant.
Background loops spawn through a tracker so one ``cancel()``/``join()``
tears down a whole subsystem and failures are counted and policed instead
of vanishing into "task exception was never retrieved". As in the JAX
package, no serving path spawns through one yet."""

from __future__ import annotations

import asyncio
import enum
from dataclasses import dataclass
from typing import Awaitable, Callable, List, Optional, Set

from ..utils.logging import get_logger

log = get_logger("tasks")

# strong refs for spawn_logged: asyncio.create_task only keeps a weak ref,
# so an unreferenced task can be garbage-collected mid-flight (DT302)
_detached_tasks: Set["asyncio.Task"] = set()


def spawn_logged(coro: Awaitable, *, name: str) -> "asyncio.Task":
    """Fire-and-forget done right: the task handle is retained until the
    task settles and any non-cancellation exception hits the log instead
    of evaporating as "Task exception was never retrieved".

    For background *loops* with retry/cancellation policy use a
    :class:`TaskTracker`; this is for one-shot detached work (signal-
    triggered shutdowns, health withdraw/readvertise probes)."""
    task = asyncio.ensure_future(coro)
    task.set_name(name)
    _detached_tasks.add(task)

    def _done(t: "asyncio.Task") -> None:
        _detached_tasks.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            log.error("detached task %s failed: %r", name, exc,
                      exc_info=exc)

    task.add_done_callback(_done)
    return task


class OnError(enum.Enum):
    """What a failed task does to its tracker (ref: tracker.rs OnErrorPolicy)."""

    LOG = "log"            # count it, log it, keep going
    SHUTDOWN = "shutdown"  # cancel the whole tracker tree
    RETRY = "retry"        # re-run with backoff up to max_retries, then LOG


@dataclass
class RetryPolicy:
    max_retries: int = 3
    backoff_s: float = 0.1
    backoff_factor: float = 2.0


class Scheduler:
    """Admission control for task starts."""

    async def acquire(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def release(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class UnlimitedScheduler(Scheduler):
    async def acquire(self) -> None:
        return

    def release(self) -> None:
        return


class SemaphoreScheduler(Scheduler):
    """At most ``n`` tracked tasks run concurrently."""

    def __init__(self, n: int):
        self._sem = asyncio.Semaphore(n)

    async def acquire(self) -> None:
        await self._sem.acquire()

    def release(self) -> None:
        self._sem.release()


@dataclass
class TrackerStats:
    spawned: int = 0
    succeeded: int = 0
    failed: int = 0
    retried: int = 0
    cancelled: int = 0


class TaskTracker:
    def __init__(
        self,
        name: str = "root",
        scheduler: Optional[Scheduler] = None,
        on_error: OnError = OnError.LOG,
        retry: Optional[RetryPolicy] = None,
        error_handler: Optional[Callable[[str, BaseException], None]] = None,
    ):
        self.name = name
        self.scheduler = scheduler or UnlimitedScheduler()
        self.on_error = on_error
        self.retry = retry or RetryPolicy()
        self.error_handler = error_handler
        self.stats = TrackerStats()
        self._tasks: Set[asyncio.Task] = set()
        self._children: List["TaskTracker"] = []
        self._cancelled = False

    # ---------------------------- tree ---------------------------------

    def child(self, name: str, **overrides) -> "TaskTracker":
        """Sub-tracker inheriting scheduler/policy unless overridden."""
        c = TaskTracker(
            name=f"{self.name}/{name}",
            scheduler=overrides.get("scheduler", self.scheduler),
            on_error=overrides.get("on_error", self.on_error),
            retry=overrides.get("retry", self.retry),
            error_handler=overrides.get("error_handler", self.error_handler),
        )
        self._children.append(c)
        return c

    # --------------------------- spawning ------------------------------

    def spawn(
        self,
        fn: Callable[[], Awaitable],
        name: Optional[str] = None,
    ) -> asyncio.Task:
        """Run ``fn`` under the tracker's scheduler and error policy.
        ``fn`` is a zero-arg coroutine *factory* so RETRY can re-invoke it."""
        if self._cancelled:
            raise RuntimeError(f"tracker {self.name} is cancelled")
        self.stats.spawned += 1
        task = asyncio.create_task(
            self._run(fn), name=name or f"{self.name}:{self.stats.spawned}"
        )
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def _run(self, fn: Callable[[], Awaitable]):
        await self.scheduler.acquire()
        try:
            attempt = 0
            while True:
                try:
                    result = await fn()
                    self.stats.succeeded += 1
                    return result
                except asyncio.CancelledError:
                    self.stats.cancelled += 1
                    raise
                except BaseException as e:
                    if (self.on_error is OnError.RETRY
                            and attempt < self.retry.max_retries):
                        self.stats.retried += 1
                        delay = (self.retry.backoff_s
                                 * self.retry.backoff_factor ** attempt)
                        attempt += 1
                        log.warning("task in %s failed (attempt %d/%d): %r",
                                    self.name, attempt,
                                    self.retry.max_retries, e)
                        await asyncio.sleep(delay)
                        continue
                    self.stats.failed += 1
                    if self.error_handler is not None:
                        try:
                            self.error_handler(self.name, e)
                        except Exception:
                            log.exception("error handler raised")
                    if self.on_error is OnError.SHUTDOWN:
                        log.error("task failure shuts down tracker %s: %r",
                                  self.name, e)
                        self.cancel()
                        return None
                    log.exception("task in %s failed", self.name)
                    return None
        finally:
            self.scheduler.release()

    # --------------------------- lifecycle -----------------------------

    @property
    def active(self) -> int:
        return len(self._tasks) + sum(c.active for c in self._children)

    def cancel(self) -> None:
        """Cascade-cancel this tracker and every descendant."""
        self._cancelled = True
        for t in list(self._tasks):
            t.cancel()
        for c in self._children:
            c.cancel()

    async def join(self) -> None:
        """Wait for all tasks (and children's tasks) to settle."""
        while True:
            pending = list(self._tasks)
            for c in self._children:
                pending.extend(c._tasks)
            if not pending:
                return
            await asyncio.gather(*pending, return_exceptions=True)
