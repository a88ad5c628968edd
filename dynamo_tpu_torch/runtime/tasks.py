"""Detached asyncio tasks that are neither lost nor silent: ``spawn_logged``
of ``dynamo_tpu.runtime.tasks`` (its ``TaskTracker`` tree waits for the
subsystems that spawn through it)."""

from __future__ import annotations

import asyncio
from typing import Awaitable, Set

from ..utils.logging import get_logger

log = get_logger("tasks")

# strong refs for spawn_logged: asyncio.create_task only keeps a weak ref,
# so an unreferenced task can be garbage-collected mid-flight
_detached_tasks: Set["asyncio.Task"] = set()


def spawn_logged(coro: Awaitable, *, name: str) -> "asyncio.Task":
    """Fire-and-forget done right: the task handle is retained until the
    task settles and any non-cancellation exception hits the log instead
    of evaporating as "Task exception was never retrieved"."""
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
