"""Unified SIGINT/SIGTERM shutdown wiring.

Every long-running entrypoint (engine worker, frontend, metrics
aggregator) needs the same three behaviors from its signal handlers:

- the **first** signal triggers exactly one graceful shutdown, no matter
  how many delivery paths exist (two signals registered, plus programmatic
  triggers like ``POST /drain``);
- a **second** signal while the drain is already running means the
  operator wants out *now* — hard-exit immediately instead of waiting on
  an in-flight drain that may be wedged;
- programmatic re-triggers (a second ``POST /drain``) are idempotent
  no-ops, never a hard exit.

``install_shutdown_signals`` returns the :class:`ShutdownGuard` so callers
can share the same once-latch with non-signal triggers. A copy of
``dynamo_tpu.runtime.signals``.
"""

from __future__ import annotations

import asyncio
import os
import signal as _signal
from typing import Callable, Iterable, Optional

from ..utils.logging import get_logger

log = get_logger("runtime.signals")

DEFAULT_SIGNALS = (_signal.SIGINT, _signal.SIGTERM)


class ShutdownGuard:
    """Once-latch around a shutdown callback.

    ``trigger()`` is the programmatic entry (idempotent); the installed
    signal handler escalates a repeat signal to ``hard_exit(1)``.
    """

    def __init__(
        self,
        on_shutdown: Callable[[], None],
        *,
        name: str = "shutdown",
        hard_exit: Callable[[int], None] = os._exit,
    ):
        self._on_shutdown = on_shutdown
        self._name = name
        self._hard_exit = hard_exit
        self._fired = False

    @property
    def fired(self) -> bool:
        return self._fired

    def trigger(self) -> bool:
        """Fire the shutdown callback once; repeat calls are no-ops.
        Returns True if this call fired it."""
        if self._fired:
            return False
        self._fired = True
        self._on_shutdown()
        return True

    def on_signal(self) -> None:
        """Signal-delivery entry: first signal triggers the shutdown,
        a second one hard-exits (the drain is taking too long or is
        wedged and the operator pressed ^C again)."""
        if self._fired:
            log.warning("%s: repeated signal during shutdown — hard exit",
                        self._name)
            self._hard_exit(1)
            return
        log.info("%s: signal received — shutting down", self._name)
        self.trigger()


def install_shutdown_signals(
    on_shutdown: Callable[[], None],
    *,
    loop: Optional[asyncio.AbstractEventLoop] = None,
    name: str = "shutdown",
    signals: Iterable[int] = DEFAULT_SIGNALS,
    hard_exit: Callable[[int], None] = os._exit,
) -> ShutdownGuard:
    """Register ``on_shutdown`` behind a :class:`ShutdownGuard` on
    ``loop`` for each signal in ``signals`` and return the guard."""
    guard = ShutdownGuard(on_shutdown, name=name, hard_exit=hard_exit)
    loop = loop or asyncio.get_running_loop()
    for sig in signals:
        loop.add_signal_handler(sig, guard.on_signal)
    return guard
