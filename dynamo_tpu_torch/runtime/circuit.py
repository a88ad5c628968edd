"""Per-worker circuit breakers: fail fast instead of retrying into a corpse.

Classic three-state breaker (ref: the failure-isolation layer P/D-Serve and
DynaServe both report as load-bearing at scale — see PAPERS.md):

- **closed** — traffic flows; consecutive transport failures count up.
- **open** — ``failure_threshold`` consecutive failures (or an explicit
  ``trip()`` from a health-check flip) divert all traffic for
  ``open_timeout_s``.
- **half-open** — after the timeout, up to ``half_open_probes`` in-flight
  probe requests are let through; one success closes the breaker, one
  failure re-opens it with a fresh timeout.

The router consults :meth:`CircuitBreaker.allow` when filtering candidate
workers (non-mutating), then calls :meth:`begin` for the worker it actually
selected so half-open probe slots are only consumed by real attempts.
The clock is injectable for deterministic tests.

A copy of ``dynamo_tpu.runtime.circuit``, with the same defaults (3
failures, 5 s open, 1 probe); the KV router's breaker filter uses it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..utils.logging import get_logger

log = get_logger("circuit")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclass
class BreakerConfig:
    failure_threshold: int = 3    # consecutive failures → open
    open_timeout_s: float = 5.0   # open → half-open probation delay
    half_open_probes: int = 1     # concurrent probes allowed in half-open


class CircuitBreaker:
    def __init__(self, config: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or BreakerConfig()
        self._clock = clock
        self._state = CLOSED
        self._failures = 0           # consecutive, while closed
        self._opened_at = 0.0
        self._probes_inflight = 0
        self.num_trips = 0

    @property
    def state(self) -> str:
        """Current state; resolves open → half-open once the timeout passed."""
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.config.open_timeout_s):
            self._state = HALF_OPEN
            self._probes_inflight = 0
        return self._state

    def allow(self) -> bool:
        """May a request be routed here? Non-mutating (no probe reserved)."""
        state = self.state
        if state == CLOSED:
            return True
        if state == HALF_OPEN:
            return self._probes_inflight < self.config.half_open_probes
        return False

    def begin(self) -> None:
        """An attempt was actually dispatched; reserves a half-open probe."""
        if self.state == HALF_OPEN:
            self._probes_inflight += 1

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            log.info("breaker half-open probe succeeded — closing")
        self._state = CLOSED
        self._failures = 0
        self._probes_inflight = 0

    def record_failure(self) -> None:
        state = self.state
        if state == HALF_OPEN:
            self._trip("half-open probe failed")
            return
        if state == OPEN:
            return
        self._failures += 1
        if self._failures >= self.config.failure_threshold:
            self._trip(f"{self._failures} consecutive failures")

    def trip(self, reason: str = "external") -> None:
        """Force open (health-check flip, manual quarantine)."""
        self._trip(reason)

    def _trip(self, reason: str) -> None:
        self._state = OPEN
        self._opened_at = self._clock()
        self._failures = 0
        self._probes_inflight = 0
        self.num_trips += 1
        log.warning("circuit OPEN (%s) for %.1fs", reason,
                    self.config.open_timeout_s)


class CircuitBreakerRegistry:
    """Breaker per worker id, minted on first touch. Fed by transport error
    codes (router side) and health-check flips (``trip``/``reset``)."""

    def __init__(self, config: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or BreakerConfig()
        self._clock = clock
        self._breakers: Dict[int, CircuitBreaker] = {}

    def breaker(self, worker_id: int) -> CircuitBreaker:
        b = self._breakers.get(worker_id)
        if b is None:
            b = self._breakers[worker_id] = CircuitBreaker(
                self.config, self._clock
            )
        return b

    def allow(self, worker_id: int) -> bool:
        b = self._breakers.get(worker_id)
        return True if b is None else b.allow()

    def begin(self, worker_id: int) -> None:
        self.breaker(worker_id).begin()

    def record_success(self, worker_id: int) -> None:
        b = self._breakers.get(worker_id)
        if b is not None:
            b.record_success()

    def record_failure(self, worker_id: int) -> None:
        self.breaker(worker_id).record_failure()

    def trip(self, worker_id: int, reason: str = "external") -> None:
        self.breaker(worker_id).trip(reason)

    def remove(self, worker_id: int) -> None:
        self._breakers.pop(worker_id, None)

    def states(self) -> Dict[int, str]:
        return {w: b.state for w, b in self._breakers.items()}
