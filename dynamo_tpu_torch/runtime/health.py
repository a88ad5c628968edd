"""Active health checks: canary probes through the real generate path
(ref: lib/runtime/src/health_check.rs:20,44 — per-endpoint
``health_check_payload`` driven by ``DYN_HEALTH_CHECK_*``; here
``DYNTPU_HEALTH_CHECK_*`` via RuntimeConfig).

A passive ``/health`` probe can report healthy while the engine silently
stopped producing tokens; the canary actually exercises the handler. Each
target gets a periodic probe coroutine; consecutive failures past the
threshold flip it unhealthy (visible in the system server and in an optional
``on_unhealthy`` callback — the worker uses that to stop advertising itself
before the lease would expire).

A copy of ``dynamo_tpu.runtime.health``. The canary runs through the
engine's real ``generate`` path, so on a card each probe launches the
paged-attention kernel.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Dict, Optional

from ..utils.logging import get_logger

log = get_logger("health_check")

ProbeFn = Callable[[], Awaitable[None]]   # raises on failure


@dataclass
class HealthCheckConfig:
    period_s: float = 10.0
    timeout_s: float = 5.0
    failure_threshold: int = 3   # consecutive failures → unhealthy


@dataclass
class TargetState:
    healthy: bool = True
    consecutive_failures: int = 0
    probes: int = 0
    last_ok: Optional[float] = None
    last_error: Optional[str] = None


class HealthCheckManager:
    """Runs canary probes for registered targets on a shared schedule."""

    def __init__(self, config: Optional[HealthCheckConfig] = None,
                 on_unhealthy: Optional[Callable[[str], None]] = None,
                 on_recovered: Optional[Callable[[str], None]] = None):
        self.config = config or HealthCheckConfig()
        self.on_unhealthy = on_unhealthy
        # fires on the unhealthy→healthy flip; a router wires these two into
        # its breaker registry (trip / record_success) so canary state and
        # routing agree
        self.on_recovered = on_recovered
        self._targets: Dict[str, ProbeFn] = {}
        self.states: Dict[str, TargetState] = {}
        self._task: Optional[asyncio.Task] = None

    def register(self, name: str, probe: ProbeFn) -> None:
        self._targets[name] = probe
        self.states[name] = TargetState()

    def unregister(self, name: str) -> None:
        self._targets.pop(name, None)
        self.states.pop(name, None)

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    @property
    def healthy(self) -> bool:
        return all(s.healthy for s in self.states.values())

    def status(self, name: str) -> dict:
        """System-server probe payload for one target."""
        s = self.states.get(name)
        if s is None:
            return {"healthy": False, "error": "unknown target"}
        return {
            "healthy": s.healthy,
            "probes": s.probes,
            "consecutive_failures": s.consecutive_failures,
            "last_ok": s.last_ok,
            "last_error": s.last_error,
        }

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.period_s)
            for name, probe in list(self._targets.items()):
                await self._probe_once(name, probe)

    async def _probe_once(self, name: str, probe: ProbeFn) -> None:
        state = self.states.get(name)
        if state is None:
            return
        state.probes += 1
        try:
            await asyncio.wait_for(probe(), self.config.timeout_s)
        except Exception as e:
            state.consecutive_failures += 1
            state.last_error = repr(e)
            log.warning("canary %s failed (%d/%d): %r", name,
                        state.consecutive_failures,
                        self.config.failure_threshold, e)
            if (state.healthy and state.consecutive_failures
                    >= self.config.failure_threshold):
                state.healthy = False
                log.error("target %s is UNHEALTHY", name)
                if self.on_unhealthy is not None:
                    self.on_unhealthy(name)
            return
        state.consecutive_failures = 0
        state.last_ok = time.time()
        if not state.healthy:
            log.info("target %s recovered", name)
            state.healthy = True
            if self.on_recovered is not None:
                self.on_recovered(name)


def engine_canary(engine, payload: Optional[dict] = None) -> ProbeFn:
    """Canary through the real generate path (one greedy token, no cache
    pollution beyond a single trash-able block)."""
    payload = payload or {"token_ids": [1], "max_tokens": 1,
                          "ignore_eos": True}

    async def probe() -> None:
        from .context import Context

        got = False
        async for _ in engine.generate(dict(payload), Context()):
            got = True
            break
        if not got:
            raise RuntimeError("canary produced no output")

    return probe
