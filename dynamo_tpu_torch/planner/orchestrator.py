"""Orchestrator: realise the planner's scaling intent against a live
deployment (ref: the operator role of kube.rs + DynaServe's unified P/D
role reassignment).

Watches ``planner/{ns}/target/{component}`` (poll-based, like
deploy/scripts/scale_watcher.py — a store flap degrades to staleness, not a
crash) and reconciles the worker pool toward it. Capacity moves are
realised cheapest-first:

1. **Role flips** — when one role is over target and the other under, a
   worker is flipped instead of paying a stop + cold spawn: the pool drains
   the worker's current endpoint (deregister → in-flight join → stragglers
   stopped so Migration carries them to a peer with byte-exact token
   parity) and re-serves the same process under the other component.
2. **Spawns / stops** — the remaining deltas, clamped to the chip budget.

The pool is anything implementing the small ``WorkerPool`` surface below:
the simulated cluster (mocker/cluster.py) in tests, a process-spawning pool
in deployments.

A copy of ``dynamo_tpu.planner.orchestrator``.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol

from .. import tracing
from ..utils.logging import get_logger

log = get_logger("planner.orchestrator")


class WorkerPool(Protocol):
    """What the orchestrator needs from a deployment."""

    def workers(self, component: str) -> List[int]:
        """Live worker ids currently serving ``component``."""
        ...

    async def spawn(self, component: str) -> int:
        """Start a new worker on ``component``; returns its id."""
        ...

    async def stop(self, worker_id: int) -> None:
        """Gracefully drain + stop a worker (in-flight streams migrate)."""
        ...

    async def flip(self, worker_id: int, component: str) -> None:
        """Drain a worker off its current component and re-serve it on
        ``component`` — same process, zero dropped streams."""
        ...


@dataclass
class OrchestratorStats:
    num_flips: int = 0
    num_spawns: int = 0
    num_stops: int = 0
    num_cycles: int = 0


class Orchestrator:
    def __init__(
        self,
        store,
        pool: WorkerPool,
        namespace: str = "dynamo",
        prefill_component: str = "prefill",
        decode_component: str = "backend",
        poll_s: float = 0.5,
        max_chip_budget: Optional[int] = None,
        flip_enabled: bool = True,
    ):
        self.store = store
        self.pool = pool
        self.namespace = namespace
        self.prefill_component = prefill_component
        self.decode_component = decode_component
        self.poll_s = poll_s
        self.max_chip_budget = max_chip_budget
        self.flip_enabled = flip_enabled
        self.stats = OrchestratorStats()
        self._task: Optional[asyncio.Task] = None
        self._lock = asyncio.Lock()

    # --------------------------- intent --------------------------------

    def _target_key(self, component: str) -> str:
        return f"planner/{self.namespace}/target/{component}"

    async def read_target(self, component: str) -> Optional[int]:
        raw = await self.store.get(self._target_key(component))
        if raw is None:
            return None
        try:
            return int(json.loads(raw)["replicas"])
        except Exception:
            log.warning("malformed target for %s: %r", component, raw)
            return None

    # ------------------------- reconciliation ---------------------------

    async def reconcile(self) -> Dict[str, int]:
        """One convergence step toward the recorded targets. Returns the
        realised move counts (all zero when already converged)."""
        async with self._lock:
            return await self._reconcile_locked()

    async def _reconcile_locked(self) -> Dict[str, int]:
        moves = {"flips": 0, "spawns": 0, "stops": 0}
        p_comp, d_comp = self.prefill_component, self.decode_component
        targets = {}
        for comp in (p_comp, d_comp):
            t = await self.read_target(comp)
            if t is not None:
                targets[comp] = max(0, t)
        if not targets:
            return moves
        if self.max_chip_budget is not None:
            total = sum(targets.values())
            if total > self.max_chip_budget:
                # defensive re-clamp: a malformed/stale record must not
                # make the orchestrator exceed the budget the planner holds
                scale = self.max_chip_budget / total
                targets = {c: max(1, int(t * scale))
                           for c, t in targets.items()}

        deltas = {c: t - len(self.pool.workers(c))
                  for c, t in targets.items()}
        self.stats.num_cycles += 1

        # capacity moves between roles are flips, not stop+spawn
        if self.flip_enabled and p_comp in deltas and d_comp in deltas:
            for need, donor in ((p_comp, d_comp), (d_comp, p_comp)):
                while deltas.get(need, 0) > 0 and deltas.get(donor, 0) < 0:
                    candidates = self.pool.workers(donor)
                    if not candidates:
                        break
                    wid = candidates[-1]  # newest first: oldest keep their role
                    await self._flip(wid, donor, need)
                    deltas[need] -= 1
                    deltas[donor] += 1
                    moves["flips"] += 1

        for comp, delta in deltas.items():
            while delta > 0:
                await self._spawn(comp)
                delta -= 1
                moves["spawns"] += 1
            while delta < 0:
                candidates = self.pool.workers(comp)
                if not candidates:
                    break
                await self._stop(candidates[-1], comp)
                delta += 1
                moves["stops"] += 1
        return moves

    async def _flip(self, wid: int, donor: str, need: str) -> None:
        span = tracing.get_tracer().start_span(
            "orchestrator.flip", root=True,
            attrs={"worker": wid, "from": donor, "to": need},
        )
        try:
            log.info("flipping worker %d: %s -> %s", wid, donor, need)
            await self.pool.flip(wid, need)
            self.stats.num_flips += 1
        except Exception:
            span.set_status("error", "flip_failed")
            raise
        finally:
            span.end()

    async def _spawn(self, comp: str) -> None:
        span = tracing.get_tracer().start_span(
            "orchestrator.spawn", root=True, attrs={"component": comp},
        )
        try:
            wid = await self.pool.spawn(comp)
            log.info("spawned worker %d on %s", wid, comp)
            self.stats.num_spawns += 1
        except Exception:
            span.set_status("error", "spawn_failed")
            raise
        finally:
            span.end()

    async def _stop(self, wid: int, comp: str) -> None:
        span = tracing.get_tracer().start_span(
            "orchestrator.stop", root=True,
            attrs={"worker": wid, "component": comp},
        )
        try:
            log.info("stopping worker %d on %s", wid, comp)
            await self.pool.stop(wid)
            self.stats.num_stops += 1
        except Exception:
            span.set_status("error", "stop_failed")
            raise
        finally:
            span.end()

    # --------------------------- lifecycle ------------------------------

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            try:
                await self.reconcile()
            except Exception:
                # a failed move (worker died mid-flip, store blip) retries
                # next cycle against fresh pool state
                log.exception("reconcile failed — retrying next cycle")
            await asyncio.sleep(self.poll_s)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
