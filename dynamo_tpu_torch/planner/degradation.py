"""Graceful-degradation ladder: cheap relief the planner orders BEFORE
spending chips (ref: the overload-ladder pattern of *Taming the Chaos* —
shed, then cheapen, then scale).

The ladder is an ordered list of reversible steps:

    1. ``evict_to_host``     — demote LRU subtrees of sealed, idle prefix
                               blocks from G1 HBM to the KVBM host pool
                               (prefix.manager ``evict_to_host``): frees
                               device pages for running work while keeping
                               the prefixes onboardable, so it engages
                               BEFORE any request is turned away
    2. ``shed_low_tier``     — admission sheds requests below ``shed_tier``
                               (PR-1 admission controller, tier-aware)
    3. ``clamp_spec_k``      — cap speculative draft length (verify windows
                               stop amplifying decode latency under load)
    4. ``tighten_chunking``  — cap ``prefill_chunk_tokens`` so long prompts
                               stop stalling running decodes

Pressure is the worst SLO overshoot ratio observed in the last window
(``max(ttft_p99/ttft_sla, itl_p99/itl_sla)``). Each window the ladder moves
at most ONE step: engage the next step while pressure ≥ ``engage_ratio``,
release the most recent step once pressure ≤ ``release_ratio`` — strictly
reverse order, with hysteresis between the two thresholds so the ladder
never flaps. Every transition is emitted as a trace span (name
``planner.degradation``), and the aggregator mirrors the level as the
``planner_degradation_level`` gauge via the planner-events subject.

A copy of ``dynamo_tpu.planner.degradation``: the ladder, its store order
(``planner/{ns}/degradation``, JSON) and the watcher that workers and
frontends run, so a JAX planner's orders steer port processes and the other
way round. The planner core (:mod:`.core`) drives the ladder.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from .. import tracing
from ..utils.logging import get_logger

log = get_logger("planner.degradation")

# engagement order; released strictly in reverse
STEPS: Tuple[str, ...] = (
    "evict_to_host", "shed_low_tier", "clamp_spec_k", "tighten_chunking",
)


@dataclass
class DegradationConfig:
    engage_ratio: float = 1.5     # pressure at/above which the next step engages
    release_ratio: float = 1.0    # pressure at/below which the last step releases
    shed_tier: int = 1            # min admitted tier while shed_low_tier holds
    spec_k_clamp: int = 1         # spec_k ceiling while clamp_spec_k holds
    chunk_clamp_tokens: int = 256  # prefill_chunk_tokens ceiling while held
    # G1 blocks each worker demotes to its host pool per window while the
    # evict_to_host rung holds
    evict_to_host_blocks: int = 64


class DegradationLadder:
    """Ordered engage/release state machine over :data:`STEPS`."""

    def __init__(self, config: Optional[DegradationConfig] = None):
        self.config = config or DegradationConfig()
        self.level = 0  # number of engaged steps, 0..len(STEPS)
        self.transitions: List[Tuple[str, str]] = []  # (direction, step)

    @property
    def engaged(self) -> Tuple[str, ...]:
        return STEPS[: self.level]

    def update(self, pressure: float) -> Optional[Tuple[str, str]]:
        """Advance at most one step for this window's pressure; returns the
        transition ``(direction, step)`` or None."""
        cfg = self.config
        if pressure >= cfg.engage_ratio and self.level < len(STEPS):
            step = STEPS[self.level]
            self.level += 1
            return self._record("engage", step, pressure)
        if pressure <= cfg.release_ratio and self.level > 0:
            self.level -= 1
            step = STEPS[self.level]
            return self._record("release", step, pressure)
        return None

    def _record(self, direction: str, step: str,
                pressure: float) -> Tuple[str, str]:
        self.transitions.append((direction, step))
        log.info("degradation %s %s (level=%d pressure=%.2f)",
                 direction, step, self.level, pressure)
        span = tracing.get_tracer().start_span(
            "planner.degradation", root=True,
            attrs={"step": step, "direction": direction,
                   "level": self.level, "pressure": round(pressure, 3)},
        )
        span.end()
        return direction, step

    def actions(self) -> dict:
        """Current knob orders for frontends/workers (the store payload)."""
        cfg = self.config
        engaged = self.engaged
        return {
            "level": self.level,
            "steps": list(engaged),
            "evict_to_host": (cfg.evict_to_host_blocks
                              if "evict_to_host" in engaged else 0),
            "min_tier": cfg.shed_tier if "shed_low_tier" in engaged else 0,
            "spec_k_max": (cfg.spec_k_clamp
                           if "clamp_spec_k" in engaged else None),
            "prefill_chunk_tokens_max": (
                cfg.chunk_clamp_tokens
                if "tighten_chunking" in engaged else None),
        }


NO_DEGRADATION = {
    "level": 0, "steps": [], "evict_to_host": 0, "min_tier": 0,
    "spec_k_max": None, "prefill_chunk_tokens_max": None,
}


def apply_engine_clamps(eng_cfg, actions: dict, originals: dict) -> dict:
    """Clamp a live EngineConfig per the ladder's orders, restoring the
    original values when a step releases. ``originals`` persists the
    pre-clamp values across calls (pass the same dict every time); returns
    the fields changed this call."""
    changed = {}
    for field, key in (("spec_k", "spec_k_max"),
                       ("prefill_chunk_tokens", "prefill_chunk_tokens_max")):
        if not hasattr(eng_cfg, field):
            continue
        cap = actions.get(key)
        current = getattr(eng_cfg, field)
        if cap is not None:
            originals.setdefault(field, current)
            # chunking: 0 means "whole-bucket prefill" — tightening must
            # impose the cap, not min(0, cap)
            if field == "prefill_chunk_tokens" and current == 0:
                clamped = int(cap)
            else:
                clamped = min(int(current), int(cap))
            if clamped != current:
                setattr(eng_cfg, field, clamped)
                changed[field] = clamped
        elif field in originals:
            orig = originals.pop(field)
            if orig != current:
                setattr(eng_cfg, field, orig)
                changed[field] = orig
    return changed


class DegradationWatcher:
    """Polls ``planner/{ns}/degradation`` and invokes ``on_change(actions)``
    whenever the ladder's orders move. Poll-based (like scale_watcher) so a
    store flap degrades to staleness, never to a crash."""

    def __init__(self, store, namespace: str,
                 on_change: Callable[[dict], None],
                 poll_s: float = 1.0):
        self.store = store
        self.namespace = namespace
        self.on_change = on_change
        self.poll_s = poll_s
        self._task: Optional[asyncio.Task] = None
        self._last: Optional[dict] = None

    @property
    def key(self) -> str:
        return f"planner/{self.namespace}/degradation"

    async def poll_once(self) -> Optional[dict]:
        raw = await self.store.get(self.key)
        actions = dict(NO_DEGRADATION) if raw is None else json.loads(raw)
        comparable = {k: v for k, v in actions.items() if k != "ts"}
        if comparable != self._last:
            self._last = comparable
            try:
                self.on_change(comparable)
            except Exception:
                log.exception("degradation on_change failed")
        return comparable

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            try:
                await self.poll_once()
            except Exception as exc:
                log.warning("degradation poll failed: %s", exc)
            await asyncio.sleep(self.poll_s)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
