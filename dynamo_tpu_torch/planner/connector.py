"""Scaling connectors (ref: components/planner/src/dynamo/planner/
virtual_connector.py:316, kubernetes_connector.py).

``VirtualConnector`` records target replica counts in the store — an
orchestrator (test harness, launch script, or the k8s operator equivalent)
watches ``planner/{namespace}/target`` and realises them. This is the same
decoupling the reference uses to test the planner without a cluster.

Decision IDs are persisted in the store (``planner/{ns}/state``) so they
stay monotonic across planner restarts, and a ``scale()`` to an unchanged
target is a no-op — the orchestrator never sees a redundant revision for
intent it already realised.

A copy of ``dynamo_tpu.planner.connector``; events go out through the
port's own codec (``runtime/codec.py``), byte-equal to ``msgpack``.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

from ..runtime import codec

# planner transitions (scaling decisions, degradation ladder moves) are
# broadcast here so the metrics aggregator can expose them as gauges
PLANNER_EVENTS_SUBJECT = "planner_events"


def planner_events_subject(namespace: str) -> str:
    return f"v1/events/{namespace}/planner/{PLANNER_EVENTS_SUBJECT}/"


class VirtualConnector:
    """Store-backed scaling intent; no processes are touched."""

    def __init__(self, store, namespace: str = "dynamo"):
        self.store = store
        self.namespace = namespace
        self.decision_count = 0
        self._loaded = False
        self._last: Dict[str, int] = {}
        self._last_degradation: Optional[dict] = None

    def _key(self, component: str) -> str:
        return f"planner/{self.namespace}/target/{component}"

    @property
    def _state_key(self) -> str:
        return f"planner/{self.namespace}/state"

    @property
    def _degradation_key(self) -> str:
        return f"planner/{self.namespace}/degradation"

    async def _ensure_loaded(self) -> None:
        """Restore decision_count + last targets from a previous planner
        incarnation so IDs stay monotonic and unchanged targets are not
        re-put after a restart."""
        if self._loaded:
            return
        raw = await self.store.get(self._state_key)
        if raw is not None:
            state = json.loads(raw)
            self.decision_count = max(
                self.decision_count, int(state.get("decision_count", 0))
            )
        targets = await self.store.get_prefix(
            f"planner/{self.namespace}/target/"
        )
        for key, value in targets:
            component = key.rsplit("/", 1)[-1]
            try:
                self._last[component] = int(json.loads(value)["replicas"])
            except Exception:
                pass
        self._loaded = True

    async def scale(self, component: str, replicas: int) -> None:
        await self._ensure_loaded()
        replicas = int(replicas)
        if self._last.get(component) == replicas:
            return  # intent already recorded — don't burn a decision ID
        self.decision_count += 1
        await self.store.put(self._key(component), json.dumps({
            "replicas": replicas,
            "ts": time.time(),
            "decision": self.decision_count,
        }).encode())
        await self.store.put(self._state_key, json.dumps({
            "decision_count": self.decision_count,
        }).encode())
        self._last[component] = replicas

    async def read_target(self, component: str) -> Optional[int]:
        raw = await self.store.get(self._key(component))
        if raw is None:
            return None
        return int(json.loads(raw)["replicas"])

    # -------------------- degradation ladder intent ---------------------

    async def set_degradation(self, actions: dict) -> None:
        """Publish the ladder's current orders (level + knob clamps) for
        frontends/workers to apply; unchanged orders are not re-put."""
        if actions == self._last_degradation:
            return
        payload = dict(actions)
        payload["ts"] = time.time()
        await self.store.put(
            self._degradation_key, json.dumps(payload).encode()
        )
        self._last_degradation = dict(actions)

    async def read_degradation(self) -> Optional[dict]:
        raw = await self.store.get(self._degradation_key)
        return None if raw is None else json.loads(raw)

    # ------------------------- event broadcast --------------------------

    async def publish_event(self, event: dict) -> None:
        """Best-effort broadcast of a planner transition (scale decision or
        ladder move) for the aggregator's gauges."""
        try:
            await self.store.publish(
                planner_events_subject(self.namespace),
                codec.packb(event),
            )
        except Exception:
            pass  # observability must never block control


class CallbackConnector:
    """In-process connector for unit tests: records scale() calls."""

    def __init__(self):
        self.calls: list = []
        self.targets: Dict[str, int] = {}
        self.degradations: list = []
        self.events: list = []

    async def scale(self, component: str, replicas: int) -> None:
        self.calls.append((component, int(replicas)))
        self.targets[component] = int(replicas)

    async def set_degradation(self, actions: dict) -> None:
        self.degradations.append(dict(actions))

    async def publish_event(self, event: dict) -> None:
        self.events.append(dict(event))
