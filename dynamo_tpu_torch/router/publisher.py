"""Worker-side publishers: KV events + load metrics
(ref: lib/llm/src/kv_router/publisher.rs:90,483).

The reference relays engine ZMQ events onto NATS; our engine is in-process,
so the publisher is just the engine's ``kv_event_sink`` batching onto the
store's pub/sub. ``WorkerMetricsPublisher`` periodically publishes the
ForwardPassMetrics-equivalent scheduler stats for the metrics aggregator and
busy-threshold routing.

A copy of ``dynamo_tpu.router.publisher`` on the package's own codec. The
load snapshot carries the scheduler stats, what ``extra_fn`` adds, and the
JAX package's ``spec`` (SpecDecodeStats), ``obs`` (flight recorder),
``kvbm`` (host tiers and prefix index), ``preempt`` (the preemption
coordinator) and ``faults`` (fault-plan firings) keys. Block hashes come from this package's
``tokens.py`` (xxh3, as in the JAX package), so the events name the same
hashes as a JAX worker's for the same tokens.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional

from ..runtime import codec
from ..runtime.component import Component
from ..utils.logging import get_logger
from .indexer import RouterEvent
from .kv_router import KV_EVENTS_SUBJECT, LOAD_METRICS_SUBJECT

log = get_logger("kv_publisher")


class KvEventPublisher:
    """Batches engine KV events onto the component's ``kv_events`` subject.

    Wire format: msgpack ``{"worker_id": int, "event": {kind, blocks}}`` —
    one message per engine event batch, preserving order.
    """

    def __init__(self, component: Component, worker_id: int):
        self.component = component
        self.worker_id = worker_id
        self.subject = component.event_subject(KV_EVENTS_SUBJECT)
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self.events_published = 0
        self._pub_failures = 0

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._pump())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def sink(self, event: dict) -> None:
        """Engine-facing callback (``InferenceEngine.kv_event_sink``)."""
        self._queue.put_nowait(event)

    async def _pump(self) -> None:
        store = self.component.runtime.store
        while True:
            events = [await self._queue.get()]
            while True:  # drain: a prefill seals many blocks per step
                try:
                    events.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            try:
                for payload in self._coalesce(events):
                    await store.publish(
                        self.subject + str(self.worker_id),
                        codec.packb(payload),
                    )
                    self.events_published += 1
                self._pub_failures = 0
            except Exception as exc:
                # traceback once per failure streak — a store outage makes
                # every batch fail and repeating it floods the worker log
                if self._pub_failures == 0:
                    log.exception("kv event publish failed")
                else:
                    log.warning("kv event publish still failing (%d in a "
                                "row): %s", self._pub_failures + 1, exc)
                self._pub_failures += 1

    def _coalesce(self, events: List[dict]) -> List[dict]:
        """Merge runs of same-kind events into single wire messages (the
        blocks field is already a list), preserving order across kinds."""
        out: List[dict] = []
        for event in events:
            kind = event.get("kind")
            blocks = tuple(event.get("blocks", ()))
            if kind == "stored":
                # carry the prefix-node digest explicitly: the chained
                # seq_hash IS the path digest (tokens.py), and naming it on
                # the wire lets radix replicas key on it without assuming
                # the pool's internal field layout
                blocks = tuple(
                    {**b, "digest": b["seq_hash"]}
                    if isinstance(b, dict) and "seq_hash" in b else b
                    for b in blocks
                )
            if kind is None:
                log.warning("malformed kv event (no kind): %r", event)
                continue
            if out and out[-1]["event"]["kind"] == kind and kind != "cleared":
                out[-1]["event"]["blocks"].extend(blocks)
            else:
                out.append(RouterEvent(
                    worker_id=self.worker_id, kind=kind, blocks=blocks,
                ).to_dict())
        return out


class WorkerMetricsPublisher:
    """Publishes ForwardPassMetrics-equivalent stats every ``interval_s``
    (ref: publisher.rs:483; protocols.rs:48 ``ForwardPassMetrics``)."""

    def __init__(
        self, component: Component, worker_id: int, stats_fn,
        interval_s: float = 1.0, extra_fn=None, spec_fn=None, obs_fn=None,
        kvbm_fn=None, preempt_fn=None, faults_fn=None,
    ):
        self.component = component
        self.worker_id = worker_id
        self.stats_fn = stats_fn      # () -> SchedulerStats
        self.extra_fn = extra_fn      # () -> dict merged into the snapshot
        self.spec_fn = spec_fn        # () -> SpecDecodeStats dict ("spec" key)
        self.obs_fn = obs_fn          # () -> flight-recorder dict ("obs" key)
        self.kvbm_fn = kvbm_fn        # () -> host-tier dict ("kvbm" key)
        # () -> preemption dict ("preempt" key); serving assigns it after
        # start() (the coordinator is built once the endpoint is live)
        self.preempt_fn = preempt_fn
        # () -> {"site/kind": fired} fault-plan firing counts ("faults"
        # key) — how chaos injected into a live worker reaches the
        # aggregator's worker_faults_fired_total gauge
        self.faults_fn = faults_fn
        self.interval_s = interval_s
        self.subject = component.event_subject(LOAD_METRICS_SUBJECT)
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._pump())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def snapshot(self) -> dict:
        s = self.stats_fn()
        snap = {
            "worker_id": self.worker_id,
            "num_requests_running": s.num_running,
            "num_requests_waiting": s.num_waiting,
            "kv_usage": s.kv_usage,
            "num_total_blocks": s.num_total_blocks,
            "prefix_cache_hits": s.prefix_cache_hits,
            "prefix_cache_queries": s.prefix_cache_queries,
        }
        if self.extra_fn is not None:
            try:
                snap.update(self.extra_fn())
            except Exception:
                log.exception("metrics extra_fn failed")
        if self.spec_fn is not None:
            try:
                snap["spec"] = dict(self.spec_fn())
            except Exception:
                log.exception("metrics spec_fn failed")
        if self.obs_fn is not None:
            try:
                obs = self.obs_fn()
                if obs:
                    snap["obs"] = dict(obs)
            except Exception:
                log.exception("metrics obs_fn failed")
        if self.kvbm_fn is not None:
            try:
                snap["kvbm"] = dict(self.kvbm_fn())
            except Exception:
                log.exception("metrics kvbm_fn failed")
        if self.preempt_fn is not None:
            try:
                snap["preempt"] = dict(self.preempt_fn())
            except Exception:
                log.exception("metrics preempt_fn failed")
        if self.faults_fn is not None:
            try:
                fired = self.faults_fn()
                if fired:
                    snap["faults"] = dict(fired)
            except Exception:
                log.exception("metrics faults_fn failed")
        return snap

    async def _pump(self) -> None:
        store = self.component.runtime.store
        failures = 0
        while True:
            try:
                await store.publish(
                    self.subject + str(self.worker_id),
                    codec.packb(self.snapshot()),
                )
                failures = 0
            except Exception as exc:
                if failures == 0:
                    log.exception("load metrics publish failed")
                else:
                    log.warning("load metrics publish still failing (%d in "
                                "a row): %s", failures + 1, exc)
                failures += 1
            await asyncio.sleep(self.interval_s)
