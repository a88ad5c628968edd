"""Worker load monitor + busy-threshold gating
(ref: lib/runtime/src/utils/worker_monitor.rs feeding the busy-instance
rejection in pipeline/network/egress/push_router.rs:58-63).

Subscribes to a component's ``load_metrics`` subject and keeps the latest
ForwardPassMetrics-equivalent snapshot per worker. A router consults
``is_busy`` before dispatch; when *every* instance is busy the request is
rejected with 503/overloaded instead of queueing unboundedly (the
reference's ``--busy-threshold`` behavior). A copy of
``dynamo_tpu.router.monitor`` on the package's own codec."""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional

from ..runtime import codec
from ..runtime.component import Client, Component
from ..utils.logging import get_logger
from .kv_router import LOAD_METRICS_SUBJECT

log = get_logger("worker_monitor")


class WorkerMonitor:
    def __init__(
        self,
        client: Client,
        busy_threshold: float = 0.95,   # kv_usage fraction
        stale_s: float = 30.0,          # ignore snapshots older than this
    ):
        self.client = client
        self.component: Component = client.endpoint.component
        self.busy_threshold = busy_threshold
        self.stale_s = stale_s
        self.worker_stats: Dict[int, dict] = {}
        self._recv_at: Dict[int, float] = {}
        self._task: Optional[asyncio.Task] = None
        client.on_instance_removed.append(self._drop_worker)

    async def start(self) -> None:
        if self._task is None:
            store = self.client.runtime.store
            stream = await store.subscribe(
                self.component.event_subject(LOAD_METRICS_SUBJECT)
            )
            self._task = asyncio.create_task(self._loop(stream))

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def _drop_worker(self, worker_id: int) -> None:
        self.worker_stats.pop(worker_id, None)
        self._recv_at.pop(worker_id, None)

    def is_busy(self, worker_id: int) -> bool:
        """Busy = recent snapshot shows KV usage above threshold. Workers
        with no (or stale) stats are assumed NOT busy — absence of metrics
        must not brown-out the fleet."""
        snap = self.worker_stats.get(worker_id)
        if snap is None:
            return False
        if time.monotonic() - self._recv_at.get(worker_id, 0) > self.stale_s:
            return False
        return float(snap.get("kv_usage", 0.0)) >= self.busy_threshold

    def attach(self) -> None:
        """Install the busy filter on the client's instance picker."""
        self.client.busy_fn = self.is_busy

    async def _loop(self, stream) -> None:
        subject = self.component.event_subject(LOAD_METRICS_SUBJECT)
        while True:
            event = await stream.next()
            if event is None or event["event"] == "dropped":
                log.warning("load_metrics subscription lost — resubscribing")
                await stream.cancel()
                store = self.client.runtime.store
                while True:
                    try:
                        stream = await store.subscribe(subject)
                        break
                    except Exception:
                        log.exception("resubscribe failed — retrying")
                        await asyncio.sleep(0.5)
                continue
            if event["event"] != "msg":
                continue
            try:
                snap = codec.unpackb(event["value"])
                wid = int(snap["worker_id"])
                self.worker_stats[wid] = snap
                self._recv_at[wid] = time.monotonic()
            except Exception:
                log.exception("bad load metrics event")
