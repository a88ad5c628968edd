"""Worker-side routing feeds: the KV-event and load-metrics publishers, and
the frontend's load monitor behind ``--busy-threshold``. The KV-aware router
itself (indexer, scheduler, ``--router-mode kv``) waits for its slice
(ROADMAP.md queue A, item 1c)."""

from .monitor import WorkerMonitor
from .publisher import KvEventPublisher, RouterEvent, WorkerMetricsPublisher

__all__ = [
    "KvEventPublisher",
    "RouterEvent",
    "WorkerMetricsPublisher",
    "WorkerMonitor",
]
