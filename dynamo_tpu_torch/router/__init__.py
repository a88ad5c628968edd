"""KV-cache-aware routing (ref: lib/llm/src/kv_router/).

Workers publish KV-cache events (stored/removed/cleared block hashes) on the
store pub/sub subject ``kv_events``; the router maintains a per-worker prefix
index, scores request overlap, and schedules with the reference cost function
``logit = overlap_weight * potential_prefill_blocks + decode_blocks`` (lower
is better, softmax-sampled). A copy of ``dynamo_tpu.router``, plus the
frontend's load monitor behind ``--busy-threshold``.
"""

from .indexer import ApproxKvIndexer, KvIndexer, OverlapScores, RouterEvent
from .scheduler import KvRouterConfig, PotentialLoads, select_worker, softmax_sample
from .kv_router import KvPushRouter, KvRouter
from .monitor import WorkerMonitor
from .publisher import KvEventPublisher, WorkerMetricsPublisher

__all__ = [
    "ApproxKvIndexer",
    "KvIndexer",
    "KvPushRouter",
    "KvRouter",
    "KvRouterConfig",
    "KvEventPublisher",
    "OverlapScores",
    "PotentialLoads",
    "RouterEvent",
    "WorkerMetricsPublisher",
    "WorkerMonitor",
    "select_worker",
    "softmax_sample",
]
