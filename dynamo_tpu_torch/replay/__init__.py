"""Trace-replay scoreboard: deterministic multi-tenant replay against a
real-engine cluster, scored per deadline tier and cross-checked against the
engine flight recorder and distributed spans.

- :mod:`.trace` — JSONL trace schema + seeded generators (diurnal/bursty
  arrivals, tenant shared-prefix pools, long-context outliers,
  abort/reconnect storms, scheduled preempt/kill/store-flap events).
- :mod:`.driver` — open-loop timestamp-faithful replay with a time-scale
  knob, against an in-process real-engine ``SimCluster`` deployment or a
  live HTTP frontend; fires the event track at its scheduled offsets.
- :mod:`.scoreboard` — per-tier TTFT/ITL/goodput p50/p99, SLO-violation
  rate, prefix-hit rate vs datagen ground truth, abort/preemption
  accounting, chip-seconds per 1M output tokens, and the cross-checks
  (client TTFT vs span timelines, client tokens vs recorder lifetime
  totals) that FAIL the run on disagreement beyond declared tolerance.

CLI: ``python -m dynamo_tpu_torch.replay --seed N --out .`` writes
``REPLAY_seed<N>.json`` and prints the ``REPLAY_SEED=<N>`` repro line.

A copy of ``dynamo_tpu.replay``; :mod:`.datagen` holds the port's copies of
the benchmark generators the traces are built on.
"""

from .trace import (
    ReplayEvent, ReplayTrace, TierSpec, TraceConfig, TraceRequest,
    dump_jsonl, generate_trace, load_jsonl,
)

__all__ = [
    "ReplayEvent", "ReplayTrace", "TierSpec", "TraceConfig", "TraceRequest",
    "dump_jsonl", "generate_trace", "load_jsonl",
]
