"""Engine flight recorder: live MFU/goodput accounting.

A copy of ``dynamo_tpu.observability`` for what the port's engine records:

* :mod:`.flops` — the analytic FLOPs/parameter model (attention term
  included) and the card's peak-rate table
* :mod:`.stepstats` — per-engine-step records + windowed live gauges
* :mod:`.report` — ``python -m dynamo_tpu_torch.observability`` JSONL
  report
* :mod:`.gauges` — the worker's ``engine_*`` Prometheus gauges

The compile watchdog's twin and ``/debug/profile`` come with ROADMAP.md
queue A item 7. Nothing here imports torch, so control-plane processes can
use the package.
"""

from .flops import FlopsModel, active_param_count, param_count, peak_flops
from .stepstats import StepRecord, StepStats

__all__ = [
    "FlopsModel",
    "StepRecord",
    "StepStats",
    "active_param_count",
    "param_count",
    "peak_flops",
]
