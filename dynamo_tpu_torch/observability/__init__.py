"""Engine flight recorder: live MFU/goodput accounting, the graph-capture
watch, on-demand profiles.

A copy of ``dynamo_tpu.observability`` for what the port's engine records:

* :mod:`.flops` — the analytic FLOPs/parameter model (attention term
  included) and the card's peak-rate table
* :mod:`.stepstats` — per-engine-step records + windowed live gauges
* :mod:`.report` — ``python -m dynamo_tpu_torch.observability`` JSONL
  report
* :mod:`.compilewatch` — the compile watchdog's twin: decode/spec graph
  captures and einsum rebuilds per key, after warm-up
* :mod:`.profiling` — ``/debug/profile?ms=N`` on ``torch.profiler``
* :mod:`.gauges` — the worker's ``engine_*`` Prometheus gauges

Nothing here imports torch at module level, so control-plane processes can
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
