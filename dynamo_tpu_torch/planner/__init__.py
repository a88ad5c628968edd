"""The SLA planner's pieces that serving processes run.

A copy of what ``dynamo_tpu.planner`` gives workers and frontends: the
graceful-degradation ladder and the watcher of its store orders
(:mod:`.degradation`). The planner core, predictors, interpolation,
connectors and orchestrator wait for ROADMAP.md queue A item 7.
"""

from .degradation import (
    DegradationConfig, DegradationLadder, DegradationWatcher, NO_DEGRADATION,
    STEPS, apply_engine_clamps,
)

__all__ = [
    "DegradationConfig", "DegradationLadder", "DegradationWatcher",
    "NO_DEGRADATION", "STEPS", "apply_engine_clamps",
]
