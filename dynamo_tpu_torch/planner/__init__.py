"""SLA-based autoscaling planner (ref: components/planner — planner_core.py,
perf_interpolation.py, load_predictor.py, virtual_connector.py).

Observes frontend/worker metrics (tail percentiles, queue depth, breaker
states, spec acceptance), orders graceful degradation under pressure,
predicts the next window's load, converts it into prefill/decode replica
counts via pre-profiled perf interpolation, and emits scaling decisions
through a connector (store-backed virtual connector here; a k8s connector
is the deploy-layer analog). The :class:`Orchestrator` realises the intent
against a live worker pool — role flips first, spawns/stops for the rest.

A copy of ``dynamo_tpu.planner``. The profiler
(:mod:`dynamo_tpu_torch.planner.profiler`) drives the port's engine, so it
is imported on its own, never from here: serving processes import this
package without loading ``torch``.
"""

from .connector import CallbackConnector, VirtualConnector
from .core import Planner, PlannerConfig, WindowMetrics
from .degradation import (
    DegradationConfig, DegradationLadder, DegradationWatcher, NO_DEGRADATION,
    STEPS, apply_engine_clamps,
)
from .interpolation import DecodeInterpolator, PrefillInterpolator
from .orchestrator import Orchestrator, WorkerPool
from .predictors import ARPredictor, ConstantPredictor, MovingAveragePredictor

__all__ = [
    "Planner", "PlannerConfig", "WindowMetrics",
    "PrefillInterpolator", "DecodeInterpolator",
    "ConstantPredictor", "MovingAveragePredictor", "ARPredictor",
    "VirtualConnector", "CallbackConnector",
    "DegradationConfig", "DegradationLadder", "DegradationWatcher",
    "NO_DEGRADATION", "STEPS", "apply_engine_clamps",
    "Orchestrator", "WorkerPool",
]
