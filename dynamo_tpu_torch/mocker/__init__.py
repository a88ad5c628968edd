"""Device-free mock engine (ref: lib/llm/src/mocker/engine.rs:48).

A faithful vLLM-semantics simulator: reuses the REAL continuous-batching
scheduler and paged block pool (``dynamo_tpu_torch.engine.scheduler``) —
so prefix caching, eviction, watermark admission, and preemption behave
identically to the production engine — but replaces device execution with
a timing model (``speedup_ratio`` accelerates simulated time). Publishes
real KV events and scheduler stats, making router/planner e2e tests
possible without a GPU.

A copy of ``dynamo_tpu.mocker``.
"""

from .engine import MockEngine, MockerConfig

__all__ = ["MockEngine", "MockerConfig"]
