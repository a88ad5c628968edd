"""Distributed request tracing: timed spans over the existing
``traceparent`` propagation, per-stage latency attribution, trace export.

A copy of ``dynamo_tpu.tracing``. The span model lives in :mod:`.span`,
the process-global collector (ring buffer + sampling + slow-request
auto-dump) in :mod:`.collector`, the JSONL / in-memory / Prometheus sinks
in :mod:`.export`, and the offline per-trace assembler (also a CLI:
``python -m dynamo_tpu_torch.tracing``) in :mod:`.assemble`.

Stage names instrumented on the port's serving path::

    frontend.request      root span of one HTTP request
    frontend.admission    admission-controller queue wait
    frontend.tokenize     template render + tokenization
    router.select         KV-router score + select
    worker.queue          engine admission → first scheduled chunk
    engine.prefill        first scheduled chunk → first token
    engine.decode         first token → stream end
"""

from .collector import (
    SpanCollector, configure, get_tracer, reset, trace_span,
)
from .export import InMemorySpanExporter, JsonlSpanExporter
from .span import Span

__all__ = [
    "InMemorySpanExporter",
    "JsonlSpanExporter",
    "Span",
    "SpanCollector",
    "configure",
    "get_tracer",
    "reset",
    "trace_span",
]
