"""Distributed request tracing: timed spans over the existing
``traceparent`` propagation, per-stage latency attribution, trace export.

A copy of ``dynamo_tpu.tracing`` for the stages the port's frontend opens.
The span model lives in :mod:`.span`, the process-global collector (ring
buffer + sampling + slow-request auto-dump) in :mod:`.collector`, and the
JSONL / in-memory / Prometheus sinks in :mod:`.export`; the offline
assembler and the engine's own spans come with a later slice.

Stage names instrumented on the port's serving path::

    frontend.request      root span of one HTTP request
    frontend.admission    admission-controller queue wait
    frontend.tokenize     template render + tokenization
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
