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

The engine loop's spans, one set per scheduled batch, each set a trace of
its own, recorded only while the collector has a sink and kept out of its
ring buffer::

    engine.step             schedule start → postprocess end (parent)
    engine.schedule         pressure tick + ``scheduler.schedule()``
    engine.enqueue_prefill  one prefill chunk's host work and launches
    engine.enqueue_decode   control deltas, seat map and the graph replay
    engine.land             the landing's wait returned → the loop takes
                            the landing up
    engine.postprocess      tokens into their streams + KV events
    engine.device_gap       the device idle before the batch's first
                            enqueue (CUDA events), ending at that enqueue
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
