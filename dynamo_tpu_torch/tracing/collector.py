"""The in-process span collector: ring buffer, sampling, sinks.

One process-global :class:`SpanCollector` receives every ended span. The hot
path is a single ``deque.append`` (GIL-atomic — no lock) into a bounded ring
buffer; everything else happens per span end, not per token:

- per-stage latency histograms (``stage_latency_seconds{stage=...}``) are
  observed into every attached :class:`MetricsRegistry` for EVERY span,
  sampled or not — aggregates must never depend on the sampling knob;
- head sampling by trace id (deterministic hash, so every process in the
  cluster makes the same keep/drop decision for a trace without any
  coordination) gates the span exporters (JSONL / in-memory). A copy of
  ``dynamo_tpu.tracing.collector`` that hashes with this package's own
  xxh3-64 (``utils/xxh3.py``, seeded by the salt) in place of ``xxhash``,
  so a JAX process and a port process decide alike for every trace id;
- slow-request auto-dump: when a *root* span (frontend request or worker
  ingress) ends over ``slow_threshold_s`` and its trace was not sampled,
  the whole trace is scraped out of the ring buffer and exported anyway —
  the pathological tail is visible even at sample_ratio 0;
- the engine loop's spans (``buffered=False``) stay out of that ring, so
  a busy loop never pushes a request's spans out of it; they reach the
  sinks and every open :meth:`SpanCollector.tap` (a profile capture) and
  are minted only while the collector has a sink (:attr:`active`).

Every span's ``start_unix`` is its monotonic start plus one
monotonic→Unix offset, taken when the collector is made or configured and
again at each profile capture: the profiler stamps its events on the Unix
clock, so spans and kernels share one time line.
"""

from __future__ import annotations

import secrets
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, Iterator, List, Optional

from ..utils.xxh3 import xxh3_64
from .span import STATUS_ERROR, Span

DEFAULT_BUFFER_SIZE = 4096


def measure_unix_offset(tries: int = 5) -> float:
    """Unix time minus monotonic time, in seconds: of ``tries``
    back-to-back (monotonic, Unix, monotonic) reads, the one whose two
    monotonic reads lie closest, with the Unix read set at their middle."""
    best = None
    for _ in range(tries):
        m0 = time.monotonic_ns()
        unix = time.time_ns()
        m1 = time.monotonic_ns()
        if best is None or m1 - m0 < best[0]:
            best = (m1 - m0, unix - (m0 + m1) // 2)
    return best[1] / 1e9


class SpanCollector:
    """Mints, buffers, samples, and exports spans for one process."""

    def __init__(
        self,
        *,
        sample_ratio: float = 0.0,
        slow_threshold_s: Optional[float] = None,
        buffer_size: int = DEFAULT_BUFFER_SIZE,
        sample_salt: int = 0,
    ):
        self.sample_ratio = sample_ratio
        self.slow_threshold_s = slow_threshold_s
        self.sample_salt = sample_salt
        self._ring: Deque[Span] = deque(maxlen=buffer_size)
        self._exporters: List[Any] = []
        # always-on metric sinks, keyed by id(registry) so frontend and
        # runtime registries coexisting in one process each get their own
        # stage_latency_seconds family
        self._metrics: Dict[int, Any] = {}
        # lists that receive every unbuffered span, sampled or not
        self._taps: List[List[Span]] = []
        self.unix_offset_s = measure_unix_offset()

    @property
    def active(self) -> bool:
        """Whether a span would reach any sink: the engine loop reads it
        on every step and mints nothing while it is False."""
        return bool(self._exporters or self._metrics or self._taps)

    def calibrate_clock(self) -> None:
        """Take the monotonic→Unix offset of ``start_unix`` anew."""
        self.unix_offset_s = measure_unix_offset()

    # ------------------------- configuration ---------------------------

    def configure(
        self,
        *,
        sample_ratio: Optional[float] = None,
        slow_threshold_s: Optional[float] = None,
        buffer_size: Optional[int] = None,
        sample_salt: Optional[int] = None,
    ) -> "SpanCollector":
        if sample_ratio is not None:
            self.sample_ratio = sample_ratio
        if slow_threshold_s is not None:
            # 0 and negatives mean "disabled" so config files can express it
            self.slow_threshold_s = (
                slow_threshold_s if slow_threshold_s > 0 else None
            )
        if sample_salt is not None:
            self.sample_salt = sample_salt
        if buffer_size is not None and buffer_size != self._ring.maxlen:
            self._ring = deque(self._ring, maxlen=max(1, buffer_size))
        self.calibrate_clock()
        return self

    def add_exporter(self, exporter: Any) -> None:
        if exporter not in self._exporters:
            self._exporters.append(exporter)

    def remove_exporter(self, exporter: Any) -> None:
        if exporter in self._exporters:
            self._exporters.remove(exporter)

    def add_jsonl(self, path: str) -> None:
        """Add a JSONL exporter for ``path`` unless one already writes there
        (several runtimes in one process share a config file)."""
        from .export import JsonlSpanExporter

        for e in self._exporters:
            if isinstance(e, JsonlSpanExporter) and e.path == path:
                return
        self.add_exporter(JsonlSpanExporter(path))

    def attach_metrics(self, registry: Any,
                       name: str = "stage_latency_seconds") -> None:
        """Mint the per-stage latency histogram on ``registry`` and observe
        every span's duration into it (idempotent per registry)."""
        from .export import MetricsSpanExporter

        key = id(registry)
        if key not in self._metrics:
            self._metrics[key] = MetricsSpanExporter(registry, name=name)

    def detach_metrics(self, registry: Any) -> None:
        self._metrics.pop(id(registry), None)

    # --------------------------- sampling ------------------------------

    def sampled(self, trace_id: str) -> bool:
        """Deterministic head-sampling decision for a trace id: the same id
        and salt hash identically in every process, so a trace is either
        exported everywhere or nowhere."""
        if self.sample_ratio <= 0:
            return False
        if self.sample_ratio >= 1:
            return True
        h = xxh3_64(trace_id.encode("utf-8"), seed=self.sample_salt)
        return h / 2.0 ** 64 < self.sample_ratio

    # --------------------------- span minting --------------------------

    def start_span(
        self,
        name: str,
        context: Any = None,
        *,
        trace: Any = None,
        parent_span_id: Optional[str] = None,
        attrs: Optional[dict] = None,
        root: bool = False,
    ) -> Span:
        """Open a span.

        Two parenting forms:
        - ``trace=``: the span ADOPTS that :class:`TraceContext`'s span id as
          its own (the id is already on the wire / on the context, so work
          attributed to it downstream parents correctly); pass
          ``parent_span_id`` explicitly.
        - ``context=``: a fresh span id is minted under
          ``context.trace.span_id`` — the usual "sub-operation of this
          request" form.
        """
        if trace is not None:
            trace_id, span_id = trace.trace_id, trace.span_id
            parent = parent_span_id
        elif context is not None and getattr(context, "trace", None) is not None:
            trace_id = context.trace.trace_id
            parent = parent_span_id or context.trace.span_id
            span_id = secrets.token_hex(8)
        else:
            trace_id = secrets.token_hex(16)
            span_id = secrets.token_hex(8)
            parent = parent_span_id
        now = time.monotonic()
        return Span(
            name=name,
            trace_id=trace_id,
            span_id=span_id,
            parent_span_id=parent,
            start_mono=now,
            start_unix=now + self.unix_offset_s,
            attrs=dict(attrs or {}),
            root=root,
            _collector=self,
        )

    def record(
        self,
        name: str,
        context: Any = None,
        *,
        start_mono: float,
        end_mono: float,
        trace: Any = None,
        parent_span_id: Optional[str] = None,
        attrs: Optional[dict] = None,
        status: str = "ok",
        status_detail: Optional[str] = None,
        root: bool = False,
        buffered: bool = True,
    ) -> Span:
        """Record an already-elapsed window from explicit monotonic stamps —
        the engine hot path stamps floats per sequence and attributes the
        queue/prefill/decode windows once, after the stream ends, instead of
        carrying live span objects per token. ``buffered=False`` keeps the
        span out of the ring (the engine loop's spans)."""
        span = self.start_span(
            name, context, trace=trace, parent_span_id=parent_span_id,
            attrs=attrs, root=root,
        )
        span.start_mono = start_mono
        span.start_unix = start_mono + self.unix_offset_s
        span.buffered = buffered
        span.status = status
        span.status_detail = status_detail
        span.end(end_mono)
        return span

    @contextmanager
    def trace_span(
        self,
        name: str,
        context: Any = None,
        *,
        trace: Any = None,
        parent_span_id: Optional[str] = None,
        attrs: Optional[dict] = None,
        root: bool = False,
    ) -> Iterator[Span]:
        span = self.start_span(
            name, context, trace=trace, parent_span_id=parent_span_id,
            attrs=attrs, root=root,
        )
        try:
            yield span
        except BaseException as e:
            span.set_status(STATUS_ERROR, repr(e))
            raise
        finally:
            span.end()

    # ----------------------------- sinks -------------------------------

    @contextmanager
    def tap(self) -> Iterator[List[Span]]:
        """A list that receives every unbuffered span that ends while the
        block runs, sampled or not (a profile capture lays them over its
        trace). An open tap is a sink: the engine loop mints its spans."""
        got: List[Span] = []
        self._taps.append(got)
        try:
            yield got
        finally:
            self._taps.remove(got)

    def on_end(self, span: Span) -> None:
        if span.buffered:
            self._ring.append(span)
        else:
            for tap in self._taps:
                tap.append(span)
        for sink in self._metrics.values():
            sink.export(span)
        if not self._exporters:
            return
        if self.sampled(span.trace_id):
            for e in self._exporters:
                e.export(span)
        elif (span.root and self.slow_threshold_s is not None
              and (span.duration_s or 0.0) >= self.slow_threshold_s):
            # slow-request auto-dump: the trace was not head-sampled, but
            # this root ran long — flush everything the ring still holds
            # for it (children ended before their root, so they are here)
            for s in self.get_trace(span.trace_id):
                for e in self._exporters:
                    e.export(s)

    # ---------------------------- queries ------------------------------

    def get_trace(self, trace_id: str) -> List[Span]:
        """All buffered spans of a trace, oldest first."""
        return [s for s in list(self._ring) if s.trace_id == trace_id]

    def trace_ids(self, limit: int = 50) -> List[str]:
        """Most recently seen trace ids, newest first, deduplicated."""
        seen: List[str] = []
        for s in reversed(list(self._ring)):
            if s.trace_id not in seen:
                seen.append(s.trace_id)
                if len(seen) >= limit:
                    break
        return seen


# -------------------------- process-global API --------------------------

_collector = SpanCollector()


def get_tracer() -> SpanCollector:
    return _collector


def configure(**kwargs: Any) -> SpanCollector:
    return _collector.configure(**kwargs)


def reset() -> SpanCollector:
    """Replace the global collector (tests: isolate exporters/sampling)."""
    global _collector
    _collector = SpanCollector()
    return _collector


@contextmanager
def trace_span(name: str, context: Any = None, **kwargs: Any) -> Iterator[Span]:
    with _collector.trace_span(name, context, **kwargs) as span:
        yield span
