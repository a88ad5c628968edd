"""Span exporters: JSONL for offline assembly, in-memory for tests,
Prometheus histograms for always-on per-stage latency aggregates."""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

from .span import Span


class InMemorySpanExporter:
    """Keeps exported spans in a list — the test sink."""

    def __init__(self):
        self.spans: List[Span] = []

    def export(self, span: Span) -> None:
        self.spans.append(span)

    def by_trace(self) -> Dict[str, List[Span]]:
        out: Dict[str, List[Span]] = {}
        for s in self.spans:
            out.setdefault(s.trace_id, []).append(s)
        return out

    def clear(self) -> None:
        self.spans.clear()


class JsonlSpanExporter:
    """One JSON object per line, flushed per span so a crashing process
    loses at most the span being written. Open lazily: a configured-but-idle
    exporter never touches the filesystem."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = None

    def export(self, span: Span) -> None:
        line = json.dumps(span.to_dict(), separators=(",", ":"))
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "a")
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class MetricsSpanExporter:
    """Observes every span's duration into
    ``stage_latency_seconds{stage=<span name>}`` on a MetricsRegistry
    (LATENCY_BUCKETS by default — same buckets as TTFT/ITL)."""

    def __init__(self, registry, name: str = "stage_latency_seconds"):
        self._hist = registry.histogram(
            name, "per-stage latency attributed from trace spans", ["stage"]
        )

    def export(self, span: Span) -> None:
        dur: Optional[float] = span.duration_s
        if dur is not None:
            self._hist.labels(stage=span.name).observe(max(dur, 0.0))
