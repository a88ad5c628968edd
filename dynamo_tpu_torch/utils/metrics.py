"""Hierarchical Prometheus metrics registries.

Namespace/component/endpoint-scoped metric factories with automatic labels,
equivalent to the reference's ``MetricsRegistry`` trait hierarchy
(ref: lib/runtime/src/metrics.rs:365, metrics/prometheus_names.rs). A copy of
``dynamo_tpu.utils.metrics`` that keeps its own counters, gauges and
histograms and writes the Prometheus text exposition format 0.0.4 itself,
with the family names, ``_total``/``_created``/``_bucket``/``_count``/
``_sum`` series, label order, escaping and number formatting of
``prometheus_client`` (which the card's machine does not install).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# the exposition's content type, as prometheus_client's CONTENT_TYPE_LATEST
# names it (what the JAX system server sends with /metrics)
CONTENT_TYPE_LATEST = "text/plain; version=1.0.0; charset=utf-8"

# Frequency buckets tuned for LLM serving latencies (TTFT/ITL in seconds),
# same role as the reference's http/service/metrics.rs histograms.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def _go_float(d: float) -> str:
    """A number as Prometheus (Go) prints it: ``+Inf``, ``1.0``, ``1e+06``."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python's repr
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


class _Child:
    """One label set's value(s)."""

    def __init__(self, metric: "_Metric"):
        self._metric = metric
        self._lock = threading.Lock()
        self.created = time.time()
        self.value = 0.0
        if metric.kind == "histogram":
            self.counts = [0.0] * len(metric.buckets)
            self.sum = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if self._metric.kind == "counter" and amount < 0:
            raise ValueError("Counters can only be incremented by "
                             "non-negative amounts.")
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def observe(self, amount: float) -> None:
        with self._lock:
            self.sum += amount
            for i, bound in enumerate(self._metric.buckets):
                if amount <= bound:
                    self.counts[i] += 1
                    break

    def samples(self) -> List[Tuple[str, List[Tuple[str, str]], float]]:
        """(suffix, extra labels, value) in exposition order."""
        with self._lock:
            kind = self._metric.kind
            if kind == "counter":
                return [("_total", [], self.value),
                        ("_created", [], self.created)]
            if kind == "gauge":
                return [("", [], self.value)]
            out, acc = [], 0.0
            for bound, n in zip(self._metric.buckets, self.counts):
                acc += n
                out.append(("_bucket", [("le", _go_float(bound))], acc))
            return out + [("_count", [], acc), ("_sum", [], self.sum),
                          ("_created", [], self.created)]


class _Metric:
    """A metric family: counter, gauge or histogram over fixed label names.
    Without label names it holds its one value from creation and takes
    ``inc``/``set``/``observe`` itself."""

    def __init__(self, kind: str, name: str, doc: str,
                 labelnames: Sequence[str], buckets=LATENCY_BUCKETS):
        if kind == "counter" and name.endswith("_total"):
            name = name[:-len("_total")]
        self.kind = kind
        self.name = name
        self.doc = doc
        self._labelnames = tuple(labelnames)
        if kind == "histogram":
            b = [float(x) for x in buckets]
            if b[-1] != math.inf:
                b.append(math.inf)
            self.buckets = tuple(b)
        self._lock = threading.Lock()
        self._children: Dict[tuple, _Child] = {}
        if not self._labelnames:
            self._children[()] = _Child(self)

    def labels(self, *values: str, **kw: str) -> _Child:
        if kw:
            if values or set(kw) != set(self._labelnames):
                raise ValueError("Incorrect label names")
            values = tuple(kw[n] for n in self._labelnames)
        if len(values) != len(self._labelnames) or not self._labelnames:
            raise ValueError("Incorrect label count")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self)
        return child

    def remove(self, *values: str) -> None:
        with self._lock:
            self._children.pop(tuple(str(v) for v in values), None)

    def _only(self) -> _Child:
        if self._labelnames:
            raise ValueError("metric has labels: call .labels() first")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)

    def render(self) -> List[str]:
        """The family's lines; its ``_created`` samples follow as a gauge
        family of their own, as ``prometheus_client`` writes them."""
        doc = _escape_help(self.doc)
        head = self.name + ("_total" if self.kind == "counter" else "")
        lines = [f"# HELP {head} {doc}", f"# TYPE {head} {self.kind}"]
        created: List[str] = []
        with self._lock:
            children = list(self._children.items())
        for key, child in children:
            base = [(n, _escape_label(v)) for n, v in zip(self._labelnames,
                                                           key)]
            for suffix, extra, value in child.samples():
                labels = sorted(base + extra)
                lab = ("{" + ",".join(f'{n}="{v}"' for n, v in labels)
                       + "}") if labels else ""
                line = f"{self.name}{suffix}{lab} {_go_float(value)}"
                (created if suffix == "_created" else lines).append(line)
        if created:
            lines += [f"# HELP {self.name}_created {doc}",
                      f"# TYPE {self.name}_created gauge"] + created
        return lines


class _Registry:
    """The process scope's families, in registration order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: List[_Metric] = []

    def register(self, metric: _Metric) -> None:
        with self._lock:
            self._families.append(metric)

    def render(self) -> bytes:
        with self._lock:
            families = list(self._families)
        lines = [ln for m in families for ln in m.render()]
        return ("\n".join(lines) + "\n").encode() if lines else b""


class MetricsRegistry:
    """A scope (runtime / namespace / component / endpoint) that mints metrics.

    Child scopes share the root registry and accumulate constant labels,
    mirroring the reference's auto-labelled hierarchy.
    """

    def __init__(
        self,
        registry: Optional[_Registry] = None,
        prefix: str = "dynamo",
        const_labels: Optional[Dict[str, str]] = None,
    ):
        self.registry = registry or _Registry()
        self.prefix = prefix
        self.const_labels = dict(const_labels or {})
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def child(self, **labels: str) -> "MetricsRegistry":
        merged = dict(self.const_labels)
        merged.update(labels)
        sub = MetricsRegistry(self.registry, self.prefix, merged)
        sub._metrics = self._metrics  # share the mint cache across scopes
        sub._lock = self._lock
        return sub

    def _full_name(self, name: str) -> str:
        return f"{self.prefix}_{name}"

    def _get_or_create(self, kind: str, name: str, doc: str, labelnames,
                       **kwargs) -> _Metric:
        key = self._full_name(name)
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                metric = _Metric(kind, key, doc, labelnames, **kwargs)
                self.registry.register(metric)
                self._metrics[key] = metric
        return metric

    def _labelnames(self, extra: Sequence[str]) -> tuple:
        return tuple(self.const_labels.keys()) + tuple(extra)

    def _bind(self, metric: _Metric, extra_labels: Sequence[str]):
        if extra_labels:
            return _Bound(metric, self.const_labels)
        # a metric with no labels at all cannot take .labels()
        return metric.labels(**self.const_labels) if self.const_labels \
            else metric

    def counter(self, name: str, doc: str, extra_labels: Sequence[str] = ()):
        c = self._get_or_create("counter", name, doc,
                                self._labelnames(extra_labels))
        return self._bind(c, extra_labels)

    def gauge(self, name: str, doc: str, extra_labels: Sequence[str] = ()):
        g = self._get_or_create("gauge", name, doc,
                                self._labelnames(extra_labels))
        return self._bind(g, extra_labels)

    def histogram(
        self, name: str, doc: str, extra_labels: Sequence[str] = (),
        buckets=LATENCY_BUCKETS,
    ):
        h = self._get_or_create("histogram", name, doc,
                                self._labelnames(extra_labels),
                                buckets=buckets)
        return self._bind(h, extra_labels)

    def render(self) -> bytes:
        """Prometheus text exposition of every metric in this process scope."""
        return self.registry.render()


class _Bound:
    """Partially-bound metric: const labels applied, extra labels at call time."""

    def __init__(self, metric: _Metric, const_labels: Dict[str, str]):
        self._metric = metric
        self._const = const_labels

    def labels(self, **extra: str) -> _Child:
        merged = dict(self._const)
        merged.update(extra)
        return self._metric.labels(**merged)

    def remove(self, **extra: str) -> None:
        """Drop one label-set's child series (e.g. a departed worker's
        gauges) so stale values stop being scraped. No-op if the label set
        was never observed."""
        merged = dict(self._const)
        merged.update(extra)
        try:
            values = [merged[n] for n in self._metric._labelnames]
            self._metric.remove(*values)
        except KeyError:
            pass
