"""What the per-layer readers (``metrics/<name>.py``) read, and the
arithmetic they share. A reader returns None when its run holds nothing
for it to read; the harness then leaves the metric out of the line."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, List, Optional, Sequence, Tuple

from .trace import TraceSummary


@dataclass
class Readings:
    shapes: Any                      # the architecture's shapes(config)
    arch: ModuleType                 # arch/<model_type>.py: its counts
    peaks: Optional[dict]            # flops.card_peaks of the card, or None
    t0: float                        # the measured window, host monotonic
    t1: float
    results: list                    # serve.Result of every request sent
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    records: list = field(default_factory=list)   # landed StepRecords
    trace: Optional[TraceSummary] = None


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (the smallest value with at least q% of the
    values at or below it); None for no values."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def span_p50_ms(r: Readings, name: str) -> Optional[float]:
    """Median duration of the ``name`` spans that began in the window."""
    d = [(e - s) * 1e3 for n, s, e in r.spans
         if n == name and r.t0 <= s <= r.t1]
    return percentile(d, 50)


def _in_window(r: Readings, kind: Optional[str] = None) -> list:
    return [x for x in r.records if r.t0 <= x.t_land <= r.t1
            and (kind is None or x.kind == kind)]


def decode_batch_mean(r: Readings) -> Optional[float]:
    recs = _in_window(r, "decode")
    if not recs:
        return None
    return sum(x.live_rows for x in recs) / len(recs)


def decode_window_ms(r: Readings) -> Optional[float]:
    if r.trace is None or not r.trace.graph_windows_s:
        return None
    w = r.trace.graph_windows_s
    return sum(w) / len(w) * 1e3


def mfu_pct(r: Readings) -> Optional[float]:
    """Useful model FLOPs of the tokens the window's landed steps
    processed, over the window's seconds times the card's bf16 peak."""
    recs = _in_window(r)
    if r.peaks is None or not recs:
        return None
    work = sum(r.arch.step_flops(r.shapes, x) for x in recs)
    return 100.0 * work / ((r.t1 - r.t0) * r.peaks["bf16_flops"])


def roofline_pct(r: Readings, face: str) -> Optional[float]:
    """The mean bound of the face's launches (from the steps dispatched
    while the profiler ran) over their mean device time in the trace."""
    kind = {"ragged": "prefill", "decode": "decode"}[face]
    if r.trace is None or r.peaks is None or face not in r.trace.kernel_time:
        return None
    recs = [x for x in r.records if x.kind == kind
            and r.trace.t_start <= x.t_dispatch <= r.trace.t_stop]
    if not recs:
        return None
    bound = sum(r.arch.attn_bound_s(r.shapes, r.peaks, x)
                for x in recs) / len(recs)
    total, n = r.trace.kernel_time[face]
    return 100.0 * bound / (total / n)


def idle_pct(r: Readings) -> Optional[float]:
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
