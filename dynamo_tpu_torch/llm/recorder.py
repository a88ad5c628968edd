"""Stream perf recorder + analysis
(ref: lib/llm/src/perf.rs:560, recorder.rs:667 — record response streams
with timestamps at minimal overhead, analyse offline).

``record_stream`` wraps any async output stream, appending
``(t_monotonic, kind, payload)`` tuples to an in-memory list (one append
per item — no I/O on the hot path). ``StreamRecord`` derives TTFT/ITL/
throughput; ``Recorder`` collects many streams and dumps JSONL for offline
tooling.

A copy of ``dynamo_tpu.llm.recorder``.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              int(round(q / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


@dataclass
class StreamRecord:
    """One recorded stream: request-relative event timeline."""

    request_id: str
    t_start: float = field(default_factory=time.monotonic)
    # wall-clock anchor for t_start: lets offline tooling lay records from
    # different processes on one timeline (and join them against trace
    # spans, which carry the same anchor)
    t_start_unix: float = field(default_factory=time.time)
    trace_id: Optional[str] = None
    events: List[tuple] = field(default_factory=list)  # (dt, kind, payload)
    finished: bool = False

    def mark(self, kind: str, payload: Any = None) -> None:
        self.events.append((time.monotonic() - self.t_start, kind, payload))

    # ----------------------- derived metrics ---------------------------

    @property
    def item_times(self) -> List[float]:
        return [dt for dt, kind, _ in self.events if kind == "item"]

    @property
    def ttft_s(self) -> Optional[float]:
        t = self.item_times
        return t[0] if t else None

    @property
    def itl_s(self) -> List[float]:
        t = self.item_times
        return [b - a for a, b in zip(t, t[1:])]

    @property
    def duration_s(self) -> Optional[float]:
        return self.events[-1][0] if self.events else None

    @property
    def num_items(self) -> int:
        return len(self.item_times)

    def summary(self) -> dict:
        itl = sorted(self.itl_s)
        dur = self.duration_s or 0.0
        return {
            "request_id": self.request_id,
            "ttft_s": self.ttft_s,
            "itl_p50_s": _pct(itl, 50),
            "itl_p99_s": _pct(itl, 99),
            "num_items": self.num_items,
            "duration_s": dur,
            "items_per_s": self.num_items / dur if dur else 0.0,
            "finished": self.finished,
        }

    def to_jsonl(self) -> str:
        return json.dumps({
            "request_id": self.request_id,
            "t_start_unix": self.t_start_unix,
            **({"trace_id": self.trace_id} if self.trace_id else {}),
            "events": [
                {"dt": dt, "kind": kind,
                 **({"payload": payload} if payload is not None else {})}
                for dt, kind, payload in self.events
            ],
            "summary": self.summary(),
        })


class Recorder:
    """Collects stream records; optional JSONL sink."""

    def __init__(self, path: Optional[str] = None,
                 capture_payloads: bool = False):
        self.path = path
        self.capture_payloads = capture_payloads
        self.records: Dict[str, StreamRecord] = {}

    def start(self, request_id: str,
              trace_id: Optional[str] = None) -> StreamRecord:
        rec = StreamRecord(request_id=request_id, trace_id=trace_id)
        self.records[request_id] = rec
        return rec

    async def record_stream(
        self, request_id: str, stream: AsyncIterator,
        trace_id: Optional[str] = None,
    ) -> AsyncIterator:
        """Pass-through wrapper: timestamps every yielded item."""
        rec = self.start(request_id, trace_id=trace_id)
        try:
            async for item in stream:
                rec.mark("item", item if self.capture_payloads else None)
                yield item
            rec.finished = True
        except BaseException as e:
            rec.mark("error", repr(e))
            raise
        finally:
            rec.mark("end")
            if self.path:
                self.flush(request_id)

    def flush(self, request_id: str) -> None:
        rec = self.records.get(request_id)
        if rec is None or not self.path:
            return
        with open(self.path, "a") as f:
            f.write(rec.to_jsonl() + "\n")

    def aggregate(self) -> dict:
        """Fleet-level percentiles across all finished records."""
        ttfts = sorted(r.ttft_s for r in self.records.values()
                       if r.ttft_s is not None)
        itls = sorted(x for r in self.records.values() for x in r.itl_s)
        total_items = sum(r.num_items for r in self.records.values())
        return {
            "num_streams": len(self.records),
            "ttft_p50_s": _pct(ttfts, 50),
            "ttft_p99_s": _pct(ttfts, 99),
            "itl_p50_s": _pct(itls, 50),
            "itl_p99_s": _pct(itls, 99),
            "total_items": total_items,
        }


def load_jsonl(path: str) -> List[dict]:
    """Offline analysis loader."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
