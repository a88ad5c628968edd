"""The span model: one timed, attributed window of work inside a trace.

A span carries the W3C ids the transport already propagates
(``utils/logging.TraceContext``), monotonic start/end stamps for precise
in-process durations, and a wall-clock anchor (``start_unix``) so spans
recorded on different hosts can be laid on one timeline by the offline
assembler. Point events are (offset-from-start, name, attrs) tuples —
cheap to record, trivially ordered.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

STATUS_OK = "ok"
STATUS_ERROR = "error"


@dataclass
class Span:
    """One unit of timed work. ``span_id`` is its identity inside the trace;
    ``parent_span_id`` links it into the tree the assembler rebuilds."""

    name: str
    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None
    start_mono: float = 0.0
    end_mono: Optional[float] = None
    start_unix: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)
    events: List[Tuple[float, str, Optional[dict]]] = field(
        default_factory=list
    )
    status: str = STATUS_OK
    status_detail: Optional[str] = None
    # process-local root (frontend request / worker ingress): the slow-dump
    # decision keys off roots, since only they see the full duration
    root: bool = False
    # False for the engine loop's spans, which stay out of the collector's
    # ring (the slow-request dump reads it) and reach profile taps instead
    buffered: bool = field(default=True, repr=False, compare=False)
    # back-reference so span.end() reports to the collector that minted it;
    # excluded from equality/repr — it is plumbing, not data
    _collector: Any = field(default=None, repr=False, compare=False)

    @property
    def duration_s(self) -> Optional[float]:
        if self.end_mono is None:
            return None
        return self.end_mono - self.start_mono

    @property
    def ended(self) -> bool:
        return self.end_mono is not None

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, attrs: Optional[dict] = None) -> None:
        self.events.append((time.monotonic() - self.start_mono, name, attrs))

    def set_status(self, status: str, detail: Optional[str] = None) -> None:
        self.status = status
        if detail is not None:
            self.status_detail = detail

    def end(self, end_mono: Optional[float] = None) -> None:
        """Close the span (idempotent) and hand it to the collector."""
        if self.end_mono is not None:
            return
        self.end_mono = time.monotonic() if end_mono is None else end_mono
        if self._collector is not None:
            self._collector.on_end(self)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "start_unix": self.start_unix,
            "start_mono": self.start_mono,
            "end_mono": self.end_mono,
            "duration_s": self.duration_s,
            "status": self.status,
        }
        if self.status_detail:
            d["status_detail"] = self.status_detail
        if self.attrs:
            d["attrs"] = self.attrs
        if self.events:
            d["events"] = [
                {"offset_s": off, "name": name,
                 **({"attrs": attrs} if attrs else {})}
                for off, name, attrs in self.events
            ]
        if self.root:
            d["root"] = True
        return d

    @staticmethod
    def from_dict(d: dict) -> "Span":
        span = Span(
            name=d.get("name", ""),
            trace_id=d.get("trace_id", ""),
            span_id=d.get("span_id", ""),
            parent_span_id=d.get("parent_span_id"),
            start_mono=float(d.get("start_mono", 0.0)),
            end_mono=d.get("end_mono"),
            start_unix=float(d.get("start_unix", 0.0)),
            attrs=dict(d.get("attrs") or {}),
            status=d.get("status", STATUS_OK),
            status_detail=d.get("status_detail"),
            root=bool(d.get("root", False)),
        )
        for ev in d.get("events") or []:
            span.events.append(
                (float(ev.get("offset_s", 0.0)), ev.get("name", ""),
                 ev.get("attrs"))
            )
        return span
