"""Structured logging with W3C trace-context propagation.

JSONL or human-readable logs plus ``traceparent`` create/parse for
cross-process distributed tracing, carried in transport message headers
(ref: lib/runtime/src/logging.rs:50,138,157-171 — ``DistributedTraceContext``,
traceparent in NATS headers). A copy of ``dynamo_tpu.utils.logging`` that
reads its two environment knobs directly and logs under
``dynamo_tpu_torch``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import secrets
import sys
import time
from dataclasses import dataclass
from typing import Optional

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


@dataclass(frozen=True)
class TraceContext:
    """W3C trace-context: 16-byte trace id, 8-byte span id, flags."""

    trace_id: str
    span_id: str
    flags: str = "01"

    @staticmethod
    def new() -> "TraceContext":
        return TraceContext(
            trace_id=secrets.token_hex(16), span_id=secrets.token_hex(8)
        )

    @staticmethod
    def parse(traceparent: str) -> Optional["TraceContext"]:
        m = _TRACEPARENT_RE.match(traceparent.strip().lower())
        if not m:
            return None
        version, trace_id, span_id, flags = m.groups()
        # version ff is reserved-invalid by the W3C spec (§4.1); all-zero
        # ids are likewise invalid
        if version == "ff":
            return None
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return TraceContext(trace_id=trace_id, span_id=span_id, flags=flags)

    def child(self) -> "TraceContext":
        """New span in the same trace (what we put on outgoing messages)."""
        return TraceContext(
            trace_id=self.trace_id, span_id=secrets.token_hex(8), flags=self.flags
        )

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(time.time(), 6),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        for key in ("trace_id", "span_id", "request_id", "component", "endpoint"):
            val = getattr(record, key, None)
            if val is not None:
                entry[key] = val
        if record.exc_info:
            entry["exception"] = self.formatException(record.exc_info)
        return json.dumps(entry, separators=(",", ":"))


_CONFIGURED = False


def init_logging(level: Optional[str] = None, jsonl: Optional[bool] = None) -> None:
    """Idempotent process-wide logging setup (DYNTPU_LOG_LEVEL / _JSONL_LOGGING)."""
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = level or os.environ.get("DYNTPU_LOG_LEVEL", "INFO")
    if jsonl is None:
        jsonl = os.environ.get("DYNTPU_JSONL_LOGGING", "").strip().lower() \
            in ("1", "true", "yes", "on")
    handler = logging.StreamHandler(sys.stderr)
    if jsonl:
        handler.setFormatter(JsonlFormatter())
    else:
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)-5s %(name)s: %(message)s",
                datefmt="%H:%M:%S",
            )
        )
    root = logging.getLogger("dynamo_tpu_torch")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    init_logging()
    return logging.getLogger(f"dynamo_tpu_torch.{name}")
