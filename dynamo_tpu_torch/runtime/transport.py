"""Error codes of the request transport and the error the engines raise
with them (a copy of the part of ``dynamo_tpu.runtime.transport`` the HTTP
frontend maps to status codes; the TCP transport itself comes with the
distributed slice)."""

from __future__ import annotations

# error codes surfaced to the Migration operator's retry policy
ERR_APP = "application"          # handler raised — not retryable
ERR_UNAVAILABLE = "unavailable"  # connect failed / conn dropped — retryable
ERR_OVERLOADED = "overloaded"    # worker rejected (busy threshold) — retryable
ERR_TIMEOUT = "deadline_exceeded"  # request deadline hit — NOT retryable
# planned drain: retryable divert-elsewhere, but NOT a failure signal — the
# router must never feed a draining rejection into a circuit breaker
ERR_DRAINING = "draining"


class EngineError(RuntimeError):
    def __init__(self, message: str, code: str = ERR_APP):
        super().__init__(message)
        self.code = code
