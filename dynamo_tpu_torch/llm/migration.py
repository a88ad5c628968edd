"""Migration: retry a broken stream on a new worker with token carryover.

Role-equivalent to the reference's ``Migration``/``RetryManager``
(ref: lib/llm/src/migration.rs:26,88-190): when a worker dies mid-stream (or
no worker is available at issue time), the request is re-issued to another
instance with the tokens generated so far appended to the prompt, so
generation continues seamlessly. Bounded by ``migration_limit`` from the
model card AND by the request's remaining deadline budget: each retry waits
a jittered exponential backoff clipped to what is left of the deadline, and
an expired deadline surfaces as a non-retryable ``ERR_TIMEOUT`` instead of
burning further attempts on work the client will never see.

A copy of ``dynamo_tpu.llm.migration``.
"""

from __future__ import annotations

import asyncio
import random
from typing import Any, AsyncIterator, Optional

from ..runtime.context import Context
from ..runtime.engine import AsyncEngine
from ..runtime.transport import (
    EngineError, ERR_DRAINING, ERR_OVERLOADED, ERR_TIMEOUT, ERR_UNAVAILABLE,
)
from ..tracing import get_tracer, trace_span
from ..utils.logging import get_logger

log = get_logger("migration")

# ``draining`` is a planned divert (the router routes the retry elsewhere),
# not a failure — retryable like unavailability but never breaker-tripping
RETRYABLE = (ERR_UNAVAILABLE, ERR_OVERLOADED, ERR_DRAINING)


class Migration(AsyncEngine):
    """Wraps the routing sink; retries with accumulated-token carryover."""

    def __init__(
        self,
        sink: AsyncEngine,
        migration_limit: int = 3,
        *,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        rng: Optional[random.Random] = None,
    ):
        self.sink = sink
        self.migration_limit = migration_limit
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        # injectable for deterministic jitter in tests
        self.rng = rng or random.Random()
        # re-issue decisions taken over this sink's lifetime: the direct
        # stream-repair evidence the replay fault-attribution check reads
        # (span surplus undercounts when an unrelated request's timeout
        # cancels its attempt span before export)
        self.num_retries = 0

    async def _backoff(self, attempt: int, context: Context) -> bool:
        """Sleep the jittered backoff for retry number ``attempt`` (1-based),
        clipped to the remaining deadline budget. Returns False when the
        budget is exhausted or the caller cancelled — do not re-issue."""
        delay = min(
            self.backoff_base_s * (2 ** (attempt - 1)), self.backoff_cap_s
        ) * (0.5 + 0.5 * self.rng.random())
        remaining = context.time_remaining()
        if remaining is not None:
            if remaining <= 0:
                return False
            # never sleep past the deadline; leave a sliver to actually run
            delay = min(delay, max(remaining - 0.001, 0.0))
        if delay > 0:
            # a cancel during backoff must exit immediately, not re-issue
            # after the nap
            try:
                await asyncio.wait_for(context.wait_stopped(), timeout=delay)
            except asyncio.TimeoutError:
                pass
        return not context.is_stopped() and not context.is_expired()

    async def generate(
        self, request: Any, context: Context
    ) -> AsyncIterator[Any]:
        req = dict(request)
        orig_prompt_len = len(req.get("token_ids", []))
        emitted: list = []
        attempts_left = self.migration_limit
        attempt = 0
        while True:
            # the attempt's child context mints the span id the attempt span
            # adopts: router/transport spans issued under attempt_ctx parent
            # here, and each retry is a sibling under the request root
            attempt_ctx = context.child()
            span = get_tracer().start_span(
                "migration.attempt", trace=attempt_ctx.trace,
                parent_span_id=context.trace.span_id,
                attrs={"attempt": attempt, "carried_tokens": len(emitted)},
            )
            stream = self.sink.generate(req, attempt_ctx)
            try:
                async for item in stream:
                    toks = list(item.get("token_ids", []))
                    emitted.extend(toks)
                    # report the *original* prompt length even after
                    # carryover re-issue (ref: migration.rs track_response)
                    if item.get("num_prompt_tokens", 0) > orig_prompt_len:
                        item = dict(item)
                        item["num_prompt_tokens"] = orig_prompt_len
                    yield item
                    if item.get("finished"):
                        return
                # stream completed without a finished marker: treat as a
                # worker drop unless the caller cancelled
                if context.is_stopped():
                    return
                raise EngineError("stream ended early", ERR_UNAVAILABLE)
            except EngineError as e:
                # close the attempt span BEFORE the backoff sleep below —
                # the nap belongs to migration.backoff, not the attempt
                span.set_status("error", e.code)
                span.end()
                if context.is_stopped():
                    return  # client gone — nobody is listening for a retry
                if e.code not in RETRYABLE or attempts_left <= 0:
                    raise
                if context.is_expired():
                    raise EngineError(
                        f"deadline exhausted after {attempt} migrations "
                        f"({len(emitted)} tokens emitted): {e}", ERR_TIMEOUT,
                    )
                attempts_left -= 1
                attempt += 1
                self.num_retries += 1
                with trace_span("migration.backoff", context,
                                attrs={"attempt": attempt}):
                    backed_off = await self._backoff(attempt, context)
                if not backed_off:
                    if context.is_stopped():
                        return
                    raise EngineError(
                        f"deadline exhausted during migration backoff "
                        f"(attempt {attempt}): {e}", ERR_TIMEOUT,
                    )
                log.warning(
                    "stream failed (%s); migrating with %d carried tokens "
                    "(%d attempts left)", e.code, len(emitted), attempts_left,
                )
                req = dict(request)
                req["token_ids"] = (
                    list(request.get("token_ids", [])) + emitted
                )
                remaining = int(request.get("max_tokens", 64)) - len(emitted)
                if remaining <= 0:
                    return  # everything already generated
                req["max_tokens"] = remaining
            finally:
                # close the sink stream deterministically — returning from
                # the async-for (e.g. on the finished item) would otherwise
                # leave the sink's cleanup (breaker bookkeeping, load
                # accounting) to run at GC time
                await stream.aclose()
                span.end()  # no-op on the error path (already closed)
