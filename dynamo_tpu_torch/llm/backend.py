"""Backend operator: engine token stream → post-processed text stream.

Role-equivalent to the reference's ``Backend`` (ref: lib/llm/src/
backend.rs:55): the forward edge folds tokenizer-derived stop configuration
into the wire request; the backward edge runs incremental detokenization
(UTF-8-safe), evaluates stop strings beyond what the engine can see (with
holdback so a stop string spanning two deltas is still caught before being
emitted), and accounts tokens into :class:`BackendOutput`.

A copy of ``dynamo_tpu.llm.backend``.
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from ..runtime.context import Context
from ..runtime.engine import Operator
from .protocols import BackendOutput, PreprocessedRequest
from .tokenizer import Tokenizer


class Backend(Operator):
    def __init__(self, tokenizer: Tokenizer):
        self.tokenizer = tokenizer

    async def forward(self, request: Any, context: Context) -> Any:
        req: PreprocessedRequest = request
        # engine-side stop set: model EOS + user stop_token_ids
        eos = set(req.stop.eos_token_ids) | set(req.stop.stop_token_ids)
        if req.mm is not None:
            return {**self._base_wire(req, eos), "mm": req.mm}
        return self._base_wire(req, eos)

    def _base_wire(self, req: PreprocessedRequest, eos) -> dict:
        return {
            "token_ids": req.token_ids,
            "model": req.model,
            "max_tokens": req.stop.max_tokens,
            "temperature": req.sampling.temperature,
            "top_k": req.sampling.top_k,
            "top_p": req.sampling.top_p,
            "seed": req.sampling.seed,
            "eos_token_ids": sorted(eos),
            "ignore_eos": req.stop.ignore_eos,
            "annotations": req.annotations,
            "router_hints": req.router_hints,
            # original stop strings travel too so a migrated request
            # re-creates identical semantics on the new worker
            "stop": req.stop.stop,
        }

    async def backward(  # type: ignore[override]
        self, stream: AsyncIterator[Any], request: Any, context: Context
    ) -> AsyncIterator[BackendOutput]:
        req: PreprocessedRequest = request
        detok = self.tokenizer.stream(req.token_ids)
        stops = [s for s in req.stop.stop if s]
        holdback = max((len(s) - 1 for s in stops), default=0)
        pending = ""   # detokenized but not yet emitted (stop-string window)
        cum = 0
        num_prompt = len(req.token_ids)

        def make(text: str, token_ids, reason=None) -> BackendOutput:
            return BackendOutput(
                token_ids=list(token_ids), text=text, finish_reason=reason,
                cum_tokens=cum, num_prompt_tokens=num_prompt,
            )

        async for item in stream:
            token_ids = list(item.get("token_ids", []))
            cum += len(token_ids)
            num_prompt = item.get("num_prompt_tokens", num_prompt)
            finished = bool(item.get("finished"))
            reason = item.get("finish_reason")
            pending += detok.push(token_ids)
            if finished:
                pending += detok.flush()
            if stops:
                hit = _find_stop(pending, stops)
                if hit is not None:
                    # truncate at the stop string; cancel the worker stream
                    context.stop_generating()
                    yield make(pending[:hit], token_ids, "stop")
                    return
            if finished:
                yield make(pending, token_ids, reason)
                return
            emit_len = len(pending) - holdback
            if emit_len > 0:
                yield make(pending[:emit_len], token_ids)
                pending = pending[emit_len:]
            else:
                yield make("", token_ids)
        # stream ended without a finished marker (worker died / cancelled)
        if pending:
            yield make(pending, [], "cancelled" if context.is_stopped() else None)


def _find_stop(text: str, stops) -> int | None:
    best = None
    for s in stops:
        i = text.find(s)
        if i >= 0 and (best is None or i < best):
            best = i
    return best
