"""OpenAI wire protocol: response builders, SSE codec, delta aggregation.

Role-equivalent to the reference's ``protocols/openai/*`` (chat/completions
wire types, SSE codec at codec.rs, delta aggregators at aggregator.rs:691).
Requests are accepted as plain dicts (validated), responses are built as
dicts — msgpack/JSON-friendly and engine-agnostic.

A copy of ``dynamo_tpu.llm.openai``.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import AsyncIterator, Dict, List, Optional

from .protocols import BackendOutput

SSE_DONE = "data: [DONE]\n\n"


class RequestError(ValueError):
    """Client error → HTTP 400."""


def validate_chat_request(req: dict) -> None:
    if not isinstance(req.get("model"), str) or not req["model"]:
        raise RequestError("'model' is required")
    msgs = req.get("messages")
    if not isinstance(msgs, list) or not msgs:
        raise RequestError("'messages' must be a non-empty list")
    for m in msgs:
        if not isinstance(m, dict) or "role" not in m or "content" not in m:
            raise RequestError("each message needs 'role' and 'content'")
    _validate_sampling(req)


def validate_completion_request(req: dict) -> None:
    if not isinstance(req.get("model"), str) or not req["model"]:
        raise RequestError("'model' is required")
    if "prompt" not in req:
        raise RequestError("'prompt' is required")
    _validate_sampling(req)


def _validate_sampling(req: dict) -> None:
    t = req.get("temperature")
    if t is not None and not (0.0 <= float(t) <= 2.0):
        raise RequestError("temperature must be in [0, 2]")
    p = req.get("top_p")
    if p is not None and not (0.0 < float(p) <= 1.0):
        raise RequestError("top_p must be in (0, 1]")
    mt = req.get("max_tokens") or req.get("max_completion_tokens")
    if mt is not None and int(mt) < 1:
        raise RequestError("max_tokens must be >= 1")
    n = req.get("n")
    if n is not None and int(n) != 1:
        raise RequestError("only n=1 is supported")


# ---------------------------- id helpers ----------------------------------


def chat_id() -> str:
    return f"chatcmpl-{uuid.uuid4().hex}"


def completion_id() -> str:
    return f"cmpl-{uuid.uuid4().hex}"


# ------------------------- chunk construction ------------------------------


def chat_chunk(
    rid: str, model: str, created: int, *,
    content: Optional[str] = None,
    role: Optional[str] = None,
    finish_reason: Optional[str] = None,
    usage: Optional[dict] = None,
    reasoning: Optional[str] = None,
    tool_calls: Optional[list] = None,
) -> dict:
    delta: dict = {}
    if role is not None:
        delta["role"] = role
    if content is not None:
        delta["content"] = content
    if reasoning:
        delta["reasoning_content"] = reasoning
    if tool_calls:
        delta["tool_calls"] = tool_calls
    out = {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": created,
        "model": model,
        "choices": [
            {"index": 0, "delta": delta, "finish_reason": finish_reason}
        ],
    }
    if usage is not None:
        out["usage"] = usage
    return out


def completion_chunk(
    rid: str, model: str, created: int, *,
    text: str = "",
    finish_reason: Optional[str] = None,
    usage: Optional[dict] = None,
) -> dict:
    out = {
        "id": rid,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [
            {"index": 0, "text": text, "finish_reason": finish_reason,
             "logprobs": None}
        ],
    }
    if usage is not None:
        out["usage"] = usage
    return out


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def _map_finish(reason: Optional[str]) -> Optional[str]:
    # engine reasons → OpenAI finish_reason values
    if reason in (None, "stop", "length"):
        return reason
    if reason == "cancelled":
        return "stop"
    return "stop" if reason else None


# --------------------------- stream folding --------------------------------


async def chat_stream(
    outputs: AsyncIterator[BackendOutput], rid: str, model: str,
    parser=None,
) -> AsyncIterator[dict]:
    """Fold BackendOutputs into chat.completion.chunk frames.

    ``parser`` (llm.parsers.StreamParserPipeline) re-splits decoded text
    into content / reasoning_content / tool_calls deltas."""
    created = int(time.time())
    yield chat_chunk(rid, model, created, role="assistant", content="")
    prompt_tokens = 0
    cum = 0
    reason = "stop"
    saw_tool_calls = False

    def _frames(text):
        nonlocal saw_tool_calls
        if parser is None:
            if text:
                yield chat_chunk(rid, model, created, content=text)
            return
        d = parser.push(text)
        if not d.empty:
            saw_tool_calls = saw_tool_calls or bool(d.tool_calls)
            yield chat_chunk(
                rid, model, created, content=d.content or None,
                reasoning=d.reasoning, tool_calls=d.tool_calls,
            )

    async for out in outputs:
        prompt_tokens = out.num_prompt_tokens or prompt_tokens
        cum = out.cum_tokens or cum
        if out.finish_reason is not None:
            reason = out.finish_reason
            for f in _frames(out.text or ""):
                yield f
            break
        for f in _frames(out.text or ""):
            yield f
    if parser is not None:
        d = parser.flush()
        if not d.empty:
            saw_tool_calls = saw_tool_calls or bool(d.tool_calls)
            yield chat_chunk(
                rid, model, created, content=d.content or None,
                reasoning=d.reasoning, tool_calls=d.tool_calls,
            )
    finish = _map_finish(reason) or "stop"
    if saw_tool_calls and finish == "stop":
        finish = "tool_calls"
    yield chat_chunk(
        rid, model, created, finish_reason=finish,
        usage=usage_dict(prompt_tokens, cum),
    )


async def completion_stream(
    outputs: AsyncIterator[BackendOutput], rid: str, model: str
) -> AsyncIterator[dict]:
    created = int(time.time())
    prompt_tokens = 0
    cum = 0
    reason = "stop"
    async for out in outputs:
        prompt_tokens = out.num_prompt_tokens or prompt_tokens
        cum = out.cum_tokens or cum
        if out.finish_reason is not None:
            reason = out.finish_reason
            if out.text:
                yield completion_chunk(rid, model, created, text=out.text)
            break
        if out.text:
            yield completion_chunk(rid, model, created, text=out.text)
    yield completion_chunk(
        rid, model, created, finish_reason=_map_finish(reason) or "stop",
        usage=usage_dict(prompt_tokens, cum),
    )


# ---------------------------- aggregation ----------------------------------


async def aggregate_chat(chunks: AsyncIterator[dict]) -> dict:
    """Collapse a chunk stream into one chat.completion response
    (ref: aggregator.rs:691 — used for stream=false)."""
    rid = model = ""
    created = 0
    text_parts: List[str] = []
    reasoning_parts: List[str] = []
    tool_calls: List[dict] = []
    role = "assistant"
    finish = "stop"
    usage = None
    async for c in chunks:
        rid, model, created = c["id"], c["model"], c["created"]
        choice = c["choices"][0]
        delta = choice.get("delta", {})
        if delta.get("role"):
            role = delta["role"]
        if delta.get("content"):
            text_parts.append(delta["content"])
        if delta.get("reasoning_content"):
            reasoning_parts.append(delta["reasoning_content"])
        if delta.get("tool_calls"):
            tool_calls.extend(delta["tool_calls"])
        if choice.get("finish_reason"):
            finish = choice["finish_reason"]
        if c.get("usage"):
            usage = c["usage"]
    message: dict = {"role": role, "content": "".join(text_parts)}
    if reasoning_parts:
        message["reasoning_content"] = "".join(reasoning_parts)
    if tool_calls:
        message["tool_calls"] = tool_calls
    return {
        "id": rid,
        "object": "chat.completion",
        "created": created,
        "model": model,
        "choices": [
            {"index": 0, "message": message, "finish_reason": finish}
        ],
        "usage": usage or usage_dict(0, 0),
    }


async def aggregate_completion(chunks: AsyncIterator[dict]) -> dict:
    rid = model = ""
    created = 0
    text_parts: List[str] = []
    finish = "stop"
    usage = None
    async for c in chunks:
        rid, model, created = c["id"], c["model"], c["created"]
        choice = c["choices"][0]
        if choice.get("text"):
            text_parts.append(choice["text"])
        if choice.get("finish_reason"):
            finish = choice["finish_reason"]
        if c.get("usage"):
            usage = c["usage"]
    return {
        "id": rid,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [
            {"index": 0, "text": "".join(text_parts),
             "finish_reason": finish, "logprobs": None}
        ],
        "usage": usage or usage_dict(0, 0),
    }


# --------------------------- responses API ---------------------------------
# (ref: the /v1/responses route in lib/llm/src/http/service/openai.rs:714 —
#  the OpenAI Responses surface mapped onto the chat pipeline)


def response_id() -> str:
    return f"resp-{uuid.uuid4().hex}"


def _responses_input_to_messages(inp, instructions=None) -> List[dict]:
    """Responses ``input`` (string | message list) → chat messages."""
    messages: List[dict] = []
    if instructions:
        messages.append({"role": "system", "content": str(instructions)})
    if isinstance(inp, str):
        messages.append({"role": "user", "content": inp})
        return messages
    if not isinstance(inp, list):
        raise RequestError("input must be a string or a list of messages")
    for item in inp:
        if not isinstance(item, dict):
            raise RequestError("input items must be message objects")
        role = item.get("role", "user")
        content = item.get("content", "")
        if isinstance(content, list):
            # content parts: keep the text parts
            content = "".join(
                p.get("text", "") for p in content
                if isinstance(p, dict)
                and p.get("type") in ("input_text", "output_text", "text")
            )
        messages.append({"role": role, "content": content})
    return messages


def responses_to_chat(req: dict) -> dict:
    """Translate a /v1/responses body into the chat-pipeline request."""
    if "input" not in req:
        raise RequestError("missing 'input'")
    body: dict = {
        "model": req.get("model", ""),
        "messages": _responses_input_to_messages(
            req["input"], req.get("instructions")
        ),
    }
    if req.get("max_output_tokens") is not None:
        body["max_tokens"] = req["max_output_tokens"]
    for key in ("temperature", "top_p", "seed", "stop"):
        if req.get(key) is not None:
            body[key] = req[key]
    _validate_sampling(body)
    return body


def response_object(
    rid: str, model: str, text: str, usage: Optional[dict],
    status: str = "completed",
) -> dict:
    usage = usage or usage_dict(0, 0)
    return {
        "id": rid,
        "object": "response",
        "created_at": int(time.time()),
        "status": status,
        "model": model,
        "output": [{
            "type": "message",
            "id": f"{rid}-msg0",
            "status": status,
            "role": "assistant",
            "content": [{"type": "output_text", "text": text,
                         "annotations": []}],
        }],
        "usage": {
            "input_tokens": usage.get("prompt_tokens", 0),
            "output_tokens": usage.get("completion_tokens", 0),
            "total_tokens": usage.get("total_tokens", 0),
        },
    }


def chat_to_response(agg: dict, rid: str, model: str) -> dict:
    """Aggregated chat.completion → Responses object."""
    choice = agg["choices"][0]
    finish = choice.get("finish_reason")
    return response_object(
        rid, model, choice["message"].get("content") or "",
        agg.get("usage"),
        status="completed" if finish in ("stop", "tool_calls", "length")
        else "incomplete",
    )


async def responses_stream(
    chunks: AsyncIterator[dict], rid: str, model: str
) -> AsyncIterator[tuple]:
    """chat.completion.chunk stream → (event_type, payload) Responses SSE
    events: response.created → response.output_text.delta* →
    response.completed."""
    yield "response.created", {
        "type": "response.created",
        "response": {"id": rid, "object": "response",
                     "status": "in_progress", "model": model},
    }
    parts: List[str] = []
    usage = None
    async for c in chunks:
        delta = c["choices"][0].get("delta", {})
        if c.get("usage"):
            usage = c["usage"]
        text = delta.get("content")
        if text:
            parts.append(text)
            yield "response.output_text.delta", {
                "type": "response.output_text.delta",
                "item_id": f"{rid}-msg0",
                "output_index": 0,
                "delta": text,
            }
    yield "response.completed", {
        "type": "response.completed",
        "response": response_object(rid, model, "".join(parts), usage),
    }


# ------------------------------- SSE ---------------------------------------


def sse_frame(payload: dict) -> str:
    return f"data: {json.dumps(payload, separators=(',', ':'))}\n\n"


def sse_event(event: str, payload: dict) -> str:
    return (f"event: {event}\n"
            f"data: {json.dumps(payload, separators=(',', ':'))}\n\n")


def models_response(models: List[dict]) -> dict:
    return {
        "object": "list",
        "data": [
            {"id": m["name"], "object": "model",
             "created": m.get("created", 0), "owned_by": "dynamo-tpu"}
            for m in models
        ],
    }
