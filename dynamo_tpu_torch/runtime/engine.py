"""The streaming engine abstraction and pipeline operator graph (a copy of
``dynamo_tpu.runtime.engine``).

``AsyncEngine`` is the universal unit of composition (ref: lib/runtime/src/
engine.rs:201): a single request in, an async stream of responses out, with a
:class:`Context` for cancellation. ``Operator`` is a bidirectional pipeline
stage (ref: lib/runtime/src/pipeline.rs:31-58): it transforms the request on
the forward edge and the response stream on the backward edge. ``link``
chains operators into a served pipeline exactly like the reference's
``frontend → preprocessor → backend → migration → router`` chain
(ref: lib/llm/src/entrypoint/input/common.rs:226,303-310).
"""

from __future__ import annotations

import abc
from typing import Any, AsyncIterator, Generic, List, Optional, TypeVar

from .context import Context

Req = TypeVar("Req")
Resp = TypeVar("Resp")


class AsyncEngine(abc.ABC, Generic[Req, Resp]):
    """SingleIn → ManyOut streaming engine."""

    @abc.abstractmethod
    def generate(
        self, request: Req, context: Context
    ) -> AsyncIterator[Resp]:
        """Return an async iterator of responses for one request."""
        raise NotImplementedError


class Operator(abc.ABC):
    """A bidirectional pipeline stage.

    ``forward`` maps the incoming request to the downstream request type;
    ``backward`` wraps the downstream response stream into the upstream
    response type. Either may consult/extend the :class:`Context`.
    """

    async def forward(self, request: Any, context: Context) -> Any:
        return request

    def backward(
        self, stream: AsyncIterator[Any], request: Any, context: Context
    ) -> AsyncIterator[Any]:
        return stream


class _Linked(AsyncEngine):
    def __init__(self, operators: List[Operator], sink: AsyncEngine):
        self._operators = operators
        self._sink = sink

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        # forward edge: outermost operator first
        requests = [request]
        for op in self._operators:
            request = await op.forward(request, context)
            requests.append(request)
        stream = self._sink.generate(request, context)
        # backward edge: innermost operator first, each sees the request as it
        # existed at its own depth on the forward pass
        for op, req_at_depth in zip(reversed(self._operators), reversed(requests[:-1])):
            stream = op.backward(stream, req_at_depth, context)
        async for item in stream:
            yield item


def link(*stages: Any) -> AsyncEngine:
    """Chain operators ending in an AsyncEngine sink into one AsyncEngine."""
    if not stages:
        raise ValueError("link() needs at least a sink engine")
    *ops, sink = stages
    if not isinstance(sink, AsyncEngine):
        raise TypeError("last stage must be an AsyncEngine")
    for op in ops:
        if not isinstance(op, Operator):
            raise TypeError(f"intermediate stage {op!r} must be an Operator")
    return _Linked(list(ops), sink)


class FnEngine(AsyncEngine):
    """Adapt an ``async generator function (request, context)`` to AsyncEngine."""

    def __init__(self, fn):
        self._fn = fn

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        return self._fn(request, context)
