"""The streaming engine abstraction (a copy of ``AsyncEngine`` from
``dynamo_tpu.runtime.engine``; the pipeline operators come with the HTTP
slice).

``AsyncEngine`` is the universal unit of composition (ref: lib/runtime/src/
engine.rs:201): a single request in, an async stream of responses out, with a
:class:`Context` for cancellation.
"""

from __future__ import annotations

import abc
from typing import AsyncIterator, Generic, TypeVar

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
