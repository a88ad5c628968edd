"""Hot-path marker for dynalint (``dynamo_tpu.analysis``), copied so the
port's serving loop carries the same annotations.

``@hot_path`` is a zero-cost annotation: it returns the function
unchanged at runtime. Its only effect is static — dynalint treats the
body of a decorated function as a serving hot path and applies the
strict DT1xx host-sync rules there, even in modules outside the
analyzer's hot-module allowlist.

Use it on functions that run per-token or per-batch in the serving
loop (dispatch, fetch, unpack, schedule). Do not use it on setup,
weight-loading, or teardown code; a ``jax.device_get`` there is fine.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def hot_path(fn: F) -> F:
    """Mark ``fn`` as a serving hot path for static analysis (no-op)."""
    fn.__dynalint_hot_path__ = True
    return fn
