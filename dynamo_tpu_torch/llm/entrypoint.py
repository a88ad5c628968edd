"""Pipeline builder: frontend → preprocessor → backend → in-process engine.

A copy of ``build_local_pipeline`` from ``dynamo_tpu.llm.entrypoint`` (ref:
lib/llm/src/entrypoint/input/common.rs:226,303-310); the routed pipeline,
its push sink and the embeddings pipeline come with the distributed slice.
The returned engine accepts OpenAI request dicts and yields
:class:`~.protocols.BackendOutput`; the HTTP layer folds those into OpenAI
SSE frames.
"""

from __future__ import annotations

from ..runtime.engine import AsyncEngine, link
from .backend import Backend
from .preprocessor import Preprocessor


def build_local_pipeline(
    engine: AsyncEngine,
    tokenizer,
    model_name: str = "local",
    max_context_len: int = 8192,
) -> AsyncEngine:
    """OpenAI dict in → BackendOutput stream out, over an IN-PROCESS engine
    (the dynamo-run quickstart shape: no store, no transport — ref:
    EngineConfig::StaticFull, entrypoint.rs:44)."""
    pre = Preprocessor(
        tokenizer, model_name=model_name, max_context_len=max_context_len
    )
    back = Backend(tokenizer)
    return link(pre, back, engine)
