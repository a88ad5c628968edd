"""Pipeline builders: frontend → preprocessor → backend → migration → router
over the cluster, or → backend → an in-process engine.

A copy of ``build_routed_pipeline``, ``PushSink``, ``build_local_pipeline``
and ``make_kv_sink`` of ``dynamo_tpu.llm.entrypoint`` (ref:
lib/llm/src/entrypoint/input/common.rs:226,303-310). The returned engine
accepts OpenAI request dicts and yields :class:`~.protocols.BackendOutput`;
the HTTP layer folds those into OpenAI SSE frames. ``make_kv_sink`` builds
the KV-aware routing sink that ``--router-mode kv`` puts in place of
``PushSink``. Multimodal cards are refused; the embeddings pipeline waits
for its slice (ROADMAP.md queue A, item 7).
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Optional

from ..runtime.component import Client
from ..runtime.context import Context
from ..runtime.engine import AsyncEngine, link
from .backend import Backend
from .discovery import ModelDeploymentCard
from .migration import Migration
from .preprocessor import Preprocessor


class PushSink(AsyncEngine):
    """Routing sink over a component Client (ref: push_router.rs:33).

    Modes: round_robin | random.
    """

    def __init__(self, client: Client, mode: str = "round_robin"):
        self.client = client
        self.mode = mode

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        if self.mode == "random":
            return self.client.random(request, context)
        return self.client.round_robin(request, context)


def build_routed_pipeline(
    card: ModelDeploymentCard,
    client: Client,
    *,
    router_mode: str = "round_robin",
    sink: Optional[AsyncEngine] = None,
) -> AsyncEngine:
    """OpenAI dict in → BackendOutput stream out, over the cluster.

    ``sink`` (from :func:`make_kv_sink`) routes in place of the
    ``router_mode`` ``PushSink``. A card that advertises multimodal
    support is refused: the encode-prefill-decode flow is not ported yet
    (ROADMAP.md queue A, item 7)."""
    if (card.runtime_config or {}).get("multimodal"):
        raise NotImplementedError(
            f"model {card.name!r} asks for multimodal serving, which "
            "dynamo_tpu_torch does not serve yet (ROADMAP.md queue A, "
            "item 7)"
        )
    tokenizer = card.load_tokenizer()
    pre = Preprocessor(
        tokenizer,
        model_name=card.name,
        max_context_len=card.context_length,
    )
    back = Backend(tokenizer)
    inner = sink or PushSink(client, router_mode)
    return link(pre, back, Migration(inner, card.migration_limit))


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


async def make_kv_sink(card: ModelDeploymentCard, client: Client):
    """Build + start a KV-aware routing sink for ``build_routed_pipeline``
    (ref: KvPushRouter kv_router.rs:423), with the router's default
    config. Returns ``(sink, router)`` so the caller can ``router.stop()``
    at teardown."""
    from ..router.kv_router import KvPushRouter, KvRouter

    router = KvRouter(client, client.endpoint.component,
                      block_size=card.kv_block_size)
    await router.start()
    return KvPushRouter(router), router
