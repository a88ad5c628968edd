"""Pipeline builders: frontend → preprocessor → backend → migration → router
over the cluster, or → backend → an in-process engine.

A copy of ``build_routed_pipeline``, ``PushSink``, ``EmbeddingsPipeline``,
``build_local_pipeline`` and ``make_kv_sink`` of
``dynamo_tpu.llm.entrypoint`` (ref: lib/llm/src/entrypoint/input/
common.rs:226,303-310). The returned engine accepts OpenAI request dicts and
yields :class:`~.protocols.BackendOutput`; the HTTP layer folds those into
OpenAI SSE frames. With a ``mm_processor`` the preprocessor runs the
encode-prefill-decode flow for requests that carry images.
``EmbeddingsPipeline`` serves ``/v1/embeddings`` over a worker's ``embed``
endpoint. ``make_kv_sink`` builds the KV-aware routing sink that
``--router-mode kv`` puts in place of ``PushSink``.
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
    mm_processor=None,
    tokenizer=None,
) -> AsyncEngine:
    """OpenAI dict in → BackendOutput stream out, over the cluster.

    ``sink`` (from :func:`make_kv_sink`) routes in place of the
    ``router_mode`` ``PushSink``. ``mm_processor``
    (multimodal.MultimodalProcessor) upgrades the preprocessor to the
    encode-prefill-decode flow for requests carrying image content parts.
    Pass ``tokenizer`` when the caller already loaded it (loading twice per
    registration doubles model-add latency)."""
    tokenizer = tokenizer or card.load_tokenizer()
    pre = Preprocessor(
        tokenizer,
        model_name=card.name,
        max_context_len=card.context_length,
    )
    if mm_processor is not None:
        from ..multimodal.processor import MultimodalPreprocessor

        pre = MultimodalPreprocessor(pre, mm_processor)
    back = Backend(tokenizer)
    inner = sink or PushSink(client, router_mode)
    return link(pre, back, Migration(inner, card.migration_limit))


class EmbeddingsPipeline:
    """Tokenise → worker ``embed`` endpoint → vectors
    (ref: the embeddings path of openai.rs:714; tokenisation mirrors the
    generation preprocessor, pooling happens on-device in the engine)."""

    def __init__(self, card: ModelDeploymentCard, client: Client,
                 tokenizer=None):
        # accept a shared tokenizer — loading twice per model registration
        # (once here, once in build_routed_pipeline) doubles add latency
        self.tokenizer = tokenizer or card.load_tokenizer()
        self.client = client
        self.max_context_len = card.context_length

    async def embed(self, inputs) -> tuple:
        """inputs: str | [str] | [int] | [[int]] → (vectors, prompt_tokens).
        Raises ValueError (→ HTTP 400) on any other shape."""
        if isinstance(inputs, str):
            inputs = [inputs]
        elif isinstance(inputs, list):
            if inputs and all(type(i) is int for i in inputs):
                inputs = [inputs]
        else:
            raise ValueError(
                "input must be a string, a list of strings, or token arrays"
            )
        batch = []
        for item in inputs:
            if isinstance(item, str):
                ids = self.tokenizer.encode(item)
            elif (isinstance(item, list)
                  and all(type(i) is int for i in item)):
                ids = list(item)
            else:
                raise ValueError(
                    "each input must be a string or an array of token ids"
                )
            if not ids:
                raise ValueError("empty embedding input")
            if len(ids) >= self.max_context_len:
                raise ValueError(
                    f"input of {len(ids)} tokens exceeds the "
                    f"{self.max_context_len}-token context"
                )
            batch.append(ids)
        prompt_tokens = sum(len(ids) for ids in batch)
        async for out in self.client.round_robin(
            {"token_ids_batch": batch}, Context()
        ):
            return out["embeddings"], prompt_tokens
        raise RuntimeError("embed endpoint returned no response")


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
