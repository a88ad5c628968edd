"""Model discovery: deployment cards, registration, and the model watcher.

Role-equivalent to the reference's discovery stack (ref: lib/llm/src/
discovery/{model_entry.rs:14, watcher.rs:48,257}, model_card.rs:93,
local_model.rs:403): a worker publishes its ``ModelDeploymentCard`` (MDC) to
the store and a ``ModelEntry`` under its primary lease; the frontend's
``ModelWatcher`` reacts to puts/deletes by building/removing serving
pipelines dynamically.

A copy of ``dynamo_tpu.llm.discovery`` on the package's own codec: cards and
model entries are byte-equal to the JAX package's, so a frontend of either
package discovers the workers of both.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from ..runtime import codec
from ..runtime.component import Endpoint, MDC_ROOT, MODEL_ROOT, DistributedRuntime
from ..utils.logging import get_logger
from .tokenizer import Tokenizer

log = get_logger("discovery")


@dataclass
class ModelDeploymentCard:
    """Everything a frontend needs to serve a model
    (ref: model_card.rs:93 — tokenizer, context length, template, limits)."""

    name: str
    tokenizer_json: Optional[str] = None   # serialized tokenizer.json
    tokenizer_path: Optional[str] = None   # or a local file path
    chat_template: Optional[str] = None
    context_length: int = 8192
    kv_block_size: int = 16
    migration_limit: int = 3
    eos_token_ids: list = field(default_factory=list)
    bos_token_id: Optional[int] = None
    model_type: list = field(default_factory=lambda: ["chat", "completions"])
    runtime_config: dict = field(default_factory=dict)  # ModelRuntimeConfig
    # streaming output parsers (ref: lib/parsers): "hermes"|"json"|"pythonic"
    tool_call_parser: Optional[str] = None
    # truthy → split <think>…</think> into reasoning_content
    reasoning_parser: Optional[str] = None

    def to_wire(self) -> dict:
        return {
            "name": self.name,
            "tokenizer_json": self.tokenizer_json,
            "tokenizer_path": self.tokenizer_path,
            "chat_template": self.chat_template,
            "context_length": self.context_length,
            "kv_block_size": self.kv_block_size,
            "migration_limit": self.migration_limit,
            "eos_token_ids": self.eos_token_ids,
            "bos_token_id": self.bos_token_id,
            "model_type": self.model_type,
            "runtime_config": self.runtime_config,
            "tool_call_parser": self.tool_call_parser,
            "reasoning_parser": self.reasoning_parser,
        }

    @staticmethod
    def from_wire(d: dict) -> "ModelDeploymentCard":
        return ModelDeploymentCard(
            name=d["name"],
            tokenizer_json=d.get("tokenizer_json"),
            tokenizer_path=d.get("tokenizer_path"),
            chat_template=d.get("chat_template"),
            context_length=int(d.get("context_length", 8192)),
            kv_block_size=int(d.get("kv_block_size", 16)),
            migration_limit=int(d.get("migration_limit", 3)),
            eos_token_ids=list(d.get("eos_token_ids", [])),
            bos_token_id=d.get("bos_token_id"),
            model_type=list(d.get("model_type", ["chat", "completions"])),
            runtime_config=dict(d.get("runtime_config", {})),
            tool_call_parser=d.get("tool_call_parser"),
            reasoning_parser=d.get("reasoning_parser"),
        )

    def load_tokenizer(self) -> Tokenizer:
        kw = dict(
            eos_token_ids=self.eos_token_ids,
            bos_token_id=self.bos_token_id,
            chat_template=self.chat_template,
        )
        if self.tokenizer_json:
            return Tokenizer.from_json_str(self.tokenizer_json, **kw)
        if self.tokenizer_path:
            return Tokenizer.from_file(self.tokenizer_path, **kw)
        raise ValueError(f"MDC {self.name!r} carries no tokenizer")

    def mdc_key(self) -> str:
        return f"{MDC_ROOT}{self.name}"


def model_key(name: str, instance_id: int) -> str:
    return f"{MODEL_ROOT}{name}/{instance_id}"


async def register_llm(
    endpoint: Endpoint,
    card: ModelDeploymentCard,
    instance_id: Optional[int] = None,
) -> None:
    """Publish the MDC + a lease-attached ModelEntry
    (ref: bindings rust/lib.rs:146 register_llm, local_model.rs:403)."""
    runtime = endpoint.runtime
    await runtime.store.put(
        card.mdc_key(), codec.packb(card.to_wire())
    )
    entry = {
        "name": card.name,
        "namespace": endpoint.component.namespace.name,
        "component": endpoint.component.name,
        "endpoint": endpoint.name,
        "model_type": card.model_type,
    }
    key = model_key(card.name, instance_id or runtime.primary_lease)
    await runtime.store.put(
        key, codec.packb(entry),
        lease=runtime.primary_lease,
    )
    runtime.registered_models.append((endpoint.path, key))
    log.info("registered model %s on %s", card.name, endpoint.path)


class ModelWatcher:
    """Watches the model root; builds/removes pipelines on put/delete
    (ref: discovery/watcher.rs:48, handle_put :257)."""

    def __init__(
        self,
        runtime: DistributedRuntime,
        on_add: Callable,        # (card, entry_dict) -> awaitable
        on_remove: Callable,     # (model_name) -> awaitable
    ):
        self.runtime = runtime
        self.on_add = on_add
        self.on_remove = on_remove
        self._task: Optional[asyncio.Task] = None
        self._stream = None
        # model name → set of instance keys serving it
        self._instances: Dict[str, set] = {}

    async def start(self) -> None:
        # resilient watch: survives store restarts by catch-up or snapshot
        # reconcile; during the outage we keep serving the models we know
        # about (stale-while-revalidate) rather than tearing pipelines down
        snapshot, stream = await self.runtime.store.watch_prefix_resilient(
            MODEL_ROOT,
            grace_s=self.runtime.config.store_reconcile_grace_s,
        )
        self._stream = stream
        for key, value in snapshot:
            await self._handle_put(key, value)
        self._task = asyncio.create_task(self._loop(stream))

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
        if self._stream is not None:
            await self._stream.cancel()
            self._stream = None

    async def _loop(self, stream) -> None:
        while True:
            event = await stream.next()
            if event is None:
                return
            if event["event"] == "dropped":
                continue  # the resilient stream already resynced
            try:
                if event["event"] == "put":
                    await self._handle_put(event["key"], event["value"])
                elif event["event"] == "delete":
                    await self._handle_delete(event["key"])
            except Exception:
                log.exception("model watcher event failed")

    async def _handle_put(self, key: str, value: bytes) -> None:
        entry = codec.unpackb(value)
        name = entry["name"]
        known = self._instances.setdefault(name, set())
        if key in known:
            return
        first = not known
        known.add(key)
        if not first:
            return  # additional replica of an already-served model
        raw = await self.runtime.store.get(f"{MDC_ROOT}{name}")
        if raw is None:
            log.error("model %s announced but MDC missing", name)
            return
        card = ModelDeploymentCard.from_wire(codec.unpackb(raw))
        await self.on_add(card, entry)

    async def _handle_delete(self, key: str) -> None:
        name = key[len(MODEL_ROOT):].rsplit("/", 1)[0]
        known = self._instances.get(name)
        if known is None:
            return
        known.discard(key)
        if not known:
            del self._instances[name]
            await self.on_remove(name)
