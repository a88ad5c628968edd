"""Engine-serving wiring of the worker (ref: the common shape of
components/backends/*/src/dynamo/*/main.py — create runtime, serve generate +
clear_kv_blocks, attach publishers, register the model, drain on signal).

A copy of ``dynamo_tpu.serving`` for the aggregated path this package
serves. Health probes and the planner's degradation watcher are refused by
``utils.config.check_supported`` (ROADMAP.md queue A, item 1d); the
embeddings endpoint (item 7), the multimodal encode handler (item 7) and the
preemption coordinator (item 2) are not ported, so the card advertises chat
and completions only.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass
from typing import Optional

from .engine.config import EngineConfig
from .engine.engine import EngineCore
from .llm.discovery import ModelDeploymentCard, register_llm
from .llm.tokenizer import Tokenizer
from .router.publisher import KvEventPublisher, WorkerMetricsPublisher
from .runtime.component import DistributedRuntime
from .runtime.signals import install_shutdown_signals
from .runtime.tasks import spawn_logged
from .utils.logging import get_logger

log = get_logger("serving")


@dataclass
class ServeOptions:
    name: str
    component: str = "backend"
    endpoint: str = "generate"
    advertise_host: str = "127.0.0.1"
    migration_limit: int = 3
    tool_call_parser: Optional[str] = None
    reasoning_parser: Optional[str] = None


async def serve_engine(
    runtime: DistributedRuntime,
    engine: EngineCore,
    eng_cfg: EngineConfig,
    opts: ServeOptions,
    tokenizer: Optional[Tokenizer] = None,
):
    """Serve ``engine`` on the cluster; returns the served endpoint and the
    publishers (caller owns shutdown ordering)."""
    await engine.start()
    endpoint = (runtime.namespace().component(opts.component)
                .endpoint(opts.endpoint))
    served = await endpoint.serve_endpoint(
        engine,
        advertise_host=opts.advertise_host,
        metadata={"model": opts.name},
    )

    # KV events + load metrics for the KV-aware router / aggregator
    # (ref: publisher.rs; the in-process seam replaces the ZMQ relay)
    kv_pub = KvEventPublisher(endpoint.component, runtime.primary_lease)
    kv_pub.start()
    engine.kv_event_sink = kv_pub.sink

    metrics_pub = WorkerMetricsPublisher(
        endpoint.component, runtime.primary_lease, lambda: engine.stats
    )
    metrics_pub.start()

    async def clear_kv(request, context):
        engine.clear_kv_blocks()
        yield {"cleared": True}

    clear_ep = (runtime.namespace().component(opts.component)
                .endpoint("clear_kv_blocks"))
    await clear_ep.serve_endpoint(
        clear_kv, advertise_host=opts.advertise_host
    )

    if tokenizer is not None:
        card = ModelDeploymentCard(
            name=opts.name,
            model_type=["chat", "completions"],
            tokenizer_json=tokenizer.to_json_str(),
            chat_template=tokenizer.chat_template,
            context_length=eng_cfg.max_model_len,
            kv_block_size=eng_cfg.block_size,
            migration_limit=opts.migration_limit,
            eos_token_ids=list(tokenizer.eos_token_ids),
            bos_token_id=tokenizer.bos_token_id,
            runtime_config={
                "total_kv_blocks": eng_cfg.num_blocks,
                "max_num_seqs": eng_cfg.max_num_seqs,
                "max_num_batched_tokens": eng_cfg.max_num_batched_tokens,
            },
            tool_call_parser=opts.tool_call_parser,
            reasoning_parser=opts.reasoning_parser,
        )
        await register_llm(endpoint, card)

    return served, kv_pub, metrics_pub


async def run_until_shutdown(
    runtime: DistributedRuntime, engine: EngineCore,
    served, kv_pub, metrics_pub,
) -> None:
    """Install the graceful drain on SIGINT/SIGTERM, then block on runtime
    shutdown. The JAX package also builds a ``PreemptionCoordinator`` here
    (maintenance notices on SIGUSR1 evacuate KV before the drain); it waits
    for the preemption slice (ROADMAP.md queue A, item 2)."""
    loop = asyncio.get_running_loop()

    def _graceful():
        log.info("drain requested — deregistering and finishing in-flight "
                 "work (deadline %.1fs)", runtime.config.drain_timeout_s)
        spawn_logged(_shutdown(), name="drain-shutdown")

    async def _shutdown():
        await served.drain_and_stop(
            deadline_s=runtime.config.drain_timeout_s
        )
        await kv_pub.stop()
        await metrics_pub.stop()
        await engine.stop()
        await runtime.shutdown()

    # the first signal starts the drain; a REPEAT signal while draining
    # hard-exits (see runtime/signals.py)
    install_shutdown_signals(_graceful, loop=loop, name="worker-drain")
    await runtime.shutdown_event.wait()


def load_tokenizer(path: Optional[str]) -> Optional[Tokenizer]:
    """A ``tokenizer.json`` file, or a local HuggingFace directory."""
    if path is None:
        return None
    if os.path.isdir(path):
        return Tokenizer.from_pretrained_dir(path)
    return Tokenizer.from_file(path)
