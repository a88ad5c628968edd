"""Frontend process: HTTP service + model discovery in one process.

Role-equivalent to the reference's ``python -m dynamo.frontend``
(ref: components/frontend/src/dynamo/frontend/main.py): starts the OpenAI
HTTP server, watches the store for registered models, and builds a routed
pipeline per model as workers come and go.

    python -m dynamo_tpu_torch.frontend --port 8000 --router-mode round_robin

A copy of ``dynamo_tpu.frontend.__main__``: round-robin, random and
KV-aware routing (``--router-mode kv``: one ``KvRouter`` per model, fed by
the workers' ``kv_events``), ``--busy-threshold``, admission control,
``--request-timeout``, the ``frontend_stats`` publisher, and the planner's
degradation watcher, which applies ``planner/{ns}/degradation`` orders to
admission (tier shedding needs ``--max-concurrent-requests``: without it
there is no admission controller, as in the JAX frontend). A model whose
card advertises ``embeddings`` gets ``/v1/embeddings`` over its workers'
``embed`` endpoint; one whose card advertises ``multimodal`` gets the
encode-prefill-decode preprocessor over the advertised ``encode`` endpoint.
``--grpc-port`` (KServe) is refused. The frontend never touches the GPU.
With ``--port 0`` the log line ``frontend ready on HOST:PORT`` names the
port bound.
"""

from __future__ import annotations

import argparse
import asyncio

from ..llm.discovery import ModelDeploymentCard, ModelWatcher
from ..llm.entrypoint import (
    EmbeddingsPipeline, build_routed_pipeline, make_kv_sink,
)
from ..runtime import codec
from ..runtime.component import DistributedRuntime
from ..runtime.signals import install_shutdown_signals
from ..runtime.tasks import spawn_logged
from ..utils.config import RuntimeConfig
from ..utils.logging import get_logger
from .service import HttpService, ModelEntry, ModelManager

log = get_logger("frontend")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo-tpu-torch OpenAI frontend")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000,
                   help="HTTP port (0 picks a free one)")
    p.add_argument("--store-addr", default=None)
    p.add_argument("--namespace", default=None)
    p.add_argument(
        "--router-mode", default="round_robin",
        choices=["round_robin", "random", "kv"],
    )
    p.add_argument(
        "--grpc-port", type=int, default=0,
        help="KServe v2 gRPC port (not served yet; 0 disables)",
    )
    p.add_argument(
        "--busy-threshold", type=float, default=0.0,
        help="reject with 503 when every worker's KV usage is above this "
             "fraction (0 disables; ref: push_router.rs busy rejection)",
    )
    p.add_argument(
        "--stats-publish-interval", type=float, default=10.0,
        help="seconds between frontend_stats publishes for the planner "
             "(0 disables)",
    )
    p.add_argument(
        "--max-concurrent-requests", type=int, default=None,
        help="admission control: concurrent requests before queueing "
             "(default from DYNTPU_MAX_CONCURRENT_REQUESTS; 0/unset "
             "disables)",
    )
    p.add_argument(
        "--max-queued-requests", type=int, default=None,
        help="admission queue depth beyond which requests are shed with "
             "429 + Retry-After",
    )
    p.add_argument(
        "--request-timeout", type=float, default=None,
        help="per-request deadline in seconds, propagated end-to-end to "
             "workers (default from DYNTPU_REQUEST_TIMEOUT_S)",
    )
    return p.parse_args(argv)


def check_supported(args: argparse.Namespace) -> None:
    """Refuse every flag whose path this package does not serve yet."""
    if args.grpc_port:
        raise NotImplementedError(
            "--grpc-port needs the KServe gRPC service (ROADMAP.md queue "
            "A, item 7d), which dynamo_tpu_torch does not serve yet"
        )


async def run_frontend(args: argparse.Namespace) -> None:
    check_supported(args)
    config = RuntimeConfig.from_settings()
    if args.store_addr:
        config.store_addr = args.store_addr
    if args.namespace:
        config.namespace = args.namespace
    runtime = await DistributedRuntime.from_settings(config)

    manager = ModelManager()
    max_concurrent = (args.max_concurrent_requests
                      if args.max_concurrent_requests is not None
                      else config.max_concurrent_requests)
    max_queued = (args.max_queued_requests
                  if args.max_queued_requests is not None
                  else config.max_queued_requests)
    timeout_s = (args.request_timeout if args.request_timeout is not None
                 else config.request_timeout_s)
    service = HttpService(
        manager, host=args.host, port=args.port, metrics=runtime.metrics,
        max_concurrent_requests=max_concurrent if max_concurrent else None,
        max_queued_requests=max_queued,
        request_timeout_s=timeout_s if timeout_s and timeout_s > 0 else None,
        retry_after_s=config.retry_after_s,
    )
    clients = {}
    kv_routers = {}
    monitors = {}

    async def on_add(card: ModelDeploymentCard, entry: dict) -> None:
        endpoint = (
            runtime.namespace(entry["namespace"])
            .component(entry["component"]).endpoint(entry["endpoint"])
        )
        client = await endpoint.client()
        clients[card.name] = client
        if args.busy_threshold > 0:
            from ..router.monitor import WorkerMonitor

            monitor = WorkerMonitor(
                client, busy_threshold=args.busy_threshold
            )
            await monitor.start()
            monitor.attach()
            monitors[card.name] = monitor
        sink = None
        if args.router_mode == "kv":
            sink, kv_routers[card.name] = await make_kv_sink(card, client)
        tokenizer = card.load_tokenizer()  # shared by every pipeline piece
        mm_processor = None
        mm_cfg = (card.runtime_config or {}).get("multimodal")
        if mm_cfg:
            from ..multimodal.processor import MultimodalProcessor

            encode_client = await (
                runtime.namespace(entry["namespace"])
                .component(mm_cfg["component"])
                .endpoint(mm_cfg.get("endpoint", "encode")).client()
            )
            clients[card.name + "/encode"] = encode_client
            mm_processor = MultimodalProcessor(
                tokenizer,
                tokens_per_image=int(mm_cfg["tokens_per_image"]),
                encode_client=encode_client,
            )
        engine = build_routed_pipeline(
            card, client, router_mode=args.router_mode, sink=sink,
            mm_processor=mm_processor, tokenizer=tokenizer,
        )
        # embeddings ride the worker's encode-only "embed" endpoint; the
        # card advertises the capability (mocker-backed models don't have
        # it and their requests 400 immediately)
        embed_engine = None
        if "embeddings" in card.model_type:
            embed_client = await (
                runtime.namespace(entry["namespace"])
                .component(entry["component"]).endpoint("embed").client()
            )
            clients[card.name + "/embed"] = embed_client
            embed_engine = EmbeddingsPipeline(card, embed_client,
                                              tokenizer=tokenizer)
        manager.register(ModelEntry(
            name=card.name, engine=engine,
            embed_engine=embed_engine,
            chat="chat" in card.model_type,
            completions="completions" in card.model_type,
            tool_call_parser=card.tool_call_parser,
            reasoning_parser=card.reasoning_parser,
        ))

    async def on_remove(name: str) -> None:
        manager.remove(name)
        monitor = monitors.pop(name, None)
        if monitor:
            await monitor.stop()
        router = kv_routers.pop(name, None)
        if router:
            await router.stop()
        client = clients.pop(name, None)
        if client:
            await client.stop()
        embed_client = clients.pop(name + "/embed", None)
        if embed_client:
            await embed_client.stop()
        encode_client = clients.pop(name + "/encode", None)
        if encode_client:
            await encode_client.stop()

    watcher = ModelWatcher(runtime, on_add, on_remove)
    await watcher.start()
    await service.start()

    stats_task = None
    if args.stats_publish_interval > 0:
        subject = f"{runtime.namespace().name}/frontend_stats"

        async def _publish_stats():
            while True:
                await asyncio.sleep(args.stats_publish_interval)
                win = service.window_stats.drain()
                win["interval_s"] = args.stats_publish_interval
                # live pressure signals riding the same payload: admission
                # backlog and router breaker states (planner feeds)
                if service.admission is not None:
                    win["queue_depth"] = service.admission.queue_depth
                win["breaker_open"] = sum(
                    1
                    for router in kv_routers.values()
                    for state in router.breakers.states().values()
                    if state != "closed"
                )
                try:
                    await runtime.store.publish(subject, codec.packb(win))
                except Exception as exc:
                    log.warning("frontend stats publish failed: %s", exc)

        stats_task = asyncio.create_task(_publish_stats())

    # the planner's degradation ladder orders tier shedding through the
    # store; apply it to admission as the orders move
    from ..planner.degradation import DegradationWatcher

    degradation_watcher = DegradationWatcher(
        runtime.store, runtime.namespace().name,
        service.apply_degradation,
    )
    degradation_watcher.start()

    async def _shutdown():
        if stats_task is not None:
            stats_task.cancel()
        await degradation_watcher.stop()
        await watcher.stop()
        await service.stop()
        await runtime.shutdown()

    install_shutdown_signals(
        lambda: spawn_logged(_shutdown(), name="frontend-shutdown"),
        loop=asyncio.get_running_loop(), name="frontend",
    )

    log.info("frontend ready on %s:%d", args.host, service.port)
    await runtime.shutdown_event.wait()


def main(argv=None) -> None:
    asyncio.run(run_frontend(parse_args(argv)))


if __name__ == "__main__":
    main()
