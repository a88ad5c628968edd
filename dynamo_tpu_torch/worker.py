"""Engine worker process: build the PyTorch engine, serve it, register the
model.

Role-equivalent to the reference's backend worker mains (ref: components/
backends/vllm/src/dynamo/vllm/main.py:184,325): create the runtime, start the
inference engine, expose ``generate`` (+ ``clear_kv_blocks``) endpoints, and
register the model so frontends discover it.

    python -m dynamo_tpu_torch.worker --model 1b --model-name demo \
        --tokenizer /path/tokenizer.json --store-addr 127.0.0.1:3280

A copy of ``dynamo_tpu.worker``: the parser keeps the JAX package's flags and
defaults, so a JAX command line parses unchanged, and adds ``--device``
(``cuda`` unless asked for the CPU; with no device given and no GPU present
the worker raises). It serves the aggregated path on one device with seeded
random weights or a local HF checkpoint (``--weights DIR``: its
``config.json`` overrides ``--model``, the tokenizer defaults to the
directory), bf16/int8/fp8 weights and KV, speculative decoding
(``--spec-mode ngram --spec-k K``), disaggregated prefill/decode
(``--disagg-mode prefill|decode``, with ``--disagg-queue`` for the store's
pull queue), the KVBM tiers (``--kvbm-host-blocks/-bytes``,
``--kvbm-disk-dir/-blocks``, ``--kvbm-remote``, ``--kvbm-distributed``,
``--kvbm-group*``), the radix prefix cache (on unless
``DYNTPU_PREFIX_ENABLED=0``) and the engine sizing flags; the control plane
(system server, health probes, degradation watcher, the preemption
coordinator behind ``SIGUSR1`` and ``POST /preempt``) comes from the
runtime settings, as in the JAX package.
Every flag whose path this package does not serve yet raises
``NotImplementedError`` naming the ROADMAP.md item that brings it.
"""

from __future__ import annotations

import argparse
import asyncio
import os

from .engine.config import EngineConfig, ModelConfig
from .engine.engine import InferenceEngine
from .ops import paged_attention as pa
from .runtime.component import DistributedRuntime
from .serving import ServeOptions, load_tokenizer, run_until_shutdown, serve_engine
from .utils.config import RuntimeConfig
from .utils.logging import get_logger

log = get_logger("worker")

MODEL_PRESETS = {
    "tiny": ModelConfig.tiny,
    "1b": ModelConfig.llama3_1b,
    "8b": ModelConfig.llama3_8b,
    "70b": None,    # needs more than one device
}
# the JAX package's attention names: its Pallas kernel is this package's
# CUDA kernel
ATTENTION_IMPLS = {"pallas": "kernel", "kernel": "kernel",
                   "einsum": "einsum", "auto": None}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo-tpu-torch engine worker")
    p.add_argument("--model", default="tiny", choices=sorted(MODEL_PRESETS))
    p.add_argument("--model-name", default=None,
                   help="served model name (default: preset name)")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer.json path or HF model dir")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "kernel versions on the CPU)")
    p.add_argument("--tool-call-parser", default=None,
                   choices=["hermes", "json", "pythonic"],
                   help="streaming tool-call parser advertised in the MDC")
    p.add_argument("--reasoning-parser", default=None,
                   help="set to split <think>…</think> into "
                        "reasoning_content (e.g. 'think')")
    p.add_argument("--weights", default=None,
                   help="HF checkpoint dir [*.safetensors + config.json, "
                        "which overrides --model]; tokenizer defaults to "
                        "this dir")
    p.add_argument("--store-addr", default=None)
    p.add_argument("--namespace", default=None)
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-blocks", type=int, default=2048)
    p.add_argument("--max-num-seqs", type=int, default=64)
    p.add_argument("--max-batched-tokens", type=int, default=512)
    p.add_argument("--max-model-len", type=int, default=8192)
    p.add_argument("--mesh", default="1,1", help="dp,tp mesh axis sizes "
                   "(only 1,1 is served)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages (only 1 is served)")
    p.add_argument("--pp-microbatches", type=int, default=4)
    p.add_argument("--migration-limit", type=int, default=3)
    p.add_argument("--spec-mode", default=None, choices=["off", "ngram"],
                   help="speculative decoding: device-side n-gram drafting "
                        "+ batched verify (default: DYNTPU_SPEC_MODE, off)")
    p.add_argument("--spec-k", type=int, default=None,
                   help="max draft tokens verified per window "
                        "(default: DYNTPU_SPEC_K, 4)")
    p.add_argument("--attention-impl", default="pallas",
                   choices=sorted(ATTENTION_IMPLS),
                   help="attention path: 'pallas' (the JAX name) and "
                        "'kernel' run the CUDA paged-attention kernel, "
                        "'einsum' the gathered context; 'auto' is not "
                        "served yet")
    p.add_argument("--weight-dtype", default=None,
                   choices=["bf16", "int8", "fp8"],
                   help="weight storage dtype: int8/fp8 quantize at load "
                        "time with per-channel scales "
                        "(default: DYNTPU_WEIGHT_DTYPE, bf16)")
    p.add_argument("--kv-dtype", default=None,
                   choices=["bf16", "int8", "fp8"],
                   help="paged-KV storage dtype: int8/fp8 halve KV bytes "
                        "per token with per-token scales "
                        "(default: DYNTPU_KV_DTYPE, bf16)")
    p.add_argument("--prefill-chunk-tokens", type=int, default=None,
                   help="cap each prefill chunk at this many tokens so long "
                        "prompts interleave with running decodes instead of "
                        "stalling them (0 = whole-bucket prefill; default: "
                        "DYNTPU_PREFILL_CHUNK_TOKENS, 0)")
    p.add_argument("--drain-timeout", type=float, default=None,
                   help="seconds in-flight streams get to finish on graceful "
                        "drain before being stopped for client migration "
                        "(default: DYNTPU_DRAIN_TIMEOUT_S, 30)")
    p.add_argument("--advertise-host", default="127.0.0.1")
    p.add_argument("--disagg-mode", default="agg",
                   choices=["agg", "decode", "prefill"])
    p.add_argument("--prefill-component", default="prefill")
    p.add_argument("--min-remote-prefill-tokens", type=int, default=32)
    p.add_argument("--disagg-queue", action="store_true")
    p.add_argument("--disagg-queue-name", default="prefill_queue")
    p.add_argument("--kvbm-host-blocks", type=int, default=0)
    p.add_argument("--kvbm-host-bytes", type=int, default=0)
    p.add_argument("--kvbm-disk-dir", default=None)
    p.add_argument("--kvbm-disk-blocks", type=int, default=0)
    p.add_argument("--kvbm-remote", action="store_true")
    p.add_argument("--kvbm-distributed", action="store_true")
    p.add_argument("--kvbm-group", default=None)
    p.add_argument("--kvbm-group-role", choices=["leader", "worker"],
                   default="worker")
    p.add_argument("--kvbm-group-size", type=int, default=1)
    # the rest select paths that are not served yet; their defaults are the
    # JAX package's
    p.add_argument("--mm-encoder", action="store_true")
    p.add_argument("--mm-image-size", type=int, default=32)
    p.add_argument("--mm-patch-size", type=int, default=8)
    p.add_argument("--mm-encode-component", default=None)
    p.add_argument("--coordinator",
                   default=os.environ.get("JAX_COORDINATOR_ADDRESS"))
    p.add_argument("--num-hosts", type=int,
                   default=int(os.environ.get("JAX_PROCESS_COUNT", "1")))
    p.add_argument("--host-index", type=int,
                   default=int(os.environ.get("JAX_PROCESS_INDEX", "0")))
    return p.parse_args(argv)


def check_supported(args: argparse.Namespace) -> None:
    """Refuse every flag whose path this package does not serve yet."""
    a6 = "multi-device serving (ROADMAP.md queue A, item 6)"
    a7 = "multimodal serving (ROADMAP.md queue A, item 7)"
    unsupported = [
        (args.model == "70b", "--model 70b", a6),
        (args.mesh.replace(" ", "") != "1,1", f"--mesh {args.mesh}", a6),
        (args.pp > 1, f"--pp {args.pp}", a6),
        (args.attention_impl == "auto", "--attention-impl auto",
         "autotune (ROADMAP.md queue A, item 7)"),
        (args.mm_encoder or args.mm_encode_component is not None,
         "--mm-*", a7),
        (args.coordinator is not None or args.num_hosts > 1,
         "multi-host serving (--coordinator/--num-hosts)", a6),
    ]
    for bad, what, needs in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} needs {needs}, which dynamo_tpu_torch does not "
                "serve yet"
            )


def launch_counts() -> str:
    return " ".join(f"{name}={n}" for name, n in pa.LAUNCHES.items())


async def run_worker(args: argparse.Namespace) -> None:
    check_supported(args)
    config = RuntimeConfig.from_settings()
    if args.store_addr:
        config.store_addr = args.store_addr
    if args.namespace:
        config.namespace = args.namespace
    if args.drain_timeout is not None:
        config.drain_timeout_s = args.drain_timeout

    model_cfg = MODEL_PRESETS[args.model]()
    weight_dtype = (args.weight_dtype if args.weight_dtype is not None
                    else config.weight_dtype)
    kv_dtype = (args.kv_dtype if args.kv_dtype is not None
                else config.kv_dtype)
    params = None
    if args.weights:
        from .engine.weights import load_hf_params, model_config_from_hf

        if os.path.exists(os.path.join(args.weights, "config.json")):
            model_cfg = model_config_from_hf(args.weights)
        params = load_hf_params(args.weights, model_cfg, weight_dtype,
                                device=args.device)
        if args.tokenizer is None:
            args.tokenizer = args.weights
    eng_cfg = EngineConfig(
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        max_num_seqs=args.max_num_seqs,
        max_num_batched_tokens=args.max_batched_tokens,
        max_model_len=min(args.max_model_len, model_cfg.max_position),
        attention_impl=ATTENTION_IMPLS[args.attention_impl],
        prefill_chunk_tokens=(
            args.prefill_chunk_tokens
            if args.prefill_chunk_tokens is not None
            else config.prefill_chunk_tokens
        ),
        spec_mode=(args.spec_mode if args.spec_mode is not None
                   else config.spec_mode),
        spec_k=(args.spec_k if args.spec_k is not None else config.spec_k),
        spec_auto_disable_threshold=config.spec_auto_disable_threshold,
        spec_auto_disable_window=config.spec_auto_disable_window,
        weight_dtype=weight_dtype,
        kv_dtype=kv_dtype,
    )
    tokenizer = load_tokenizer(args.tokenizer)
    name = args.model_name or args.model

    # Build the engine BEFORE taking the store lease: engine construction
    # (random weights at full width, the KV cache) and the kernel build are
    # seconds of work that would starve the lease keepalive and get the
    # worker evicted at birth.
    engine = InferenceEngine(model_cfg, eng_cfg, params=params,
                             device=args.device)
    if engine.device.type == "cuda":
        from .ops import _build

        _build.build_all()
    runtime = await DistributedRuntime.from_settings(config)

    if args.kvbm_host_blocks > 0:
        from .kvbm.manager import KvbmConfig, StoreRemoteTier

        remote = None
        if args.kvbm_remote:
            remote = StoreRemoteTier(
                runtime.store, namespace=config.namespace
            )
        engine.attach_kvbm(KvbmConfig(
            host_blocks=args.kvbm_host_blocks,
            host_bytes=args.kvbm_host_bytes,
            disk_dir=args.kvbm_disk_dir,
            disk_blocks=args.kvbm_disk_blocks,
        ), remote=remote)

    kvbm_dist = None
    if args.kvbm_group:
        # a group member that never starts the presence plane would leave
        # the leader waiting at the barrier for a check-in that never comes
        args.kvbm_distributed = True
    if args.kvbm_distributed and engine.kvbm is None:
        raise SystemExit(
            "--kvbm-distributed/--kvbm-group require KVBM "
            "(--kvbm-host-blocks > 0)"
        )
    if args.kvbm_distributed:
        from .kvbm.distributed import (
            DistributedKvbm, KvbmGroup, engine_layout,
        )

        kvbm_dist = DistributedKvbm(
            engine.kvbm, runtime.store, runtime.primary_lease,
            namespace=config.namespace, advertise_host=args.advertise_host,
            scope=name,
        )
        await kvbm_dist.start()
        if args.kvbm_group:
            layout = engine_layout(engine)
            if args.kvbm_group_role == "leader":
                await KvbmGroup.lead(
                    runtime.store, args.kvbm_group, args.kvbm_group_size,
                    layout,
                )
            else:
                await KvbmGroup.join(
                    runtime.store, args.kvbm_group,
                    f"worker-{runtime.primary_lease}", layout,
                )
            log.info("kvbm group %s formed (%s)", args.kvbm_group,
                     args.kvbm_group_role)

    if config.prefix_enabled:
        from .prefix.manager import PrefixCacheConfig

        # after attach_kvbm so the manager chains the host-pool drop hook
        # and mirrors the G2/G4 tiers; works index-only without KVBM
        engine.attach_prefix_cache(
            config=PrefixCacheConfig(
                evict_to_host_blocks=config.prefix_evict_blocks,
                tier_weight_g2=config.prefix_tier_weight_g2,
                tier_weight_g4=config.prefix_tier_weight_g4,
            ),
            worker_id=runtime.primary_lease,
        )

    handler = None
    queue_worker = None
    component = args.component
    if args.disagg_mode == "prefill":
        from .disagg import DisaggConfig, PrefillHandler, PrefillQueueWorker

        # prefill workers serve on their own component; decode workers own
        # model registration (ref: vllm main.py:137 init_prefill)
        component = args.prefill_component
        handler = PrefillHandler(
            engine, config=DisaggConfig.from_runtime(config)
        )
        handler.start_orphan_sweeper()
        if args.disagg_queue:
            queue_worker = PrefillQueueWorker(
                handler, runtime.store, queue_name=args.disagg_queue_name
            )
            queue_worker.start()
        tokenizer = None
    elif args.disagg_mode == "decode":
        from .disagg import DecodeHandler, DisaggConfig

        prefill_client = await (
            runtime.namespace().component(args.prefill_component)
            .endpoint("generate").client()
        )
        handler = DecodeHandler(
            engine, prefill_client,
            DisaggConfig.from_runtime(
                config,
                min_remote_prefill_tokens=args.min_remote_prefill_tokens,
                use_queue=args.disagg_queue,
                queue_name=args.disagg_queue_name,
            ),
            store=runtime.store,
        )
        handler.start_orphan_sweeper()

    opts = ServeOptions(
        name=name, component=component, endpoint=args.endpoint,
        advertise_host=args.advertise_host,
        migration_limit=args.migration_limit,
        tool_call_parser=args.tool_call_parser,
        reasoning_parser=args.reasoning_parser,
    )
    served, kv_pub, metrics_pub = await serve_engine(
        runtime, engine, eng_cfg, opts, tokenizer, handler=handler
    )
    # The kernels' launch counts ride every load-metrics snapshot, beside
    # the disagg handler's health gauges (fallbacks, breaker state,
    # retries, orphan reaps — and in queue mode the prefill backlog) as the
    # JAX worker publishes them: a worker that dies without a shutdown
    # leaves its last counts with subscribers. Readers look keys up by
    # name, so the JAX router and monitor ignore the launch counts.
    disagg_extra = (handler.metrics_extra
                    if args.disagg_mode in ("prefill", "decode") else dict)
    metrics_pub.extra_fn = lambda: {
        **disagg_extra(), "kernel_launches": dict(pa.LAUNCHES)}
    if args.disagg_mode == "decode" and args.disagg_queue:
        handler.start_depth_monitor()
    if args.disagg_mode == "decode":
        inject_ep = (runtime.namespace().component(component)
                     .endpoint("kv_inject"))
        inject_served = await inject_ep.serve_endpoint(
            handler.inject_handler(), advertise_host=args.advertise_host
        )
        handler.kv_inject_addr = inject_served.instance.addr
    log.info("worker ready: model=%s mode=%s device=%s engine=%s",
             name, args.disagg_mode, engine.device, eng_cfg)
    try:
        await run_until_shutdown(runtime, engine, served, kv_pub,
                                 metrics_pub)
    finally:
        if queue_worker is not None:
            await queue_worker.stop()
        if kvbm_dist is not None:
            await kvbm_dist.stop()
        if hasattr(handler, "close"):
            handler.close()
        log.info("worker exiting: kernel launches %s", launch_counts())


def main(argv=None) -> None:
    asyncio.run(run_worker(parse_args(argv)))


if __name__ == "__main__":
    main()
