"""Mocker worker process: a device-free engine on the cluster
(ref: components/backends/mocker/src/dynamo/mocker/main.py).

    python -m dynamo_tpu_torch.mocker --model-name mock --tokenizer tok.json \
        --speedup-ratio 10

Registers and serves exactly like a real worker — frontends, routers, and
the planner cannot tell the difference, which is the point: multi-worker
routing/overload/fault scenarios run in CI without a GPU.

A copy of ``dynamo_tpu.mocker.__main__`` over the port's ``serve_engine``.
"""

from __future__ import annotations

import argparse
import asyncio

from ..engine.config import EngineConfig
from ..runtime.component import DistributedRuntime
from ..serving import (
    ServeOptions, load_tokenizer, run_until_shutdown, serve_engine,
)
from ..utils.config import RuntimeConfig
from ..utils.logging import get_logger
from .engine import MockEngine, MockerConfig

log = get_logger("mocker")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo-tpu mocker worker")
    p.add_argument("--model-name", default="mock")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--store-addr", default=None)
    p.add_argument("--namespace", default=None)
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--num-blocks", type=int, default=2048)
    p.add_argument("--max-num-seqs", type=int, default=64)
    p.add_argument("--max-batched-tokens", type=int, default=512)
    p.add_argument("--max-model-len", type=int, default=8192)
    p.add_argument("--speedup-ratio", type=float, default=1.0)
    p.add_argument("--migration-limit", type=int, default=3)
    p.add_argument("--advertise-host", default="127.0.0.1")
    return p.parse_args(argv)


async def run_mocker(args: argparse.Namespace) -> None:
    config = RuntimeConfig.from_settings()
    if args.store_addr:
        config.store_addr = args.store_addr
    if args.namespace:
        config.namespace = args.namespace

    eng_cfg = EngineConfig(
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        max_num_seqs=args.max_num_seqs,
        max_num_batched_tokens=args.max_batched_tokens,
        max_model_len=args.max_model_len,
    )
    tokenizer = load_tokenizer(args.tokenizer)
    # sample inside the real vocab so mock tokens always detokenize
    vocab = tokenizer.vocab_size if tokenizer is not None else 512
    engine = MockEngine(
        eng_cfg,
        MockerConfig(vocab_size=vocab, speedup_ratio=args.speedup_ratio),
    )
    runtime = await DistributedRuntime.from_settings(config)
    opts = ServeOptions(
        name=args.model_name, component=args.component,
        endpoint=args.endpoint, advertise_host=args.advertise_host,
        migration_limit=args.migration_limit,
    )
    served, kv_pub, metrics_pub = await serve_engine(
        runtime, engine, eng_cfg, opts, tokenizer
    )
    log.info("mocker ready: model=%s speedup=%.1f",
             args.model_name, args.speedup_ratio)
    await run_until_shutdown(runtime, engine, served, kv_pub, metrics_pub)


def main(argv=None) -> None:
    asyncio.run(run_mocker(parse_args(argv)))


if __name__ == "__main__":
    main()
