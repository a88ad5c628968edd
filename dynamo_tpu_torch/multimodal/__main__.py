"""Standalone vision ENCODE worker — the E in EPD
(ref: the TRT-LLM encode worker role). Serves the ``encode`` endpoint on
its own component; language workers advertise it via
``--mm-encode-component``.

    python -m dynamo_tpu_torch.multimodal --component encoder --model-dim 2048

A copy of ``dynamo_tpu.multimodal.__main__`` with ``--device`` (``cuda``
unless asked for the CPU; with no device given and no GPU present the
worker raises). It drains on SIGTERM or SIGINT and exits 0.
"""

from __future__ import annotations

import argparse
import asyncio

from ..runtime.component import DistributedRuntime
from ..runtime.signals import install_shutdown_signals
from ..runtime.tasks import spawn_logged
from ..utils.config import RuntimeConfig
from ..utils.logging import get_logger
from .encoder import EncodeHandler, VisionEncoder, VisionEncoderConfig

log = get_logger("mm.worker")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo-tpu-torch encode worker")
    p.add_argument("--store-addr", default=None)
    p.add_argument("--namespace", default=None)
    p.add_argument("--component", default="encoder")
    p.add_argument("--advertise-host", default="127.0.0.1")
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--patch-size", type=int, default=8)
    p.add_argument("--model-dim", type=int, required=True,
                   help="language model hidden size the embeddings target")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


async def run(args: argparse.Namespace) -> None:
    cfg = VisionEncoderConfig(
        image_size=args.image_size, patch_size=args.patch_size,
        model_dim=args.model_dim,
    )
    # the device first: with no GPU and no --device this raises before the
    # store is dialled
    handler = EncodeHandler(VisionEncoder(cfg, seed=args.seed,
                                          device=args.device))
    config = RuntimeConfig.from_settings()
    if args.store_addr:
        config.store_addr = args.store_addr
    if args.namespace:
        config.namespace = args.namespace
    runtime = await DistributedRuntime.from_settings(config)

    ep = runtime.namespace().component(args.component).endpoint("encode")
    served = await ep.serve_endpoint(handler,
                                     advertise_host=args.advertise_host)
    log.info(
        "encode worker ready: %dx%d px -> %d tokens x %d dim on %s",
        cfg.image_size, cfg.image_size, cfg.tokens_per_image, cfg.model_dim,
        handler.encoder.device,
    )

    async def _shutdown():
        await served.drain_and_stop(deadline_s=config.drain_timeout_s)
        await runtime.shutdown()

    install_shutdown_signals(
        lambda: spawn_logged(_shutdown(), name="encode-worker-shutdown"),
        loop=asyncio.get_running_loop(), name="encode-worker",
    )
    await runtime.shutdown_event.wait()
    handler.close()
    log.info("encode worker exiting: %d images encoded",
             handler.encoder.num_encoded)


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
