"""Single-command launcher: ``in=X out=Y`` like the reference's dynamo-run
(ref: launch/dynamo-run/src/main.rs:31).

    python -m dynamo_tpu_torch.run in=http out=engine --model 1b \
        --tokenizer tokenizer.json --port 8000
    python -m dynamo_tpu_torch.run in=batch:requests.jsonl out=engine --model 1b
    python -m dynamo_tpu_torch.run in=text out=engine --model tiny --device cpu
    python -m dynamo_tpu_torch.run in=batch:prompts.jsonl out=engine \
        --weights /models/llama3-1b --weight-dtype int8

Inputs: ``http`` (the OpenAI frontend over the in-process engine — no
cluster needed; needs ``--tokenizer``), ``text`` (interactive REPL) and
``batch:FILE`` (JSONL of ``{"token_ids": [...]}`` or, with a tokenizer,
``{"prompt": "..."}`` rows, plus ``"max_tokens"`` and ``"temperature"`` →
JSONL results, all submitted concurrently). Without a tokenizer ``text`` and
``batch`` take and give token ids. Outputs: ``engine`` (the PyTorch engine,
on ``cuda`` unless ``--device`` says otherwise) and ``echo`` (token echo —
protocol debugging). ``--tokenizer`` is a ``tokenizer.json`` file or a local
HuggingFace directory holding one (with its ``tokenizer_config.json``).

``--weights DIR`` serves a local HF checkpoint (``*.safetensors``, read by
the port's own reader): its ``config.json``, when present, overrides
``--model``, and the tokenizer defaults to the same directory (token ids
when it holds none). ``--weight-dtype int8|fp8`` quantizes the weights as
they load, ``--kv-dtype`` the KV pages (the worker's flags of the same
names).

``--mesh D,N`` (the JAX launcher's flag: ``dp,tp``) serves ``out=engine``
on a one-host world of ``D*N`` ranks: this process leads (it reads the
input and schedules), and it starts ``D*N - 1`` follower ranks of its own
command line (``parallel/multihost.py`` ``LocalWorld``, each rank
on ``rank_device``) that replay its step plans, which reach them through
a ``TCPStore`` queue (``StorePlanChannel``). With ``--weights`` each rank
loads only its shard (``load_hf_params_sharded``). Two ranks share one
card only over gloo (``DYNTPU_DIST_BACKEND=gloo``).

    DYNTPU_DIST_BACKEND=gloo python -m dynamo_tpu_torch.run \
        in=batch:prompts.jsonl out=engine --model 1b --mesh 1,2
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from typing import Optional

from .engine.config import EngineConfig, ModelConfig
from .parallel.multihost import (
    LocalWorld, add_local_world_args, parse_mesh_flag,
)
from .runtime.context import Context
from .serving import load_tokenizer
from .utils.logging import get_logger

log = get_logger("run")

MODEL_PRESETS = {
    "tiny": ModelConfig.tiny,
    "1b": ModelConfig.llama3_1b,
    "8b": ModelConfig.llama3_8b,
    "mixtral": ModelConfig.mixtral_8x7b,
}


class EchoEngine:
    """out=echo: stream the prompt's tokens back (ref: Output::Echo)."""

    async def generate(self, request, context):
        toks = list(request.get("token_ids", []))
        for i, t in enumerate(toks):
            await asyncio.sleep(0.01)
            yield {"token_ids": [t], "index": i,
                   "finished": i == len(toks) - 1,
                   "finish_reason": "stop" if i == len(toks) - 1 else None,
                   "num_prompt_tokens": len(toks)}

    async def start(self):
        pass

    async def stop(self):
        pass


def build_output(args, mesh=(1, 1)):
    """Engine for the ``out=`` side on ``mesh``, ``(dp, tp)`` of ``--mesh``
    (a world of more than one rank joined first: :func:`main`)."""
    if args.out == "echo":
        return EchoEngine()
    from .engine.engine import InferenceEngine

    model_cfg = MODEL_PRESETS[args.model]()
    dp, tp = mesh
    params = None
    if args.weights:
        from .engine.weights import (
            load_hf_params, load_hf_params_sharded, model_config_from_hf,
        )

        if os.path.exists(os.path.join(args.weights, "config.json")):
            model_cfg = model_config_from_hf(args.weights)
        if dp * tp > 1:
            # this rank's slices only (peak host staging: one tensor)
            from .parallel.layout import check_divisible, make_mesh

            check_divisible(model_cfg, tp)
            params = load_hf_params_sharded(
                args.weights, model_cfg, make_mesh((dp, tp)),
                args.weight_dtype, device=args.device)
        else:
            params = load_hf_params(args.weights, model_cfg,
                                    args.weight_dtype, device=args.device)
    eng_cfg = EngineConfig(
        num_blocks=args.num_blocks, block_size=args.block_size,
        max_model_len=min(args.max_model_len, model_cfg.max_position),
        weight_dtype=args.weight_dtype, kv_dtype=args.kv_dtype,
        mesh_shape=(dp, tp),
    )
    return InferenceEngine(model_cfg, eng_cfg, params=params,
                           device=args.device)


def build_tokenizer(args):
    """``--tokenizer``, else the ``--weights`` directory's tokenizer; with
    ``--weights`` and no tokenizer there, token-id mode."""
    if args.tokenizer is not None or args.weights is None:
        return load_tokenizer(args.tokenizer)
    try:
        return load_tokenizer(args.weights)
    except OSError:
        log.warning("no tokenizer at %s — running token-id mode",
                    args.weights)
        return None


async def run_text(engine, tokenizer, args) -> None:
    """Interactive REPL (ref: Input::Text): text with a tokenizer, else
    space-separated token ids."""
    await engine.start()
    print("dynamo-tpu-torch text mode — empty line exits", file=sys.stderr)
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, _read_prompt)
        if not line:
            break
        if tokenizer is not None:
            token_ids = tokenizer.encode(line)
            stream = tokenizer.stream(token_ids)
        else:
            token_ids = [int(x) for x in line.split()]
            stream = None
        req = {"token_ids": token_ids, "max_tokens": args.max_tokens,
               "temperature": args.temperature}
        async for out in engine.generate(req, Context()):
            for t in out.get("token_ids", []):
                text = stream.push([t]) if stream is not None else f" {t}"
                print(text, end="", flush=True)
        if stream is not None:
            print(stream.flush(), end="")
        print()
    await engine.stop()


def _read_prompt() -> str:
    try:
        return input("> ").strip()
    except EOFError:
        return ""


async def run_batch(engine, tokenizer, args, path: str) -> None:
    """JSONL requests in → JSONL completions out (ref: Input::Batch)."""
    await engine.start()
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))

    async def one(i, row):
        if "token_ids" in row:
            token_ids = row["token_ids"]
        elif tokenizer is not None:
            token_ids = tokenizer.encode(row.get("prompt", ""))
        else:
            raise ValueError(f"row {i}: no token_ids and no tokenizer")
        req = {"token_ids": token_ids,
               "max_tokens": row.get("max_tokens", args.max_tokens),
               "temperature": row.get("temperature", args.temperature)}
        out_tokens = []
        t0 = time.perf_counter()
        async for out in engine.generate(req, Context()):
            out_tokens.extend(out.get("token_ids", []))
        result = {"index": i, "prompt_tokens": len(token_ids),
                  "completion_tokens": len(out_tokens),
                  "token_ids": out_tokens,
                  "latency_s": round(time.perf_counter() - t0, 4)}
        if tokenizer is not None:
            result["text"] = tokenizer.decode(out_tokens)
        return result

    try:
        results = await asyncio.gather(
            *(one(i, row) for i, row in enumerate(rows))
        )
    finally:
        await engine.stop()
    for r in results:
        print(json.dumps(r))


async def run_http(engine, tokenizer, args,
                   stop: Optional[asyncio.Event] = None,
                   ready: Optional[asyncio.Future] = None) -> None:
    """OpenAI frontend over an in-process engine — the no-cluster quickstart
    (ref: dynamo-run in=http out=<local engine>). Serves until ``stop`` is
    set (forever without one); ``ready``, when given, receives the started
    :class:`~.frontend.service.HttpService` (its ``port`` is the one bound).
    """
    from .frontend.service import HttpService, ModelEntry, ModelManager
    from .llm.entrypoint import build_local_pipeline

    if tokenizer is None:
        raise SystemExit("in=http needs --tokenizer or --weights")
    await engine.start()
    name = args.model_name or args.model
    pipeline = build_local_pipeline(
        engine, tokenizer, model_name=name,
        max_context_len=args.max_model_len,
    )
    manager = ModelManager()
    manager.register(ModelEntry(name=name, engine=pipeline))
    service = HttpService(manager, host=args.host, port=args.port)
    try:
        await service.start()
        log.info("serving %s on %s:%d", name, args.host, service.port)
        if ready is not None:
            ready.set_result(service)
        await (stop or asyncio.Event()).wait()
    finally:
        await service.stop()
        await engine.stop()


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="dynamo-tpu-torch single-command launcher",
        usage="python -m dynamo_tpu_torch.run in=<http|text|batch:FILE> "
              "out=<engine|echo> [options]",
    )
    p.add_argument("io", nargs=2, metavar="in=/out=",
                   help="in=http|text|batch:FILE and out=engine|echo")
    p.add_argument("--model", default="tiny", choices=sorted(MODEL_PRESETS))
    p.add_argument("--model-name", default=None,
                   help="name the HTTP frontend serves (default --model)")
    p.add_argument("--weights", default=None,
                   help="local HF checkpoint dir (*.safetensors [+ "
                        "config.json, which overrides --model]); the "
                        "tokenizer defaults to it")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer.json, or a local HF directory with one")
    p.add_argument("--weight-dtype", default="bf16",
                   choices=["bf16", "int8", "fp8"],
                   help="weight storage: int8/fp8 quantize at load time")
    p.add_argument("--kv-dtype", default="bf16",
                   choices=["bf16", "int8", "fp8"],
                   help="paged-KV storage dtype")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "kernel versions on the CPU)")
    p.add_argument("--num-blocks", type=int, default=2048)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--max-model-len", type=int, default=8192)
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000,
                   help="HTTP port (0 picks a free one)")
    p.add_argument("--mesh", default="1,1",
                   help="dp,tp: serve out=engine on dp*tp ranks of this "
                        "host, this process leading")
    add_local_world_args(p)
    args = p.parse_args(argv)
    # the command line the follower ranks this launcher starts run with
    args.argv = list(sys.argv[1:] if argv is None else argv)
    spec = {}
    for part in args.io:
        k, _, v = part.partition("=")
        spec[k] = v
    if "in" not in spec or "out" not in spec:
        p.error("both in= and out= are required")
    args.inp, args.out = spec["in"], spec["out"]
    if args.out not in ("engine", "echo"):
        p.error(f"unknown out={args.out}")
    if args.inp not in ("http", "text") and not args.inp.startswith("batch:"):
        p.error(f"unknown in={args.inp}")
    return args


def main(argv=None) -> None:
    t0 = time.perf_counter()
    args = parse_args(argv)
    # out=echo serves no mesh, as in the JAX launcher; three numbers raise
    # the JAX launcher's ValueError
    mesh = (1, 1) if args.out == "echo" else parse_mesh_flag(args.mesh)
    with LocalWorld(args, "dynamo_tpu_torch.run", mesh) as world:
        engine = build_output(args, mesh)
        try:
            world.serve(engine, lambda engine: _serve(engine, args, t0))
        finally:
            if args.out == "engine":
                _log_exit(engine, world)


def _serve(engine, args, t0: float) -> None:
    tokenizer = build_tokenizer(args)
    if args.out == "engine":
        log.info("engine ready %.2f s after the launcher started",
                 time.perf_counter() - t0)
    if args.inp == "text":
        asyncio.run(run_text(engine, tokenizer, args))
    elif args.inp == "http":
        asyncio.run(run_http(engine, tokenizer, args))
    else:
        asyncio.run(run_batch(engine, tokenizer, args,
                              args.inp.split(":", 1)[1]))


def _log_exit(engine, world: LocalWorld) -> None:
    """The exit lines: the kernel launches, and on a rank of a world its
    place, collectives and plans (``worker.rank_counts``)."""
    from .ops import paged_attention as pa

    log.info("run exiting: kernel launches %s", " ".join(
        f"{name}={n}" for name, n in pa.LAUNCHES.items()))
    if world.channel is not None:
        from .worker import rank_counts

        log.info("run exiting: %s", rank_counts(
            engine, world.channel if world.leader else None))


if __name__ == "__main__":
    main()
