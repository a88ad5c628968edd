"""Single-command launcher: ``in=X out=Y`` like the reference's dynamo-run
(ref: launch/dynamo-run/src/main.rs:31).

    python -m dynamo_tpu_torch.run in=batch:requests.jsonl out=engine --model 1b
    python -m dynamo_tpu_torch.run in=text out=engine --model tiny --device cpu

Inputs: ``text`` (interactive REPL of space-separated token ids) and
``batch:FILE`` (JSONL of ``{"token_ids": [...], "max_tokens": n,
"temperature": t}`` rows → JSONL results, all submitted concurrently).
Outputs: ``engine`` (the PyTorch engine, on ``cuda`` unless ``--device``
says otherwise) and ``echo`` (token echo — protocol debugging). Token ids
in, token ids out: the tokenizer, the HTTP frontend and the checkpoint
loader come in a later slice.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

from .engine.config import EngineConfig, ModelConfig
from .runtime.context import Context
from .utils.logging import get_logger

log = get_logger("run")

MODEL_PRESETS = {
    "tiny": ModelConfig.tiny,
    "1b": ModelConfig.llama3_1b,
    "8b": ModelConfig.llama3_8b,
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


def build_output(args):
    """Engine for the ``out=`` side."""
    if args.out == "echo":
        return EchoEngine()
    from .engine.engine import InferenceEngine

    model_cfg = MODEL_PRESETS[args.model]()
    eng_cfg = EngineConfig(
        num_blocks=args.num_blocks, block_size=args.block_size,
        max_model_len=min(args.max_model_len, model_cfg.max_position),
    )
    return InferenceEngine(model_cfg, eng_cfg, device=args.device)


async def run_text(engine, args) -> None:
    """Interactive REPL of token ids (ref: Input::Text)."""
    await engine.start()
    print("dynamo-tpu-torch text mode (token ids) — empty line exits",
          file=sys.stderr)
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, _read_prompt)
        if not line:
            break
        req = {"token_ids": [int(x) for x in line.split()],
               "max_tokens": args.max_tokens,
               "temperature": args.temperature}
        async for out in engine.generate(req, Context()):
            for t in out.get("token_ids", []):
                print(f" {t}", end="", flush=True)
        print()
    await engine.stop()


def _read_prompt() -> str:
    try:
        return input("> ").strip()
    except EOFError:
        return ""


async def run_batch(engine, args, path: str) -> None:
    """JSONL token-id requests in → JSONL completions out (ref:
    Input::Batch)."""
    await engine.start()
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))

    async def one(i, row):
        if "token_ids" not in row:
            raise ValueError(f"row {i}: no token_ids (token-id mode)")
        token_ids = row["token_ids"]
        req = {"token_ids": token_ids,
               "max_tokens": row.get("max_tokens", args.max_tokens),
               "temperature": row.get("temperature", args.temperature)}
        out_tokens = []
        t0 = time.perf_counter()
        async for out in engine.generate(req, Context()):
            out_tokens.extend(out.get("token_ids", []))
        return {"index": i, "prompt_tokens": len(token_ids),
                "completion_tokens": len(out_tokens),
                "token_ids": out_tokens,
                "latency_s": round(time.perf_counter() - t0, 4)}

    try:
        results = await asyncio.gather(
            *(one(i, row) for i, row in enumerate(rows))
        )
    finally:
        await engine.stop()
    for r in results:
        print(json.dumps(r))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="dynamo-tpu-torch single-command launcher",
        usage="python -m dynamo_tpu_torch.run in=<text|batch:FILE> "
              "out=<engine|echo> [options]",
    )
    p.add_argument("io", nargs=2, metavar="in=/out=",
                   help="in=text|batch:FILE and out=engine|echo")
    p.add_argument("--model", default="tiny", choices=sorted(MODEL_PRESETS))
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "kernel versions on the CPU)")
    p.add_argument("--num-blocks", type=int, default=2048)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--max-model-len", type=int, default=8192)
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    args = p.parse_args(argv)
    spec = {}
    for part in args.io:
        k, _, v = part.partition("=")
        spec[k] = v
    if "in" not in spec or "out" not in spec:
        p.error("both in= and out= are required")
    args.inp, args.out = spec["in"], spec["out"]
    if args.out not in ("engine", "echo"):
        p.error(f"unknown out={args.out}")
    if args.inp != "text" and not args.inp.startswith("batch:"):
        p.error(f"unknown in={args.inp}")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    engine = build_output(args)
    if args.inp == "text":
        asyncio.run(run_text(engine, args))
    else:
        asyncio.run(run_batch(engine, args, args.inp.split(":", 1)[1]))


if __name__ == "__main__":
    main()
