"""SLA profiler: sweep the engine offline, emit the planner's perf curves
(ref: benchmarks/profiler/profile_sla.py:56 — sweeps prefill/decode
operating points into the interpolation tables planner_core consumes).

    python -m dynamo_tpu_torch.planner.profiler --model 1b --out profile.json

Prefill curve: for each ISL, time a full-prompt prefill → TTFT and
tok/s/chip. Decode surface: for each (batch, context) point, time steady
decode steps → ITL and tok/s/chip, with kv_usage taken from the pool.
Output keys match ``PrefillInterpolator.from_profile`` /
``DecodeInterpolator.from_profile``.

A copy of ``dynamo_tpu.planner.profiler`` driving the port's
``InferenceEngine`` on the card (``--device cpu`` for the CPU): the prefill
sweep runs the ragged face of the paged-attention kernel, the decode sweep
its decode face. ``--mesh D,N`` profiles a multi-rank engine as the JAX
profiler does: this process leads and sweeps, ``D*N - 1`` follower ranks
it starts replay its plans (``parallel/multihost.py``
``LocalWorld``), and the per-chip figures are divided by ``D*N``
(``meta.mesh`` is ``[D, N]``). ``--model 70b`` is refused: its 141 GB of
bf16 weights fit no 80 GB card, whatever the mesh of one host's ranks
sharing it.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import Dict, List

from ..engine.config import EngineConfig, ModelConfig
from ..engine.engine import InferenceEngine, Request
from ..parallel.multihost import (
    LocalWorld, add_local_world_args, parse_mesh_flag,
)
from ..utils.logging import get_logger

log = get_logger("profiler")

MODEL_PRESETS = {
    "tiny": ModelConfig.tiny,
    "1b": ModelConfig.llama3_1b,
    "8b": ModelConfig.llama3_8b,
}


async def _drain(engine: InferenceEngine, req: Request) -> List[float]:
    """Submit one request; returns per-token arrival times."""
    times = []
    async for _ in engine.submit(req):
        times.append(time.perf_counter())
    return times


async def profile_prefill(
    engine: InferenceEngine, isls: List[int], num_chips: int,
) -> Dict[str, list]:
    out = {"prefill_isl": [], "prefill_ttft_s": [],
           "prefill_thpt_per_chip": []}
    for isl in isls:
        prompt = [(i % 1000) + 1 for i in range(isl)]
        # warm-up compiles the bucket
        await _drain(engine, Request(request_id=f"warm-{isl}",
                                     token_ids=prompt, max_tokens=1,
                                     ignore_eos=True))
        t0 = time.perf_counter()
        times = await _drain(engine, Request(
            request_id=f"p-{isl}", token_ids=list(prompt), max_tokens=1,
            ignore_eos=True,
        ))
        ttft = times[0] - t0
        out["prefill_isl"].append(isl)
        out["prefill_ttft_s"].append(ttft)
        out["prefill_thpt_per_chip"].append(isl / ttft / num_chips)
        engine.clear_kv_blocks()
        log.info("prefill isl=%d ttft=%.3fs", isl, ttft)
    return out


async def profile_decode(
    engine: InferenceEngine, points: List[tuple], num_chips: int,
    osl: int = 32,
) -> Dict[str, list]:
    out = {"decode_kv_usage": [], "decode_context_length": [],
           "decode_itl_s": [], "decode_thpt_per_chip": []}
    for batch, context in points:
        reqs = [
            Request(request_id=f"d-{batch}-{context}-{i}",
                    token_ids=[(j % 1000) + 1 for j in range(context)],
                    max_tokens=osl, ignore_eos=True)
            for i in range(batch)
        ]
        peak_usage = 0.0

        async def _sample_usage():
            nonlocal peak_usage
            while True:
                peak_usage = max(peak_usage, engine.scheduler.pool.usage)
                await asyncio.sleep(0.005)

        sampler = asyncio.create_task(_sample_usage())
        t0 = time.perf_counter()
        all_times = await asyncio.gather(
            *(_drain(engine, r) for r in reqs)
        )
        dur = time.perf_counter() - t0
        sampler.cancel()
        itls = [b - a for times in all_times
                for a, b in zip(times, times[1:])]
        itls.sort()
        itl = itls[len(itls) // 2] if itls else 0.0
        total_out = sum(len(t) for t in all_times)
        kv_usage = peak_usage
        out["decode_kv_usage"].append(round(kv_usage, 4))
        out["decode_context_length"].append(context + osl // 2)
        out["decode_itl_s"].append(itl)
        out["decode_thpt_per_chip"].append(total_out / dur / num_chips)
        engine.clear_kv_blocks()
        log.info("decode batch=%d ctx=%d itl=%.4fs kv=%.2f",
                 batch, context, itl, kv_usage)
    return out


def check_supported(args: argparse.Namespace) -> None:
    """Refuse what no mesh of this profiler serves, by name: ``--model
    70b`` (the JAX profiler has no such preset; the worker serves it over
    several cards, one rank per card)."""
    if args.model == "70b":
        raise NotImplementedError(
            "--model 70b is not profiled: its 141 GB of bf16 weights do "
            "not fit one 80 GB card, and the profiler's ranks share one "
            "host's cards (the worker serves 70b on a --mesh of one rank "
            "per card)")


def build_engine(args: argparse.Namespace) -> InferenceEngine:
    """The engine the sweep drives, configured as the JAX profiler's; on
    the card its kernels are built first. On a ``--mesh`` of more than one
    rank the world must be joined first (:func:`main`)."""
    check_supported(args)
    dp, tp = parse_mesh_flag(args.mesh)
    model_cfg = MODEL_PRESETS[args.model]()
    isls = [int(x) for x in args.isls.split(",")]
    max_isl = max(isls)
    eng_cfg = EngineConfig(
        num_blocks=args.num_blocks,
        max_model_len=min(2 * max_isl, model_cfg.max_position),
        max_num_batched_tokens=max(512, max_isl),
        prefill_buckets=tuple(sorted({256, max(512, max_isl)})),
        decode_buckets=(8, 16, 32, 64),
        mesh_shape=(dp, tp),
    )
    engine = InferenceEngine(model_cfg, eng_cfg, device=args.device)
    if engine.device.type == "cuda":
        from ..ops import _build

        _build.build_all()
    return engine


async def run_profile(args, engine: InferenceEngine = None) -> dict:
    """Sweep ``engine`` (built from ``args`` when not given) and return the
    profile; an engine built here is stopped at the end."""
    own = engine is None
    if own:
        engine = build_engine(args)
    dp, tp = parse_mesh_flag(args.mesh)
    num_chips = dp * tp
    isls = [int(x) for x in args.isls.split(",")]
    await engine.start()
    try:
        profile = {}
        profile.update(await profile_prefill(engine, isls, num_chips))
        points = []
        for batch in (int(x) for x in args.batches.split(",")):
            for ctx in (int(x) for x in args.contexts.split(",")):
                points.append((batch, ctx))
        profile.update(await profile_decode(engine, points, num_chips))
        profile["meta"] = {
            "model": args.model, "mesh": [dp, tp],
            "num_blocks": args.num_blocks,
        }
        return profile
    finally:
        if own:
            await engine.stop()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dynamo-tpu SLA profiler "
                                            "(PyTorch port)")
    p.add_argument("--model", default="tiny",
                   choices=sorted(MODEL_PRESETS) + ["70b"])
    p.add_argument("--mesh", default="1,1")
    p.add_argument("--num-blocks", type=int, default=2048)
    p.add_argument("--isls", default="128,512,1024",
                   help="prefill ISLs to profile (comma-separated)")
    p.add_argument("--batches", default="1,8,32")
    p.add_argument("--contexts", default="128,512")
    p.add_argument("--out", default="profile.json")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    add_local_world_args(p)
    args = p.parse_args(argv)
    # the command line the follower ranks of a --mesh run are started with
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    check_supported(args)

    async def sweep(engine):
        try:
            return await run_profile(args, engine)
        finally:
            await engine.stop()

    with LocalWorld(args, "dynamo_tpu_torch.planner.profiler",
                    parse_mesh_flag(args.mesh)) as world:
        profile = world.serve(build_engine(args),
                              lambda engine: asyncio.run(sweep(engine)))
    if profile is None:        # a follower rank
        return
    with open(args.out, "w") as f:
        json.dump(profile, f, indent=2)
    log.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
