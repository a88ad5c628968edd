#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``dynamo_tpu_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. One run is
one process on one card: it makes the weights on the card from the seed,
builds an ``InferenceEngine``, warms up the shapes its traffic uses, sends
the cell's traffic through ``EngineCore.generate`` for ``--seconds``, holds
a sample of the served tokens against the plain reference
(``reference/``), and prints one JSON line last on standard output. With
``--trace 1`` the line carries the cell's per-layer metrics (spans,
flight-recorder records and a device trace of the window's last seconds)
and a ``breakdown``; with ``--trace 0`` its end-to-end metrics.

The cell's parts are found by name (``spec.py``). Nothing here imports JAX
or the JAX package; a run that finds either loaded fails.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import flops, readers, spec, traffic  # noqa: E402
from portbench.serve import run_closed, run_open  # noqa: E402

# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "dynamo_tpu")
TRACE_S = 3.0          # the device trace covers the window's last seconds
RUN_LIMIT_S = 340.0


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # not part of a benchmark run: the knee sweep's rate, and the
    # comparison's control (the reference with float8 weights judged in the
    # program's place: the run prints ``correct`` false when it fails)
    p.add_argument("--rate", type=float, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc output already goes to ``build/torch_kernels``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    # a run that hangs prints every thread's stack and ends within a
    # run's 360 s
    faulthandler.dump_traceback_later(RUN_LIMIT_S, exit=True)
    args = parse(argv)
    cell = spec.load(ROOT, args.workload)
    cache_dirs()
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"portbench: {cell.chips} CUDA device(s) needed, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " found")
        return 2
    return run(args, cell, "cuda")


# --------------------------------------------------------------------------


def engine_config(c: dict, EngineConfig):
    e = dict(c["engine"])
    for k in ("prefill_buckets", "decode_buckets"):
        if k in e:
            e[k] = tuple(e[k])
    return EngineConfig(**e)


async def warm_up(engine, Context, longest: int, vocab: int,
                  seed: int) -> None:
    """The shapes the run's traffic uses: every prefill bucket up to the
    longest chunk its prompts can make (one prompt of each bucket's length,
    largest first), a prompt of its longest length (the widest block
    tables), and a burst of ``max_num_seqs`` short requests that walks the
    decode buckets (their graphs were captured at construction)."""
    import numpy as np

    from portbench.serve import Result, one
    from portbench.traffic import Req

    rng = np.random.Generator(np.random.PCG64(int(seed) + 1))
    ecfg = engine.config
    lens = sorted((b for b in ecfg.prefill_buckets
                   if b <= min(longest, ecfg.max_num_batched_tokens)),
                  reverse=True)
    lens.append(min(longest, ecfg.max_model_len - 8))

    def req(n, osl):
        return Result(Req(-1, n, osl, rng.integers(1, vocab, n).tolist()),
                      time.monotonic())

    for n in lens:
        await one(engine, Context, req(n, 2))
    burst = [req(64, 12) for _ in range(ecfg.max_num_seqs)]
    await asyncio.gather(*(one(engine, Context, r) for r in burst))
    bad = [r.error for r in burst if r.error]
    if bad:
        raise RuntimeError(f"warm-up request failed: {bad[0]}")
    engine.clear_kv_blocks()


def e2e_metrics(cell, results, t0, t1, setup_s, drain_s) -> dict:
    """The cell's end-to-end metrics, all from the host clock."""
    out = {}
    window = t1 - t0
    due = [r for r in results if t0 <= r.t_due < t1]
    for m in cell.end_to_end:
        name = m["name"]
        if name == "setup_s":
            v = setup_s
        elif name == "output_tok_s":
            v = sum(t0 <= t <= t1 for r in results for t in r.times) / window
        elif name.startswith("ttft_p"):
            # a request with no first token counts as having waited until
            # the run gave up on it
            ttft = [(r.times[0] if r.times else t1 + drain_s) - r.t_due
                    for r in due]
            v = readers.percentile([x * 1e3 for x in ttft],
                                   float(name[len("ttft_p"):-len("_ms")]))
        elif name.startswith("itl_p"):
            gaps = [(b - a) * 1e3 for r in results
                    for a, b in zip(r.times, r.times[1:]) if t0 <= b <= t1]
            v = readers.percentile(gaps, float(name[len("itl_p"):-3]))
        else:
            raise SystemExit(f"portbench: no end-to-end metric {name!r}")
        if v is not None:
            out[name] = {"value": v, "unit": m["unit"]}
    return out


def device_info(torch, device: str, chips: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def run(args, cell, device: str) -> int:
    import torch

    from dynamo_tpu_torch import tracing
    from dynamo_tpu_torch.engine import (
        EngineConfig, InferenceEngine, ModelConfig,
    )
    from dynamo_tpu_torch.observability.profiling import LAUNCH_GATE
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.tracing.export import InMemorySpanExporter

    from portbench import weights
    from portbench.reference import check
    from portbench.trace import DeviceTrace

    cfg = cell.config
    mix = dict(cell.mix)
    if args.rate is not None:
        mix["rate_rps"] = args.rate
    arch = spec.arch(cell.bench_dir, cfg)
    shapes = arch.shapes(cfg)
    dtype = cfg.get("torch_dtype", "bfloat16")
    mcfg = arch.model_config(cfg, ModelConfig)
    ecfg = engine_config(cfg, EngineConfig)

    marks = [("torch and the program imported", time.monotonic())]
    params = weights.make_params(arch.leaf_shapes(shapes), args.seed, dtype,
                                 device)
    if device == "cuda":
        torch.cuda.synchronize()
    marks.append(("weights made", time.monotonic()))
    engine = InferenceEngine(mcfg, ecfg, params=params, seed=args.seed,
                             device=device)
    marks.append(("engine built", time.monotonic()))
    plan = traffic.build(mix, args.seed, args.seconds, shapes.vocab)
    dtrace = DeviceTrace() if args.trace and device == "cuda" else None
    spans = InMemorySpanExporter()
    records = []
    if args.trace:
        tracing.get_tracer().configure(sample_ratio=1.0)
        tracing.get_tracer().add_exporter(spans)
        if engine.obs is not None:
            commit = engine.obs.commit

            def keep(rec, commit=commit):
                records.append(rec)
                commit(rec)
            engine.obs.commit = keep
    drain_s = float(mix.get("drain_s", 0.0))

    async def serve():
        await warm_up(engine, Context, max(r.isl for r in plan.requests),
                      shapes.vocab, args.seed)
        loop = asyncio.get_running_loop()

        def toggled(fn):
            # the program's gate: no profiler start or stop while its step
            # thread launches (a stop deadlocks against a graph launch)
            with LAUNCH_GATE.toggling():
                fn()

        if dtrace is not None:
            await loop.run_in_executor(
                None, toggled, lambda: dtrace.warm(torch.cuda.synchronize))
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(0)
        now = time.monotonic()
        marks.append(("warmed up", now))
        ramp = float(mix.get("ramp_s", 0.0)) if plan.loop == "closed" else 0
        t0 = now + ramp
        t1 = t0 + args.seconds
        profiler = None
        if dtrace is not None:
            async def profile_tail():
                await asyncio.sleep(max(0.0, t1 - min(TRACE_S, args.seconds)
                                        - time.monotonic()))
                await loop.run_in_executor(None, toggled, dtrace.start)
                await asyncio.sleep(max(0.0, t1 - time.monotonic()))
                await loop.run_in_executor(None, toggled, dtrace.stop)
            profiler = asyncio.create_task(profile_tail())
        if plan.loop == "open":
            results = await run_open(engine, Context, plan, t0, t1, drain_s)
        else:
            results = await run_closed(engine, Context, plan, now, t1)
        if profiler is not None:
            await profiler
        return now, t0, t1, results

    # set-up ends when the warm-up does, before a closed loop's ramp
    t_ready, t0, t1, results = asyncio.run(serve())
    setup_s = t_ready - T_PROCESS
    dev = device_info(torch, device, cell.chips)
    metrics = e2e_metrics(cell, results, t0, t1, setup_s, drain_s) \
        if not args.trace else {}
    breakdown = None
    if args.trace:
        summary = dtrace.summary() if dtrace is not None else None
        r = readers.Readings(
            shapes=shapes, arch=arch, peaks=flops.card_peaks(dev["kind"]),
            t0=t0, t1=t1,
            results=results,
            spans=[(s.name, s.start_mono, s.end_mono) for s in spans.spans],
            records=records, trace=summary)
        for name, read in spec.readers(cell).items():
            v = read(r)
            if v is not None:
                unit = next(m["unit"] for m in cell.per_layer
                            if m["name"] == name)
                metrics[name] = {"value": v, "unit": unit}
        if summary is not None:
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = summary.window_s
            breakdown = {"device_ops": [[n, s] for n, s in
                                        summary.device_ops],
                         "idle_gaps": [[n, s] for n, s in
                                       summary.idle_gaps]}
    bad = forbidden_modules()
    if bad:
        log(f"portbench: forbidden modules loaded in the run: {bad}")
        return 3

    # the comparison, once the program's state is freed
    due = [r for r in results if r.t_due < t1]
    late = [r.t_submit - r.t_due for r in due if plan.loop == "open"]
    failed = sum(1 for r in due if r.error is not None
                 or (plan.loop == "open" and not r.times))
    picked = check.pick(results, int(mix.get("check_requests", 4)),
                        args.seed)
    hits = (engine.stats.prefix_cache_hits, engine.stats.prefix_cache_queries)
    del engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    stats, ctl = (check.compare(spec.reference(cell.bench_dir, cfg), params,
                                cfg, picked, args.control)
                  if picked else (None, None))
    t_check = time.monotonic() - t_check
    # under --control the float8 reference's tokens stand in the program's
    # place and are held to the cell's own limits
    numbers = check.numbers(ctl if args.control else stats)
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in cell.limits.items()}
    correct = bool(checks) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    served = sum(len(r.tokens) for r in picked)
    log("portbench: set-up " + ", ".join(
        f"{what} at {t - T_PROCESS:.2f} s" for what, t in marks))
    if plan.loop == "closed":
        beyond = sum(r.req.round > 0 for r in results)
        log(f"portbench: {beyond} requests from a client's later rounds")
    log(f"portbench: {cell.name} seed {args.seed}: {len(due)} requests "
        f"due or sent in the window, {failed} failed; reference over "
        f"{len(picked)} finished requests ({served} served tokens) in "
        f"{t_check:.1f} s; prefix cache: {hits[0]} hits in {hits[1]} "
        f"lookups")
    if plan.loop == "open" and due:
        # a growing backlog shows as first tokens that come later and later
        thirds = [[(r.times[0] - r.t_due) * 1e3 for r in due if r.times
                   and t0 + k * (t1 - t0) / 3 <= r.t_due
                   < t0 + (k + 1) * (t1 - t0) / 3] for k in range(3)]
        log("portbench: TTFT p50 by third of the window: " + " / ".join(
            f"{readers.percentile(t, 50):.1f}" if t else "-"
            for t in thirds) + " ms")
    if late:
        log(f"portbench: the generator ran late by up to "
            f"{max(late) * 1e3:.3f} ms (p95 "
            f"{readers.percentile(late, 95) * 1e3:.3f} ms)")
    log(f"portbench: served-token gaps {stats}")
    if ctl is not None:
        log(f"portbench: control (the reference with float8 weights, "
            f"judged in the program's place) gaps {ctl}")
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    line = {"correct": bool(correct), "attempted": len(due),
            "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if late:
        line["generator_late_ms"] = {
            "max": max(late) * 1e3,
            "p95": readers.percentile(late, 95) * 1e3}
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
