"""CLI: generate (or load) a trace, replay it against an in-process
real-engine cluster, and write the scoreboard.

    python -m dynamo_tpu_torch.replay --seed 7 --out .

writes ``REPLAY_seed7.json`` and prints the ``REPLAY_SEED=7`` repro line;
exits non-zero when a cross-check fails. ``--scenario flagship`` scales the
trace up and enables the outlier/abort/reconnect/event tracks.

A copy of ``dynamo_tpu.replay.__main__``. The engines run on the card
unless ``--device cpu`` is given; ``--model 1b`` serves Llama-3.2-1B's
widths in place of the reference's tiny config (which the card's
attention kernel does not build: its head dim is 8).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from .driver import ReplaySettings, run_cluster_replay
from .scoreboard import build_scoreboard
from .trace import (
    TraceConfig, dump_jsonl, generate_gauntlet_trace, generate_trace,
    load_jsonl,
)


def scenario_config(name: str, seed: int) -> TraceConfig:
    if name == "smoke":
        return TraceConfig(
            seed=seed, num_requests=12, duration_s=2.0, base_rps=8.0,
            abort_storm_start_frac=0.3, abort_storm_end_frac=0.7,
            preempt_at_frac=0.4,
        )
    if name == "bursty":
        return TraceConfig(
            seed=seed, num_requests=32, duration_s=4.0, base_rps=10.0,
            burst_factor=3.0,
            abort_storm_start_frac=0.3, abort_storm_end_frac=0.6,
            preempt_at_frac=0.45,
        )
    if name == "flagship":
        return TraceConfig(
            seed=seed, num_requests=96, duration_s=10.0, base_rps=12.0,
            burst_factor=4.0, tenants=3, pools_per_tenant=3,
            outlier_ratio=0.08, outlier_isl=96,
            # the burst front-loads arrivals, so both storm windows sit in
            # the first half of the trace clock where requests actually land
            abort_storm_start_frac=0.15, abort_storm_end_frac=0.3,
            reconnect_storm_start_frac=0.3, reconnect_storm_end_frac=0.5,
            preempt_at_frac=0.4, store_flap_at_frac=0.65,
        )
    raise SystemExit(f"unknown scenario: {name}")


def replay_settings(model: str = "tiny", **kw) -> ReplaySettings:
    """The reference's settings for ``tiny``; for ``1b``, Llama-3.2-1B's
    widths with 16-token blocks, 512-token chunks, 16 seats per engine and
    room for a 512-token prompt plus its output."""
    if model == "tiny":
        return ReplaySettings(**kw)
    from ..engine.config import ModelConfig

    return ReplaySettings(
        model=ModelConfig.llama3_1b(), block_size=16, num_blocks=2048,
        max_model_len=1024, max_num_batched_tokens=512, max_num_seqs=16,
        **kw)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dynamo_tpu_torch.replay",
        description="trace-replay scoreboard against a real-engine cluster")
    p.add_argument("--seed", type=int,
                   default=int(os.environ.get("DYNTPU_REPLAY_SEED", "0")))
    p.add_argument("--scenario", default="bursty",
                   choices=["smoke", "bursty", "flagship", "gauntlet"])
    p.add_argument("--trace-in", default=None,
                   help="replay a JSONL trace file instead of generating")
    p.add_argument("--trace-out", default=None,
                   help="also dump the generated trace as JSONL")
    p.add_argument("--time-scale", type=float, default=2.0,
                   help="replay N× faster than recorded timestamps")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--model", default="tiny", choices=["tiny", "1b"],
                   help="engine widths: the reference's tiny config, or "
                        "Llama-3.2-1B's (the card's path)")
    p.add_argument("--device", default=None,
                   help="torch device of the engines (default: the card; "
                        "'cpu' to run on the CPU)")
    p.add_argument("--out", default=".",
                   help="directory for REPLAY_seed<N>.json")
    p.add_argument("--json", action="store_true",
                   help="print the full scoreboard JSON to stdout")
    args = p.parse_args(argv)

    if args.trace_in:
        trace = load_jsonl(args.trace_in)
    elif args.scenario == "gauntlet":
        trace = generate_gauntlet_trace(args.seed)
    else:
        trace = generate_trace(scenario_config(args.scenario, args.seed))
    if args.trace_out:
        dump_jsonl(trace, args.trace_out)

    settings = replay_settings(args.model, time_scale=args.time_scale,
                               n_workers=args.workers, device=args.device)
    if args.scenario == "gauntlet" and not args.trace_in:
        # arm the stall watchdog so the stallwave's injected wedge trips a
        # real quarantine the attribution check can see
        settings.stall_timeout_s = 0.5
        settings.stall_timeout_per_token_s = 0.01
    run = asyncio.run(run_cluster_replay(trace, settings,
                                         workdir=args.out))
    report = build_scoreboard(trace, run)

    path = os.path.join(args.out, f"REPLAY_seed{trace.seed}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)

    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(f"wrote {path}")
        print(f"requests={report['requests']} completed={report['completed']}"
              f" aborted={report['aborted']} errors={report['errors']}"
              f" digest={report['outcome_digest']}")
        for tier, row in sorted(report["tiers"].items()):
            print(f"tier {tier}: ttft p50/p99 {row['ttft_p50_ms']}/"
                  f"{row['ttft_p99_ms']} ms, itl p50/p99 {row['itl_p50_ms']}/"
                  f"{row['itl_p99_ms']} ms, viol "
                  f"{row['slo_violation_rate']}")
        for name, chk in report["checks"].items():
            state = "ok" if chk.get("ok") else f"FAIL: {chk.get('reason')}"
            print(f"check {name}: {state}")
        if report.get("faults_fired"):
            print(f"faults_fired="
                  f"{json.dumps(report['faults_fired'], sort_keys=True)}")
            print(f"chaos: slo_viol={report['chaos_slo_violation_rate']}"
                  f" recovery_p99={report['chaos_recovery_windows_p99']}"
                  f" token_loss={report['chaos_token_loss']}")
    # repro lines (grepped by scripts/verify.sh replay/chaosreplay on
    # failure; CHAOS_SEED and REPLAY_SEED are the same knob)
    if args.scenario == "gauntlet":
        print(f"CHAOS_SEED={trace.seed}")
    print(f"REPLAY_SEED={trace.seed}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
