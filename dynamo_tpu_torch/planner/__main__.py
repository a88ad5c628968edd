"""Planner process: subscribe to frontend window stats + aggregator
signals, order degradation, emit scaling targets
(ref: components/planner/src/dynamo/planner — start_sla_planner).

    python -m dynamo_tpu_torch.planner --profile profile.json \
        --ttft 0.5 --itl 0.05 --adjustment-interval 30

The profile file carries the SLA profiler's curves (see
``dynamo_tpu_torch.planner.interpolation`` for the keys). Targets are
written to the store under ``planner/{namespace}/target/*`` (virtual
connector); an orchestrator (``dynamo_tpu_torch.planner.orchestrator``
against a worker pool, or deploy/scripts/scale_watcher.py) realises them. Degradation orders land at
``planner/{namespace}/degradation`` for frontends/workers to apply.

A copy of ``dynamo_tpu.planner.__main__``; window stats and signals are
decoded by the port's codec (``runtime/codec.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import json

from ..runtime import codec
from ..runtime.component import DistributedRuntime
from ..utils.config import RuntimeConfig
from ..utils.logging import get_logger
from .connector import VirtualConnector
from .core import Planner, PlannerConfig, WindowMetrics
from .degradation import DegradationConfig
from .interpolation import DecodeInterpolator, PrefillInterpolator

log = get_logger("planner.main")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo-tpu SLA planner")
    p.add_argument("--store-addr", default=None)
    p.add_argument("--namespace", default=None)
    p.add_argument("--profile", required=True,
                   help="JSON file with profiled perf curves")
    p.add_argument("--ttft", type=float, default=0.5, help="TTFT SLA (s)")
    p.add_argument("--itl", type=float, default=0.05, help="ITL SLA (s)")
    p.add_argument("--adjustment-interval", type=float, default=30.0)
    p.add_argument("--prefill-chips", type=int, default=1)
    p.add_argument("--decode-chips", type=int, default=1)
    p.add_argument("--max-chip-budget", type=int, default=64)
    p.add_argument("--min-endpoint", type=int, default=1)
    p.add_argument("--prefill-component", default="prefill")
    p.add_argument("--decode-component", default="backend")
    p.add_argument(
        "--sla-quantile", default=None, choices=["p99", "p50", "avg"],
        help="latency statistic the SLAs are enforced on (default "
             "DYNTPU_PLANNER_SLA_QUANTILE, 'p99'; 'avg' restores the "
             "pre-percentile behavior)",
    )
    p.add_argument(
        "--no-degradation", action="store_true",
        help="disable the graceful-degradation ladder (shed low tiers -> "
             "clamp spec_k -> tighten prefill chunking before scaling)",
    )
    p.add_argument(
        "--engage-ratio", type=float, default=None,
        help="SLO overshoot ratio at/above which the next ladder step "
             "engages (default DYNTPU_PLANNER_ENGAGE_RATIO, 1.5)",
    )
    p.add_argument(
        "--release-ratio", type=float, default=None,
        help="SLO ratio at/below which the last ladder step releases "
             "(default DYNTPU_PLANNER_RELEASE_RATIO, 1.0)",
    )
    p.add_argument(
        "--shed-tier", type=int, default=None,
        help="min admitted request tier while shed_low_tier is engaged "
             "(default DYNTPU_PLANNER_SHED_TIER, 1)",
    )
    p.add_argument(
        "--spec-k-clamp", type=int, default=None,
        help="spec_k ceiling while clamp_spec_k is engaged "
             "(default DYNTPU_PLANNER_SPEC_K_CLAMP, 1)",
    )
    p.add_argument(
        "--chunk-clamp-tokens", type=int, default=None,
        help="prefill_chunk_tokens ceiling while tighten_chunking is "
             "engaged (default DYNTPU_PLANNER_CHUNK_CLAMP_TOKENS, 256)",
    )
    p.add_argument(
        "--connector", default="virtual",
        choices=["virtual", "kubernetes"],
        help="virtual: write targets into the store (an orchestrator like "
             "scale_watcher realises them); kubernetes: merge-patch the "
             "TpuGraphDeployment CR in-cluster (ref: kubernetes_connector)",
    )
    p.add_argument("--k8s-deployment", default=None,
                   help="TpuGraphDeployment name (default: the single CR "
                        "in the pod's namespace)")
    return p.parse_args(argv)


async def run_planner(args: argparse.Namespace) -> None:
    config = RuntimeConfig.from_settings()
    if args.store_addr:
        config.store_addr = args.store_addr
    if args.namespace:
        config.namespace = args.namespace
    runtime = await DistributedRuntime.from_settings(config)

    with open(args.profile) as f:
        profile = json.load(f)
    if args.connector == "kubernetes":
        from .kubernetes_connector import KubernetesConnector

        connector = KubernetesConnector(deployment_name=args.k8s_deployment)
    else:
        connector = VirtualConnector(runtime.store,
                                     namespace=runtime.namespace().name)

    def _or(cli, cfg_val):
        return cfg_val if cli is None else cli

    degradation = None
    if config.planner_degradation_enabled and not args.no_degradation:
        degradation = DegradationConfig(
            engage_ratio=_or(args.engage_ratio, config.planner_engage_ratio),
            release_ratio=_or(args.release_ratio,
                              config.planner_release_ratio),
            shed_tier=_or(args.shed_tier, config.planner_shed_tier),
            spec_k_clamp=_or(args.spec_k_clamp,
                             config.planner_spec_k_clamp),
            chunk_clamp_tokens=_or(args.chunk_clamp_tokens,
                                   config.planner_chunk_clamp_tokens),
        )
    planner = Planner(
        PlannerConfig(
            ttft_sla_s=args.ttft,
            itl_sla_s=args.itl,
            adjustment_interval_s=args.adjustment_interval,
            prefill_engine_num_chips=args.prefill_chips,
            decode_engine_num_chips=args.decode_chips,
            min_endpoint=args.min_endpoint,
            max_chip_budget=args.max_chip_budget,
            sla_quantile=_or(args.sla_quantile,
                             config.planner_sla_quantile),
            degradation=degradation,
        ),
        PrefillInterpolator.from_profile(profile),
        DecodeInterpolator.from_profile(profile),
        connector,
        prefill_component=args.prefill_component,
        decode_component=args.decode_component,
    )

    ns = runtime.namespace().name
    # latest aggregator-published signals, merged into each frontend window
    signals = {"queue_depth": 0, "spec_acceptance": None,
               "preempt_notices": 0}

    def _window_from(win: dict) -> WindowMetrics:
        return WindowMetrics(
            num_requests=win.get("num_requests") or 0,
            isl_avg=win.get("isl_avg") or 0,
            osl_avg=win.get("osl_avg") or 0,
            ttft_avg_s=win.get("ttft_avg_s"),
            itl_avg_s=win.get("itl_avg_s"),
            ttft_p50_s=win.get("ttft_p50_s"),
            ttft_p99_s=win.get("ttft_p99_s"),
            itl_p50_s=win.get("itl_p50_s"),
            itl_p99_s=win.get("itl_p99_s"),
            # frontend admission backlog + worker queues (aggregator feed)
            queue_depth=((win.get("queue_depth") or 0)
                         + (signals["queue_depth"] or 0)),
            breaker_open=win.get("breaker_open") or 0,
            spec_acceptance=(win.get("spec_acceptance")
                             if win.get("spec_acceptance") is not None
                             else signals["spec_acceptance"]),
            preempt_notices=signals["preempt_notices"] or 0,
        )

    async def _subscribe_loop(subject, handler):
        sub = await runtime.store.subscribe(subject)
        while True:
            event = await sub.next()
            if event is None or event["event"] == "dropped":
                log.warning("%s subscription lost — resubscribing", subject)
                await sub.cancel()
                while True:  # outlast a store reconnect window
                    try:
                        sub = await runtime.store.subscribe(subject)
                        break
                    except Exception:
                        log.exception("resubscribe failed — retrying")
                        await asyncio.sleep(0.5)
                continue
            if event["event"] != "msg":
                continue
            try:
                handler(codec.unpackb(event["value"]))
            except Exception:
                log.exception("bad payload on %s", subject)

    def _on_window(win: dict) -> None:
        planner.observe(_window_from(win))

    def _on_signals(payload: dict) -> None:
        signals["queue_depth"] = payload.get("queue_depth") or 0
        signals["spec_acceptance"] = payload.get("spec_acceptance")
        signals["preempt_notices"] = payload.get("preempt_notices") or 0

    tasks = [
        asyncio.create_task(
            _subscribe_loop(f"{ns}/frontend_stats", _on_window)),
        asyncio.create_task(
            _subscribe_loop(f"{ns}/planner_signals", _on_signals)),
    ]
    log.info("planner running (interval=%ss quantile=%s degradation=%s)",
             args.adjustment_interval, planner.config.sla_quantile,
             "on" if degradation is not None else "off")
    try:
        while True:
            await asyncio.sleep(args.adjustment_interval)
            try:
                await planner.make_adjustments()
            except Exception:
                # a transient connector failure (apiserver 5xx, network
                # blip) must not kill the planner — next window retries
                log.exception("adjustment failed — retrying next window")
    finally:
        for t in tasks:
            t.cancel()
        await runtime.shutdown()


def main(argv=None) -> None:
    asyncio.run(run_planner(parse_args(argv)))


if __name__ == "__main__":
    main()
