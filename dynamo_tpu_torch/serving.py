"""Engine-serving wiring of the worker (ref: the common shape of
components/backends/*/src/dynamo/*/main.py — create runtime, serve generate +
clear_kv_blocks, attach publishers, register the model, drain on signal).

A copy of ``dynamo_tpu.serving``, with the JAX package's opt-in control
plane: the ``engine_*`` gauges and the ``obs``/``spec``/``kvbm``/
``preempt``/``faults`` keys of the load snapshot, canary health probes that
withdraw and readvertise the instance (``DYNTPU_HEALTH_CHECK_ENABLED``), the
planner's degradation watcher with ``apply_engine_clamps`` and the prefix
cache's ``evict_to_host`` rung (``DYNTPU_PLANNER_APPLY_DEGRADATION``), the
``POST /drain`` trigger of the system server (``DYNTPU_SYSTEM_ENABLED``), and
the preemption coordinator (``SIGUSR1`` or ``POST /preempt`` evacuate the
seats' KV, then drain). A disaggregated worker serves its prefill or decode
handler in place of the engine. The embeddings endpoint and the multimodal
encode handler (ROADMAP.md queue A, item 7) are not ported, so the card
advertises chat and completions only.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass
from typing import Optional

from .engine.config import EngineConfig
from .engine.engine import EngineCore
from .llm.discovery import ModelDeploymentCard, register_llm
from .llm.tokenizer import Tokenizer
from .planner.connector import planner_events_subject
from .router.publisher import KvEventPublisher, WorkerMetricsPublisher
from .runtime import codec
from .runtime.component import DistributedRuntime
from .runtime.signals import install_shutdown_signals
from .runtime.tasks import spawn_logged
from .utils.logging import get_logger

log = get_logger("serving")


@dataclass
class ServeOptions:
    name: str
    component: str = "backend"
    endpoint: str = "generate"
    advertise_host: str = "127.0.0.1"
    migration_limit: int = 3
    tool_call_parser: Optional[str] = None
    reasoning_parser: Optional[str] = None


async def serve_engine(
    runtime: DistributedRuntime,
    engine: EngineCore,
    eng_cfg: EngineConfig,
    opts: ServeOptions,
    tokenizer: Optional[Tokenizer] = None,
    handler=None,
):
    """Serve ``engine`` (or a wrapping ``handler``) on the cluster; returns
    the served endpoint and the publishers (caller owns shutdown
    ordering)."""
    await engine.start()
    endpoint = (runtime.namespace().component(opts.component)
                .endpoint(opts.endpoint))
    served = await endpoint.serve_endpoint(
        handler if handler is not None else engine,
        advertise_host=opts.advertise_host,
        metadata={"model": opts.name},
    )

    # KV events + load metrics for the KV-aware router / aggregator
    # (ref: publisher.rs; the in-process seam replaces the ZMQ relay)
    kv_pub = KvEventPublisher(endpoint.component, runtime.primary_lease)
    kv_pub.start()
    engine.kv_event_sink = kv_pub.sink
    st = getattr(engine, "spec_stats", None)
    # flight recorder: worker-local engine_* gauges on /metrics, and the
    # same snapshot rides the load-metrics wire ("obs" key) so the
    # aggregator gets per-worker MFU/goodput/waste for planner signals
    obs_fn = None
    if getattr(engine, "obs", None) is not None:
        from .observability.gauges import EngineObsGauges

        obs_gauges = EngineObsGauges(runtime.metrics, engine)
        obs_fn = obs_gauges.refresh
    kvbm = getattr(engine, "kvbm", None)
    prefix = getattr(engine, "prefix", None)
    # prefix counters ride the "kvbm" key of the load-metrics wire; an
    # index-only prefix cache (no KVBM attached) still publishes them
    if kvbm is not None:
        kvbm_fn = kvbm.snapshot
    elif prefix is not None:
        kvbm_fn = prefix.snapshot
    else:
        kvbm_fn = None

    def _faults_fired() -> dict:
        # installed via /debug/faults (chaos replay) or in-process tests;
        # empty when no plan is active so the snapshot stays lean
        from .runtime import faults

        plan = faults.current()
        return plan.fired_counts() if plan is not None else {}

    metrics_pub = WorkerMetricsPublisher(
        endpoint.component, runtime.primary_lease, lambda: engine.stats,
        spec_fn=st.to_dict if st is not None else None,
        obs_fn=obs_fn,
        kvbm_fn=kvbm_fn,
        faults_fn=_faults_fired,
    )
    metrics_pub.start()

    async def clear_kv(request, context):
        engine.clear_kv_blocks()
        yield {"cleared": True}

    clear_ep = (runtime.namespace().component(opts.component)
                .endpoint("clear_kv_blocks"))
    await clear_ep.serve_endpoint(
        clear_kv, advertise_host=opts.advertise_host
    )

    # active canary probes through the real generate path
    # (ref: health_check.rs:44; enabled by DYNTPU_HEALTH_CHECK_ENABLED)
    if runtime.config.health_check_enabled:
        from .runtime.health import (
            HealthCheckConfig, HealthCheckManager, engine_canary,
        )

        def _withdraw(name: str) -> None:
            log.warning("health probe %s unhealthy — withdrawing instance", name)
            spawn_logged(served.withdraw(), name="health-withdraw")

        def _readvertise(name: str) -> None:
            log.info("health probe %s recovered — re-advertising instance", name)
            spawn_logged(served.readvertise(), name="health-readvertise")

        health = HealthCheckManager(
            HealthCheckConfig(period_s=runtime.config.health_check_period_s),
            on_unhealthy=_withdraw,
            on_recovered=_readvertise,
        )
        target = f"{opts.component}/{opts.endpoint}"
        health.register(target, engine_canary(
            handler if handler is not None else engine
        ))
        health.start()
        served.health_manager = health
        if runtime.system_server is not None:
            runtime.system_server.register_probe(
                target, lambda: health.status(target)
            )

    # the planner's degradation ladder can clamp spec_k /
    # prefill_chunk_tokens cluster-wide; opt-in per worker
    # (DYNTPU_PLANNER_APPLY_DEGRADATION) because mutating a live engine
    # config is a behavior change operators must choose
    if runtime.config.planner_apply_degradation:
        from .planner.degradation import (
            DegradationWatcher, apply_engine_clamps,
        )

        originals: dict = {}

        def _apply(actions: dict) -> None:
            changed = apply_engine_clamps(eng_cfg, actions, originals)
            if changed:
                log.info("degradation orders applied to engine: %s", changed)
            # evict_to_host rung: demote idle G1 prefix blocks to the host
            # pool (prefix.manager) — fires on every order change while
            # the rung holds (each deeper engage/release re-delivers it)
            n_evict = int(actions.get("evict_to_host") or 0)
            px = getattr(engine, "prefix", None)
            if n_evict > 0 and px is not None:
                spawn_logged(px.evict_to_host(n_evict),
                             name="prefix-evict-to-host")

        served.degradation_watcher = DegradationWatcher(
            runtime.store, runtime.namespace().name, _apply
        )
        served.degradation_watcher.start()

    if tokenizer is not None:
        card = ModelDeploymentCard(
            name=opts.name,
            model_type=["chat", "completions"],
            tokenizer_json=tokenizer.to_json_str(),
            chat_template=tokenizer.chat_template,
            context_length=eng_cfg.max_model_len,
            kv_block_size=eng_cfg.block_size,
            migration_limit=opts.migration_limit,
            eos_token_ids=list(tokenizer.eos_token_ids),
            bos_token_id=tokenizer.bos_token_id,
            runtime_config={
                "total_kv_blocks": eng_cfg.num_blocks,
                "max_num_seqs": eng_cfg.max_num_seqs,
                "max_num_batched_tokens": eng_cfg.max_num_batched_tokens,
            },
            tool_call_parser=opts.tool_call_parser,
            reasoning_parser=opts.reasoning_parser,
        )
        await register_llm(endpoint, card)

    return served, kv_pub, metrics_pub


async def run_until_shutdown(
    runtime: DistributedRuntime, engine: EngineCore,
    served, kv_pub, metrics_pub,
) -> None:
    """Install the graceful drain triggers (SIGINT/SIGTERM and, when the
    system server is up, ``POST /drain``), the maintenance-notice triggers
    (SIGUSR1 / ``POST /preempt`` → evacuating drain), then block on runtime
    shutdown."""
    from .runtime.preemption import (
        PreemptionCoordinator, install_preemption_signal,
    )

    loop = asyncio.get_running_loop()

    def _graceful():
        log.info("drain requested — deregistering and finishing in-flight "
                 "work (deadline %.1fs)", runtime.config.drain_timeout_s)
        spawn_logged(_shutdown(), name="drain-shutdown")

    async def _shutdown():
        health = getattr(served, "health_manager", None)
        if health is not None:
            await health.stop()
        degradation = getattr(served, "degradation_watcher", None)
        if degradation is not None:
            await degradation.stop()
        await served.drain_and_stop(
            deadline_s=runtime.config.drain_timeout_s
        )
        await kv_pub.stop()
        await metrics_pub.stop()
        await engine.stop()
        await runtime.shutdown()

    # signals and POST /drain share one once-latch: whichever arrives
    # first starts the drain, the rest are no-ops (a REPEAT signal while
    # draining hard-exits — see runtime/signals.py)
    guard = install_shutdown_signals(_graceful, loop=loop, name="worker-drain")
    if runtime.system_server is not None:
        runtime.system_server.register_drain(
            served.endpoint.path, guard.trigger
        )

    # maintenance notices: evacuate in-flight KV (peer / host tier / re-
    # prefill fallback), tell the planner so it scales the replacement
    # proactively, then run the same graceful drain
    subject = planner_events_subject(runtime.namespace().name)

    def _preempt_event(event: dict) -> None:
        spawn_logged(
            runtime.store.publish(subject, codec.packb(event)),
            name="preempt-event",
        )

    coordinator = PreemptionCoordinator(
        engine,
        worker_key=served.endpoint.path,
        notice_grace_s=runtime.config.preempt_notice_grace_s,
        evac_deadline_s=runtime.config.preempt_evac_deadline_s,
        journal_cap=runtime.config.preempt_journal_cap,
        on_event=_preempt_event,
    )
    served.preemption = coordinator

    async def _notice_then_drain(reason: str) -> None:
        await coordinator.notice(reason)
        guard.trigger()

    def _on_notice(reason: str):
        return lambda: spawn_logged(
            _notice_then_drain(reason), name="preempt-notice"
        )

    try:
        install_preemption_signal(coordinator, loop=loop, then=guard.trigger)
    except (NotImplementedError, RuntimeError):
        pass  # no SIGUSR1 on this platform — HTTP trigger still works
    if runtime.system_server is not None:
        runtime.system_server.register_preempt(
            served.endpoint.path, _on_notice("admin")
        )
    metrics_pub.preempt_fn = lambda: {
        "notices": coordinator.num_notices,
        "evacuated_total": coordinator.num_evacuated,
        "spilled_total": coordinator.num_spilled,
        "fallbacks_total": coordinator.num_fallbacks,
    }

    await runtime.shutdown_event.wait()


def load_tokenizer(path: Optional[str]) -> Optional[Tokenizer]:
    """A ``tokenizer.json`` file, or a local HuggingFace directory."""
    if path is None:
        return None
    if os.path.isdir(path):
        return Tokenizer.from_pretrained_dir(path)
    return Tokenizer.from_file(path)
