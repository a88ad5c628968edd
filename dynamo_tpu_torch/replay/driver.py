"""Open-loop, timestamp-faithful trace replay.

Two targets share one outcome shape:

- :func:`run_cluster_replay` — in-process real-engine deployment: a
  ``SimCluster`` whose workers serve the port's ``InferenceEngine``s
  behind real runtimes/ingress, routed through the KV-aware router and
  Migration carryover. Because everything runs in one process, the driver
  can also harvest the internal instrumentation the scoreboard
  cross-checks against: flight-recorder lifetime totals, scheduler
  prefix-cache counters, and the global span collector.
- :func:`run_http_replay` — a live HTTP frontend, reusing the loadgen
  streaming SSE measurement (client-side metrics only; the span/recorder
  halves of the cross-check then come from the deployment's exporters).

Replay is *open-loop*: request ``i`` fires at ``arrival_s / time_scale``
regardless of how the cluster is doing — backpressure shows up as latency,
exactly like production. The event track (maintenance preemption, worker
kill, store flap) fires on the same clock.

Client behaviour encoded in the trace is honoured here:

- ``abort_after_tokens`` — the client disconnects after N tokens (the
  abort-storm shape); the request scores as aborted, not failed.
- ``reconnect_after_tokens`` — the client drops and re-issues once with
  its received history as the prompt (budget shrunk accordingly).
- ``finish_reason == "evacuated"`` — a maintenance evacuation finished the
  stream (the notice path); the driver re-issues with carryover, the
  client-visible contract the notice path promises.

Worker kills mid-stream surface as broken streams and are retried by
Migration itself (token carryover, original prompt-length reporting).

A copy of ``dynamo_tpu.replay.driver``. The engines are the port's, on the
card unless ``ReplaySettings.device`` asks for another device, at the
reference's tiny config unless ``ReplaySettings.model`` gives a width; each
engine counts as one chip, as the reference counts each engine's mesh (so
two engines sharing one card count two). The HTTP target streams through
the port's own HTTP/1.1 client (``utils/httpclient.py``).
"""

from __future__ import annotations

import asyncio
import json
import random
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from ..llm.migration import Migration
from ..router.kv_router import KvPushRouter, KvRouter
from ..router.scheduler import KvRouterConfig
from ..runtime import faults
from ..runtime.circuit import BreakerConfig, CircuitBreakerRegistry
from ..runtime.component import DistributedRuntime
from ..runtime.context import Context
from ..runtime.store import StoreServer
from ..utils.config import RuntimeConfig
from ..utils.httpclient import HttpClient
from ..utils.logging import get_logger
from ..mocker.cluster import SimCluster, _free_port
from ..tracing import (
    InMemorySpanExporter, configure as tracing_configure, get_tracer,
    reset as tracing_reset,
)
from .trace import ReplayTrace, TraceRequest

if TYPE_CHECKING:
    from ..engine.config import ModelConfig

log = get_logger("replay.driver")


@dataclass
class ReplaySettings:
    """Cluster-target replay knobs. ``time_scale`` compresses the trace
    clock: wall delay = trace offset / time_scale."""

    time_scale: float = 1.0
    n_workers: int = 2
    engine_seed: int = 0
    vocab_size: int = 256
    num_blocks: int = 96
    block_size: int = 4
    max_model_len: int = 160
    max_num_batched_tokens: int = 160
    max_num_seqs: int = 4
    migration_limit: int = 8
    resume_limit: int = 4          # driver-level re-issues per request
    drain_deadline_s: float = 0.2
    request_timeout_s: float = 120.0
    # max extra wall wait for an evacuable decode seat before a scheduled
    # "preempt" event sends its notice (0 = fire exactly on schedule)
    preempt_wait_s: float = 8.0
    # stall watchdog (off by default, matching EngineConfig); gauntlet
    # scenarios arm it so engine.stall delay faults trip real quarantines
    stall_timeout_s: float = 0.0
    stall_timeout_per_token_s: float = 0.0
    # the engines' widths (None = ModelConfig.tiny(vocab_size), the
    # reference's) and their device (None = the card)
    model: Optional["ModelConfig"] = None
    device: Optional[str] = None


def _decode_buckets(max_num_seqs: int) -> Tuple[int, ...]:
    """(4, 8), doubled until the largest holds every seat."""
    buckets = [4, 8]
    while buckets[-1] < max_num_seqs:
        buckets.append(buckets[-1] * 2)
    return tuple(buckets)


@dataclass
class RequestOutcome:
    """Client-side record of one replayed request, plus the bookkeeping
    the cross-checks need (trace id, per-submission token accounting)."""

    request_id: str
    tenant: str
    pool: int
    tier: int
    isl: int
    osl: int
    arrival_s: float
    trace_id: str = ""
    ttft_s: Optional[float] = None
    itls: List[float] = field(default_factory=list)
    end_s: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    aborted: bool = False
    resumes: int = 0        # evacuated-seat re-issues by the driver
    reconnects: int = 0     # client-drop re-issues by the driver
    # (prompt_len, tokens_received) per driver-visible submission — the
    # client side of the recorder token reconciliation
    submissions: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def completed(self) -> bool:
        return self.error is None and (self.aborted
                                       or self.finish_reason is not None)


@dataclass
class ReplayRunResult:
    outcomes: List[RequestOutcome]
    elapsed_s: float
    time_scale: float
    events_fired: List[dict]
    # engine-internal truth, summed over live + killed workers
    recorder_goodput_tokens: float
    recorder_steps: float
    prefix_hits_blocks: int
    prefix_queries_blocks: int
    block_size: int
    chips: int
    device_kind: str
    platform: str
    spans: List[dict]
    preempt: Dict[str, int]
    num_kills: int
    seed: int
    # chaos track: plan firing counts (``site/kind`` → n), the full firing
    # log, and the observability evidence counters the fault-attribution
    # cross-check reconciles the firings against
    faults_fired: Dict[str, int] = field(default_factory=dict)
    fault_log: List[dict] = field(default_factory=list)
    evidence: Dict[str, float] = field(default_factory=dict)
    # the radix prefix index's OWN hit accounting (event-fed, independent
    # of the scheduler counters above) — prefix_vs_index fails the run
    # when the two disagree
    prefix_index_hit_tokens: float = 0.0
    prefix_index_queries: float = 0.0
    # the engines' widths, for the scoreboard's roofline (None = tiny)
    model: Optional["ModelConfig"] = None


async def _drive_one(
    req: TraceRequest, mig: Migration, outcome: RequestOutcome,
    settings: ReplaySettings, loop: asyncio.AbstractEventLoop,
) -> None:
    """Issue one trace request, honouring abort/reconnect behaviour and
    re-issuing with carryover when a maintenance evacuation finishes the
    stream. Tokens are deduped per attempt by frame index (finish frames
    re-carry the last token) and spliced across driver re-issues."""
    prompt = list(req.token_ids)
    budget = req.osl
    got: List[int] = []
    ctx = Context(request_id=req.request_id)
    outcome.trace_id = ctx.trace.trace_id
    abort_at = req.abort_after_tokens
    reconnect_at = req.reconnect_after_tokens
    t0 = loop.time()
    prev: Optional[float] = None
    try:
        for submission in range(settings.resume_limit + 1):
            if submission == 0:
                sub_ctx = ctx
            else:
                # re-issues need a DISTINCT request id: the engine keys
                # seats by it, and a carryover landing on the same worker
                # while the dropped seat is still cancelling would collide
                # (ctx.child() keeps the parent id). Same trace, though —
                # the span timeline must stay assembled per request.
                sub_ctx = ctx.link_child(Context(
                    request_id=f"{req.request_id}+r{submission}",
                    trace=ctx.trace.child()))
            stream = mig.generate(
                {"token_ids": prompt, "max_tokens": budget,
                 "ignore_eos": True},
                sub_ctx,
            )
            toks: Dict[int, int] = {}
            reason: Optional[str] = None
            dropped = False
            try:
                async for frame in stream:
                    now = loop.time()
                    for t in frame.get("token_ids", []):
                        if t >= 0:
                            toks[frame["index"]] = t
                    n_total = len(got) + len(toks)
                    if n_total > 0:
                        if outcome.ttft_s is None:
                            outcome.ttft_s = now - t0
                        elif prev is not None and now > prev:
                            outcome.itls.append(now - prev)
                        prev = now
                    if frame.get("finished"):
                        reason = frame.get("finish_reason")
                        break
                    if abort_at is not None and n_total >= abort_at:
                        outcome.aborted = True
                        break
                    if reconnect_at is not None and n_total >= reconnect_at:
                        reconnect_at = None
                        outcome.reconnects += 1
                        dropped = True
                        break
            finally:
                await stream.aclose()
            attempt_tokens = [toks[i] for i in sorted(toks)]
            outcome.submissions.append((len(prompt), len(attempt_tokens)))
            got.extend(attempt_tokens)
            if outcome.aborted:
                outcome.finish_reason = "aborted"
                break
            if reason == "evacuated" or dropped:
                if reason == "evacuated":
                    outcome.resumes += 1
                budget = req.osl - len(got)
                if budget <= 0:
                    outcome.finish_reason = "length"
                    break
                prompt = list(req.token_ids) + got
                continue
            outcome.finish_reason = reason
            break
        else:
            outcome.error = "resume limit exhausted"
    except Exception as exc:  # noqa: BLE001 — per-request isolation
        outcome.error = f"{type(exc).__name__}: {exc}"
    outcome.tokens = got
    outcome.end_s = loop.time() - t0


async def run_cluster_replay(
    trace: ReplayTrace, settings: Optional[ReplaySettings] = None,
    workdir: str = ".",
) -> ReplayRunResult:
    """Replay ``trace`` against an in-process real-engine SimCluster and
    return outcomes plus the engine-internal truth the scoreboard
    cross-checks against.

    A fresh :class:`faults.FaultPlan` seeded from the trace is installed
    for the whole run; ``fault`` events on the trace's event track append
    their wave's rules to it (the in-process twin of POSTing the wave to a
    live worker's ``/debug/faults``), and its firing log is returned for
    the scoreboard's fault-attribution cross-check."""
    plan = faults.FaultPlan(seed=trace.seed)
    faults.install(plan)
    try:
        return await _cluster_replay(trace, settings, workdir, plan)
    finally:
        faults.clear()


async def _cluster_replay(
    trace: ReplayTrace, settings: Optional[ReplaySettings],
    workdir: str, plan: faults.FaultPlan,
) -> ReplayRunResult:
    from ..engine.config import EngineConfig, ModelConfig
    from ..engine.engine import InferenceEngine
    from ..runtime.preemption import PreemptionCoordinator

    settings = settings or ReplaySettings()
    scale = max(settings.time_scale, 1e-6)

    # full-fidelity spans into a fresh in-memory sink: the TTFT cross-check
    # needs every worker.queue / engine.prefill span of this run, no
    # sampling, no spans from earlier tests
    tracing_reset()
    tracing_configure(sample_ratio=1.0)
    mem = InMemorySpanExporter()
    get_tracer().add_exporter(mem)

    model_cfg = (settings.model if settings.model is not None
                 else ModelConfig.tiny(vocab_size=settings.vocab_size))
    eng_cfg = EngineConfig(
        num_blocks=settings.num_blocks, block_size=settings.block_size,
        max_model_len=settings.max_model_len,
        max_num_batched_tokens=settings.max_num_batched_tokens,
        prefill_buckets=(settings.max_num_batched_tokens,),
        decode_buckets=_decode_buckets(settings.max_num_seqs),
        max_num_seqs=settings.max_num_seqs,
        stall_timeout_s=settings.stall_timeout_s,
        stall_timeout_per_token_s=settings.stall_timeout_per_token_s,
    )

    def _engine() -> InferenceEngine:
        # identical seeds: greedy continuations after migration or
        # evacuation resume are byte-identical wherever they land
        return InferenceEngine(model_cfg, eng_cfg, seed=settings.engine_seed,
                               device=settings.device)

    port = _free_port()
    snap = f"{workdir}/replay-store.snap"
    stores = {"live": StoreServer("127.0.0.1", port, persist_path=snap)}
    await stores["live"].start()
    cfg = RuntimeConfig(
        store_addr=f"127.0.0.1:{port}",
        namespace="replay",
        store_reconnect_base_s=0.05,
        store_reconnect_cap_s=0.2,
        store_recover_timeout_s=15.0,
        store_reconcile_grace_s=0.5,
        # every runtime spawn re-configures the process-global tracer from
        # its config — keep full-fidelity sampling through worker startup
        trace_sample_ratio=1.0,
    )
    cluster = SimCluster(
        cfg, namespace="replay", engine_factory=_engine,
        drain_deadline_s=settings.drain_deadline_s,
    )
    await cluster.start(0, settings.n_workers)

    front = await DistributedRuntime.from_settings(cfg)
    client = await (front.namespace("replay")
                    .component(cluster.decode_component)
                    .endpoint("generate").client())
    await client.wait_for_instances(settings.n_workers, timeout_s=30.0)
    breakers = CircuitBreakerRegistry(
        BreakerConfig(failure_threshold=3, open_timeout_s=1.0))
    router = KvRouter(
        client, client.endpoint.component,
        block_size=settings.block_size, use_events=False, seed=0,
        config=KvRouterConfig(replica_sync=False, snapshot_threshold=0),
        breakers=breakers,
    )
    mig = Migration(KvPushRouter(router),
                    migration_limit=settings.migration_limit,
                    backoff_base_s=0.01,
                    rng=random.Random(trace.seed))

    def _engine_of(wid: int) -> InferenceEngine:
        return cluster._workers[wid].engine

    # index-only prefix caches (no KVBM in this deployment): the radix
    # index mirrors each pool from its event stream and keeps its own
    # hit accounting — the independent side of the prefix_vs_index check
    for wid in cluster.workers(cluster.decode_component):
        _engine_of(wid).attach_prefix_cache(worker_id=wid)

    # warm every engine once (first compile + recorder warmup), then zero
    # the lifetime totals so they count replay work only, and baseline the
    # prefix-cache counters (warmup adds queries)
    for wid in cluster.workers(cluster.decode_component):
        eng = _engine_of(wid)
        async for _ in eng.generate(
            {"token_ids": [2, 3, 4, 5], "max_tokens": 2,
             "ignore_eos": True},
            Context(request_id=f"warmup-{wid}"),
        ):
            pass
        eng.mark_obs_warmup_done()
    prefix_base: Dict[int, Tuple[int, int]] = {}
    index_base: Dict[int, Tuple[int, int]] = {}
    for wid in cluster.workers(cluster.decode_component):
        eng = _engine_of(wid)
        st = eng.scheduler.stats
        prefix_base[wid] = (st.prefix_cache_hits, st.prefix_cache_queries)
        px = eng.prefix.index
        index_base[wid] = (px.hit_tokens_total, px.queries_total)
    mem.clear()

    # retired-worker accumulators: totals harvested just before a kill
    retired = {"goodput": 0.0, "steps": 0.0, "hits": 0, "queries": 0,
               "index_hit_tokens": 0, "index_queries": 0,
               "stalls": 0.0, "store_recoveries": 0.0,
               "store_call_errors": 0.0}
    preempt_counts = {"notices": 0, "evacuated_peer": 0, "spilled": 0,
                      "fallbacks": 0, "seats": 0}
    events_fired: List[dict] = []

    def _harvest(wid: int) -> None:
        eng = _engine_of(wid)
        obs = eng.obs_snapshot() or {}
        retired["goodput"] += float(obs.get("total_goodput_tokens", 0.0))
        retired["steps"] += float(obs.get("total_steps", 0.0))
        retired["stalls"] += float(obs.get("stalls_total", 0.0))
        st = eng.scheduler.stats
        base = prefix_base.pop(wid, (0, 0))
        retired["hits"] += st.prefix_cache_hits - base[0]
        retired["queries"] += st.prefix_cache_queries - base[1]
        px = getattr(eng, "prefix", None)
        if px is not None:
            ib = index_base.pop(wid, (0, 0))
            retired["index_hit_tokens"] += px.index.hit_tokens_total - ib[0]
            retired["index_queries"] += px.index.queries_total - ib[1]
        rt = cluster._workers[wid].runtime
        retired["store_recoveries"] += float(rt.store.num_recoveries)
        retired["store_call_errors"] += float(
            getattr(rt.store, "num_call_errors", 0))

    loop = asyncio.get_running_loop()
    t0 = loop.time()

    async def _events() -> None:
        for ev in trace.events:
            delay = t0 + ev.at_s / scale - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            wids = sorted(cluster.workers(cluster.decode_component))
            fired = {"kind": ev.kind, "at_s": ev.at_s}
            if ev.kind == "fault":
                # in-process twin of POSTing the wave to /debug/faults:
                # the wave's rules land on the one process-global plan
                wave = str(ev.params.get("wave", ""))
                rules = list(ev.params.get("rules", []))
                added = [faults.FaultRule.from_dict(dict(rd))
                         for rd in rules]
                for rule in added:
                    plan.add(rule)
                # clock-gated rules (lease keepalives tick on a wall-clock
                # phase set at spawn) are kicked through the addressed
                # worker's client so the firing count is exactly ``times``
                # every run — the live /debug/faults install does the same
                if wids:
                    widx = int(ev.params.get("worker_index", 0))
                    rt = cluster._workers[wids[widx % len(wids)]].runtime
                    for rule in added:
                        if (rule.site == "store.call"
                                and rule.match == "lease_keepalive"):
                            for _ in range(max(1, int(rule.times or 1))):
                                await rt.store.kick_keepalive()
                fired["wave"] = wave
                fired["rules"] = len(rules)
            elif ev.kind == "fault_clear":
                wave = str(ev.params.get("wave", ""))
                fired["wave"] = wave
                fired["removed"] = plan.clear_wave(wave)
            elif ev.kind == "preempt" and wids:
                # addressed victim: the trace's seeded worker_index maps
                # onto the sorted worker list — the same arithmetic the
                # live-HTTP driver uses, so both modes preempt identical
                # victims under one seed. The scheduled offset can land
                # while everything is still queued or mid-prefill (CPU
                # replays run far slower than the trace clock), so wait —
                # bounded — for a decode seat worth evacuating.
                if "worker_index" in ev.params:
                    wid = wids[int(ev.params["worker_index"]) % len(wids)]
                    deadline = loop.time() + settings.preempt_wait_s
                    while (loop.time() < deadline
                           and not _engine_of(wid).evacuable_seats()):
                        await asyncio.sleep(0.05)
                else:
                    # legacy traces without targeting: busiest worker
                    deadline = loop.time() + settings.preempt_wait_s
                    while (loop.time() < deadline
                           and not any(_engine_of(w).evacuable_seats()
                                       for w in wids)):
                        await asyncio.sleep(0.05)
                    wid = max(wids, key=lambda w: (
                        len(_engine_of(w).evacuable_seats()), -w))
                coord = PreemptionCoordinator(
                    _engine_of(wid), worker_key=f"replay-{wid}",
                    notice_grace_s=0.0, evac_deadline_s=10.0,
                )
                report = await coord.notice(
                    str(ev.params.get("reason", "maintenance")))
                preempt_counts["notices"] += coord.num_notices
                preempt_counts["evacuated_peer"] += coord.num_evacuated
                preempt_counts["spilled"] += coord.num_spilled
                preempt_counts["fallbacks"] += coord.num_fallbacks
                preempt_counts["seats"] += len(report.results)
                fired["worker"] = wid
                fired["seats"] = len(report.results)
                if ev.params.get("kill"):
                    _harvest(wid)
                    await cluster.kill(wid)
                    fired["killed"] = True
            elif ev.kind == "kill_worker" and wids:
                wid = wids[int(ev.params.get("worker_index", -1))
                           % len(wids)]
                _harvest(wid)
                await cluster.kill(wid)
                fired["worker"] = wid
            elif ev.kind == "store_flap":
                down = float(ev.params.get("down_s", 0.2)) / scale
                await stores["live"].stop()
                await asyncio.sleep(down)
                stores["live"] = StoreServer("127.0.0.1", port,
                                             persist_path=snap)
                await stores["live"].start()
                fired["down_s"] = down
            events_fired.append(fired)
            log.info("replay event fired: %s", fired)

    outcomes: List[RequestOutcome] = []
    for r in trace.requests:
        outcomes.append(RequestOutcome(
            request_id=r.request_id, tenant=r.tenant, pool=r.pool,
            tier=r.tier, isl=r.isl, osl=r.osl, arrival_s=r.arrival_s,
        ))

    async def _fire(i: int) -> None:
        r = trace.requests[i]
        delay = t0 + r.arrival_s / scale - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        try:
            await asyncio.wait_for(
                _drive_one(r, mig, outcomes[i], settings, loop),
                timeout=settings.request_timeout_s,
            )
        except asyncio.TimeoutError:
            outcomes[i].error = "replay timeout"

    events_task = asyncio.create_task(_events())
    await asyncio.gather(*(_fire(i) for i in range(len(trace.requests))))
    await events_task
    elapsed = loop.time() - t0
    # let worker-side stream teardown land its stage spans
    await asyncio.sleep(0.2)

    # engine-internal truth: live workers + harvested kills
    goodput = retired["goodput"]
    steps = retired["steps"]
    hits, queries = retired["hits"], retired["queries"]
    index_hit_tokens = retired["index_hit_tokens"]
    index_queries = retired["index_queries"]
    stalls = retired["stalls"]
    store_recoveries = retired["store_recoveries"]
    store_call_errors = retired["store_call_errors"]
    chips = 0
    device_kind, platform = "cpu", "cpu"
    for wid in cluster.workers(cluster.decode_component):
        eng = _engine_of(wid)
        obs = eng.obs_snapshot() or {}
        goodput += float(obs.get("total_goodput_tokens", 0.0))
        steps += float(obs.get("total_steps", 0.0))
        stalls += float(obs.get("stalls_total", 0.0))
        st = eng.scheduler.stats
        base = prefix_base.get(wid, (0, 0))
        hits += st.prefix_cache_hits - base[0]
        queries += st.prefix_cache_queries - base[1]
        px = getattr(eng, "prefix", None)
        if px is not None:
            ib = index_base.get(wid, (0, 0))
            index_hit_tokens += px.index.hit_tokens_total - ib[0]
            index_queries += px.index.queries_total - ib[1]
        rt = cluster._workers[wid].runtime
        store_recoveries += float(rt.store.num_recoveries)
        store_call_errors += float(getattr(rt.store, "num_call_errors", 0))
        chips += 1
        platform = eng.device.type
        if platform == "cuda":
            import torch

            device_kind = torch.cuda.get_device_name(eng.device)
    store_recoveries += float(front.store.num_recoveries)
    store_call_errors += float(getattr(front.store, "num_call_errors", 0))

    spans = [s.to_dict()
             for group in mem.by_trace().values() for s in group]
    get_tracer().remove_exporter(mem)

    # observability evidence the fault-attribution cross-check reconciles
    # the plan's firing log against (chaos the stack cannot see is a bug)
    attempt_spans = sum(
        1 for s in spans if s.get("name") == "migration.attempt")
    evidence = {
        "migration_attempts": float(attempt_spans),
        # the sink's own re-issue counter, not span-surplus arithmetic: a
        # timed-out request's cancelled attempt span never exports, which
        # would silently eat the surplus a real repair retry produced
        "migration_retries": float(mig.num_retries),
        "breaker_trips": float(sum(
            b.num_trips for b in breakers._breakers.values())),
        "store_recoveries": store_recoveries,
        "store_call_errors": store_call_errors,
        "engine_stalls": stalls,
        "preempt_notices": float(preempt_counts["notices"]),
        "preempt_fallbacks": float(preempt_counts["fallbacks"]),
        "preempt_spilled": float(preempt_counts["spilled"]),
        "preempt_evacuated": float(preempt_counts["evacuated_peer"]),
        "disagg_fallbacks": 0.0,  # no disagg pair in this deployment
    }

    await router.stop()
    await client.stop()
    await front.shutdown()
    await cluster.shutdown()
    await stores["live"].stop()

    return ReplayRunResult(
        outcomes=outcomes,
        elapsed_s=elapsed,
        time_scale=settings.time_scale,
        events_fired=events_fired,
        recorder_goodput_tokens=goodput,
        recorder_steps=steps,
        prefix_hits_blocks=hits,
        prefix_queries_blocks=queries,
        block_size=settings.block_size,
        chips=chips,
        device_kind=device_kind,
        platform=platform,
        spans=spans,
        preempt=preempt_counts,
        num_kills=cluster.num_kills,
        seed=trace.seed,
        faults_fired=plan.fired_counts(),
        fault_log=[{"site": e.site, "key": e.key, "kind": e.kind,
                    "wave": e.wave} for e in plan.log],
        evidence=evidence,
        prefix_index_hit_tokens=float(index_hit_tokens),
        prefix_index_queries=float(index_queries),
        model=settings.model,
    )


# ------------------------------ HTTP target ------------------------------


@dataclass
class HttpReplayResult:
    """Client-side outcomes of a live-deployment replay plus the chaos
    bookkeeping harvested from the deployment's ``/debug/faults`` admin
    endpoints (the live twin of ``ReplayRunResult.faults_fired``)."""

    outcomes: List[RequestOutcome]
    elapsed_s: float
    time_scale: float
    events_fired: List[dict]
    faults_fired: Dict[str, int] = field(default_factory=dict)
    fault_log: List[dict] = field(default_factory=list)
    seed: int = 0


# sites that execute in the frontend process (its transport dials workers,
# its StoreClient talks discovery) — every other site lives worker-side
_FRONTEND_SITE_PREFIXES = ("client.",)


async def _drive_one_http(
    client: HttpClient, model: str, req: TraceRequest,
    outcome: RequestOutcome, loop: asyncio.AbstractEventLoop,
    resume_limit: int, timeout_s: float,
) -> None:
    """HTTP twin of :func:`_drive_one`: stream one ``/v1/completions``
    request, honouring abort/reconnect behaviour and re-issuing when the
    stream finishes early. The OpenAI layer maps engine ``evacuated`` /
    ``cancelled`` reasons to ``stop``; with ``ignore_eos`` a ``stop``
    before the budget is spent can only mean an engine-side early finish,
    so the driver re-issues with the remaining budget (token ids are not
    recoverable from SSE text, so the re-issue repeats the original
    prompt). Token counts come from the final chunk's ``usage``."""
    budget = req.osl
    total = 0
    abort_at = req.abort_after_tokens
    reconnect_at = req.reconnect_after_tokens
    t0 = loop.time()
    prev: Optional[float] = None
    try:
        for _submission in range(resume_limit + 1):
            body = {"model": model, "prompt": req.token_ids,
                    "max_tokens": budget, "ignore_eos": True,
                    "stream": True}
            reason: Optional[str] = None
            chunks = 0
            usage_tokens: Optional[int] = None
            dropped = False
            status: List[int] = []
            lines = client.stream_lines(
                "POST", "/v1/completions", body=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
                status_out=status)
            try:
                async with asyncio.timeout(timeout_s):
                    async for raw in lines:
                        line = raw.decode().strip()
                        if (not line.startswith("data: ")
                                or line == "data: [DONE]"):
                            continue
                        payload = json.loads(line[6:])
                        choice = payload["choices"][0]
                        now = loop.time()
                        if choice.get("text"):
                            chunks += 1
                            if outcome.ttft_s is None:
                                outcome.ttft_s = now - t0
                            elif prev is not None and now > prev:
                                outcome.itls.append(now - prev)
                            prev = now
                        usage = payload.get("usage")
                        if usage:
                            usage_tokens = int(
                                usage.get("completion_tokens", chunks))
                        if choice.get("finish_reason"):
                            reason = choice["finish_reason"]
                            break
                        n_total = total + chunks
                        if abort_at is not None and n_total >= abort_at:
                            outcome.aborted = True
                            break
                        if (reconnect_at is not None
                                and n_total >= reconnect_at):
                            reconnect_at = None
                            outcome.reconnects += 1
                            dropped = True
                            break
            finally:
                await lines.aclose()
            if status and status[0] != 200:
                outcome.error = f"http {status[0]}"
                break
            sub_tokens = usage_tokens if usage_tokens is not None else chunks
            outcome.submissions.append((len(req.token_ids), sub_tokens))
            total += sub_tokens
            if outcome.error is not None:
                break
            if outcome.aborted:
                outcome.finish_reason = "aborted"
                break
            if reason == "length":
                outcome.finish_reason = "length"
                break
            if reason == "stop" or dropped:
                if reason == "stop":
                    outcome.resumes += 1
                budget = req.osl - total
                if budget <= 0:
                    outcome.finish_reason = "length"
                    break
                continue
            if reason is not None:
                outcome.finish_reason = reason
                break
            outcome.error = "stream ended without finish frame"
            break
        else:
            outcome.error = "resume limit exhausted"
    except Exception as exc:  # noqa: BLE001 — per-request isolation
        outcome.error = f"{type(exc).__name__}: {exc}"
    outcome.tokens = list(range(total))  # count only over HTTP
    outcome.end_s = loop.time() - t0


async def run_http_replay(
    trace: ReplayTrace, url: str, model: str = "mock",
    time_scale: float = 1.0, timeout_s: float = 300.0,
    resume_limit: int = 4,
    worker_admin_urls: Optional[List[str]] = None,
    frontend_admin_url: Optional[str] = None,
) -> HttpReplayResult:
    """Replay against a live HTTP frontend with streaming SSE measurement.

    With admin URLs (each process's system server base URL), the full
    event track runs against the live deployment: ``fault`` events ship
    each wave's rules over ``POST /debug/faults`` — ``client.*`` sites to
    the frontend, worker-scoped sites to the worker addressed by the
    event's seeded ``worker_index`` (the same ``index % n_workers``
    arithmetic the SimCluster driver uses, so both modes pick identical
    victims) — ``fault_clear`` retires a wave everywhere, and ``preempt``
    POSTs the addressed worker's ``/preempt``. ``kill_worker`` and
    ``store_flap`` need process control the HTTP driver does not have and
    are recorded as skipped.

    Fault firings are harvested from every admin endpoint (last-known
    snapshot survives a worker that drains away after its preemption);
    the span/recorder halves of the scoreboard cross-check still come
    from the deployment's own exporters."""
    scale = max(time_scale, 1e-6)
    loop = asyncio.get_running_loop()
    worker_admin_urls = [u.rstrip("/") for u in (worker_admin_urls or [])]
    frontend_admin_url = (frontend_admin_url.rstrip("/")
                          if frontend_admin_url else None)
    admins: List[str] = list(worker_admin_urls)
    if frontend_admin_url:
        admins.append(frontend_admin_url)
    # last successful /debug/faults snapshot per admin endpoint
    admin_state: Dict[str, dict] = {}
    events_fired: List[dict] = []

    outcomes: List[RequestOutcome] = []
    for r in trace.requests:
        outcomes.append(RequestOutcome(
            request_id=r.request_id, tenant=r.tenant, pool=r.pool,
            tier=r.tier, isl=r.isl, osl=r.osl, arrival_s=r.arrival_s,
        ))

    t0 = loop.time()
    clients: Dict[str, HttpClient] = {}

    def _client(base: str) -> HttpClient:
        if base not in clients:
            clients[base] = HttpClient(base, timeout_s=5.0)
        return clients[base]

    front = HttpClient(url.rstrip("/"))
    try:
        async def _harvest_admin(target: str) -> bool:
            try:
                d = (await _client(target).request(
                    "GET", "/debug/faults")).json() or {}
            except Exception:
                return False
            if d.get("installed"):
                admin_state[target] = d
            return True

        async def _events() -> None:
            for ev in trace.events:
                delay = t0 + ev.at_s / scale - loop.time()
                if delay > 0:
                    await asyncio.sleep(delay)
                fired: dict = {"kind": ev.kind, "at_s": ev.at_s}
                widx = int(ev.params.get("worker_index", 0))
                if ev.kind == "fault" and admins:
                    wave = str(ev.params.get("wave", ""))
                    by_target: Dict[str, list] = {}
                    for rd in ev.params.get("rules", []):
                        site = str(rd.get("site", ""))
                        if (site.startswith(_FRONTEND_SITE_PREFIXES)
                                and frontend_admin_url):
                            target = frontend_admin_url
                        elif worker_admin_urls:
                            target = worker_admin_urls[
                                widx % len(worker_admin_urls)]
                        elif frontend_admin_url:
                            target = frontend_admin_url
                        else:
                            continue
                        by_target.setdefault(target, []).append(dict(rd))
                    fired["wave"] = wave
                    fired["installed"] = []
                    for target, rds in by_target.items():
                        body = {"schema": faults.SCHEMA_VERSION,
                                "seed": trace.seed, "draws": 0,
                                "rules": rds}
                        try:
                            resp = await _client(target).request(
                                "POST", "/debug/faults",
                                body=json.dumps(body).encode(),
                                headers={"Content-Type": "application/json"})
                            fired["installed"].append([target, resp.status])
                        except Exception as exc:
                            fired["installed"].append(
                                [target, f"error: {exc}"])
                elif ev.kind == "fault_clear":
                    wave = str(ev.params.get("wave", ""))
                    fired["wave"] = wave
                    for target in admins:
                        await _harvest_admin(target)  # log before retiring
                        try:
                            await _client(target).request(
                                "DELETE", "/debug/faults",
                                params={"wave": wave})
                        except Exception:
                            pass
                elif ev.kind == "preempt" and worker_admin_urls:
                    target = worker_admin_urls[widx % len(worker_admin_urls)]
                    fired["worker"] = target
                    try:
                        resp = await _client(target).request(
                            "POST", "/preempt")
                        fired["status"] = resp.status
                    except Exception as exc:
                        fired["error"] = str(exc)
                    # the worker drains away after evacuating — keep
                    # polling its fault log so the firings survive
                    deadline = loop.time() + 5.0
                    while loop.time() < deadline:
                        if not await _harvest_admin(target):
                            break
                        await asyncio.sleep(0.1)
                else:
                    fired["skipped"] = (
                        f"no process control over {ev.kind!r} in HTTP mode")
                events_fired.append(fired)
                log.info("http replay event fired: %s", fired)

        async def _fire(i: int) -> None:
            r = trace.requests[i]
            delay = t0 + r.arrival_s / scale - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            await _drive_one_http(front, model, r, outcomes[i],
                                  loop, resume_limit, timeout_s)

        events_task = asyncio.create_task(_events())
        await asyncio.gather(*(_fire(i) for i in range(len(trace.requests))))
        await events_task
        elapsed = loop.time() - t0

        # final harvest + cleanup (dead admins keep their last snapshot)
        for target in admins:
            await _harvest_admin(target)
            try:
                await _client(target).request("DELETE", "/debug/faults")
            except Exception:
                pass
    finally:
        for c in [front, *clients.values()]:
            await c.close()

    faults_fired: Dict[str, int] = {}
    fault_log: List[dict] = []
    for target in admins:
        d = admin_state.get(target)
        if not d:
            continue
        for k, v in (d.get("fired_counts") or {}).items():
            faults_fired[k] = faults_fired.get(k, 0) + int(v)
        for e in (d.get("plan") or {}).get("log", []):
            fault_log.append({**e, "admin": target})

    return HttpReplayResult(
        outcomes=outcomes,
        elapsed_s=elapsed,
        time_scale=time_scale,
        events_fired=events_fired,
        faults_fired=faults_fired,
        fault_log=fault_log,
        seed=trace.seed,
    )
