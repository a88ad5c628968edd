"""Standalone metrics aggregator component
(ref: components/metrics/src/main.rs:36 — scrapes worker load metrics,
subscribes KV events, exposes Prometheus).

    python -m dynamo_tpu_torch.metrics_aggregator --component backend \
        --port 9090

Subscribes to a component's ``load_metrics`` and ``kv_events`` subjects and
re-exposes per-worker ForwardPassMetrics as Prometheus gauges plus KV-event
counters (incl. an aggregate prefix-cache hit rate) on a system server.

A copy of ``dynamo_tpu.metrics_aggregator``: feeds are decoded and planner
signals encoded by the port's codec (``runtime/codec.py``), and the
exposition is the port's (``utils/metrics.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import time
from typing import Callable, Dict

from .planner.connector import planner_events_subject
from .router.kv_router import KV_EVENTS_SUBJECT, LOAD_METRICS_SUBJECT
from .runtime import codec
from .runtime.component import DistributedRuntime
from .runtime.signals import install_shutdown_signals
from .runtime.system_server import SystemServer
from .runtime.tasks import spawn_logged
from .utils.config import RuntimeConfig
from .utils.logging import get_logger

log = get_logger("metrics_aggregator")


class MetricsAggregator:
    # a worker that has not published stats for this long is gone (crashed
    # or drained) — its gauges must disappear from the scrape, not freeze
    # at their last values forever
    STALE_AFTER_S = 30.0

    def __init__(
        self,
        runtime: DistributedRuntime,
        component: str,
        *,
        stale_after_s: float = STALE_AFTER_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.runtime = runtime
        self.component = runtime.namespace().component(component)
        self.stale_after_s = stale_after_s
        self._clock = clock  # injectable for deterministic expiry tests
        m = runtime.metrics.child(component=component)
        self._g_usage = m.gauge(
            "worker_kv_usage", "per-worker KV usage", ["worker"]
        )
        self._g_running = m.gauge(
            "worker_requests_running", "running requests", ["worker"]
        )
        self._g_waiting = m.gauge(
            "worker_requests_waiting", "waiting requests", ["worker"]
        )
        self._g_hit_rate = m.gauge(
            "prefix_cache_hit_rate", "aggregate prefix cache hit rate"
        )
        self._g_spec_accept = m.gauge(
            "worker_spec_acceptance_rate",
            "per-worker speculative-draft acceptance rate", ["worker"]
        )
        self._g_spec_rate = m.gauge(
            "spec_acceptance_rate",
            "aggregate speculative-draft acceptance rate"
        )
        # flight-recorder feed ("obs" key of the load-metrics snapshot):
        # per-worker live MFU / goodput / padding waste
        self._g_mfu = m.gauge(
            "worker_mfu", "per-worker live MFU (trailing window)", ["worker"]
        )
        self._g_goodput = m.gauge(
            "worker_goodput_tok_s",
            "per-worker goodput tokens/s (trailing window)", ["worker"]
        )
        self._g_pad_waste = m.gauge(
            "worker_padding_waste_ratio",
            "per-worker fraction of dispatched FLOPs burnt on padding",
            ["worker"]
        )
        # recorder lifetime totals (reset at warmup): the replay scoreboard
        # reconciles client-counted tokens against these
        self._g_goodput_total = m.gauge(
            "worker_goodput_tokens_total",
            "per-worker lifetime goodput tokens since warmup", ["worker"]
        )
        self._g_steps_total = m.gauge(
            "worker_steps_total",
            "per-worker lifetime dispatched device windows since warmup",
            ["worker"]
        )
        # disagg handoff health ("disagg" key of the snapshot): fallbacks,
        # breaker state, transfer retries, orphan reaps
        self._g_dg_fallbacks = m.gauge(
            "disagg_fallback_total",
            "per-worker remote-prefill failures that fell back to local",
            ["worker"]
        )
        self._g_dg_breaker = m.gauge(
            "disagg_breaker_open",
            "1 while the worker's handoff breaker is open "
            "(local-prefill cooldown)", ["worker"]
        )
        self._g_dg_retries = m.gauge(
            "disagg_transfer_retries_total",
            "per-worker KV push retry attempts", ["worker"]
        )
        self._g_dg_orphans = m.gauge(
            "disagg_orphans_reaped_total",
            "per-worker deadline-expired handoff entries reaped", ["worker"]
        )
        # kvbm host-tier health ("kvbm" key of the snapshot): resident
        # bytes and spill pressure of each worker's G2/G3 pools
        self._g_kvbm_bytes = m.gauge(
            "kvbm_host_pool_bytes",
            "per-worker bytes resident in the kvbm host (G2) pool",
            ["worker"]
        )
        self._g_kvbm_spills = m.gauge(
            "kvbm_spills_total",
            "per-worker G2→G3 disk spills", ["worker"]
        )
        self._g_kvbm_onboard_reqs = m.gauge(
            "kvbm_onboard_requests_total",
            "per-worker admissions that onboarded host-tier blocks",
            ["worker"]
        )
        self._g_kvbm_g4_puts = m.gauge(
            "kvbm_g4_puts_total",
            "per-worker write-throughs to the cluster G4 tier", ["worker"]
        )
        self._g_kvbm_g4_hits = m.gauge(
            "kvbm_g4_hits_total",
            "per-worker blocks onboarded from the cluster G4 tier",
            ["worker"]
        )
        self._g_kvbm_peer_hits = m.gauge(
            "kvbm_peer_hits_total",
            "per-worker blocks onboarded from a peer worker's G2 pool",
            ["worker"]
        )
        # global prefix cache (radix index counters ride the same "kvbm"
        # key; zero-defaulted for workers without a prefix cache attached)
        self._g_prefix_nodes = m.gauge(
            "worker_prefix_nodes",
            "per-worker radix prefix index nodes", ["worker"]
        )
        self._g_prefix_hit_tokens = m.gauge(
            "worker_prefix_hit_tokens_total",
            "per-worker prompt tokens served from the prefix cache "
            "(index-verified)", ["worker"]
        )
        self._g_prefix_evictions = m.gauge(
            "worker_prefix_evictions_total",
            "per-worker prefix blocks evicted/demoted out of a tier",
            ["worker"]
        )
        # preemption tolerance ("preempt" key): maintenance notices seen
        # and where the evacuated seats went
        self._g_preempt_notices = m.gauge(
            "worker_preempt_notices",
            "per-worker maintenance notices received", ["worker"]
        )
        self._g_preempt_evacuated = m.gauge(
            "worker_preempt_evacuated_total",
            "per-worker seats evacuated to a peer", ["worker"]
        )
        # chaos visibility ("faults" key): per-worker fault-plan firings so
        # a replay's attribution cross-check can read the live deployment
        self._g_faults_fired = m.gauge(
            "worker_faults_fired_total",
            "per-worker injected-fault firings by site and kind",
            ["worker", "site", "kind"]
        )
        # (site, kind) label sets seen per worker — expire_stale must drop
        # exactly these, and absent sites must re-zero, not freeze
        self._fault_labels: Dict[str, set] = {}
        self._g_wave_recovery = m.gauge(
            "replay_wave_recovery_windows",
            "windows until per-tier SLO compliance returned after a "
            "replayed fault wave (-1 while unrecovered)", ["wave"]
        )
        self._c_events = m.counter(
            "kv_events_total", "KV events seen", ["kind"]
        )
        # planner control-loop visibility: the degradation ladder's current
        # level, the latest scaling targets, and every transition
        self._g_degradation = m.gauge(
            "planner_degradation_level",
            "engaged degradation-ladder steps (0 = none)"
        )
        self._g_targets = m.gauge(
            "planner_target_replicas",
            "latest planner replica target", ["role"]
        )
        self._c_transitions = m.counter(
            "planner_transitions_total",
            "planner control-loop transitions", ["kind", "detail"]
        )
        self.worker_stats: Dict[str, dict] = {}
        self._last_seen: Dict[str, float] = {}
        self._tasks = []

    async def start(self, signals_interval_s: float = 0.0) -> None:
        """Subscribe the metric feeds; ``signals_interval_s`` > 0 also
        publishes the aggregated planner signals (worker queue depth + spec
        acceptance) on ``{ns}/planner_signals`` at that cadence."""
        store = self.runtime.store
        for subject, handler in (
            (self.component.event_subject(LOAD_METRICS_SUBJECT),
             self._on_stats),
            (self.component.event_subject(KV_EVENTS_SUBJECT),
             self._on_kv_event),
            (planner_events_subject(self.component.namespace.name),
             self._on_planner_event),
        ):
            stream = await store.subscribe(subject)
            self._tasks.append(asyncio.create_task(
                self._pump(subject, stream, handler)
            ))
        if signals_interval_s > 0:
            self._tasks.append(asyncio.create_task(
                self._publish_signals(signals_interval_s)
            ))

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()

    async def _pump(self, subject: str, stream, handler) -> None:
        while True:
            event = await stream.next()
            if event is None or event["event"] == "dropped":
                log.warning("subscription %s lost — resubscribing", subject)
                await stream.cancel()
                while True:
                    try:
                        stream = await self.runtime.store.subscribe(subject)
                        break
                    except Exception:
                        await asyncio.sleep(0.5)
                continue
            if event["event"] != "msg":
                continue
            try:
                handler(codec.unpackb(event["value"]))
            except Exception:
                log.exception("bad payload on %s", subject)

    def _on_stats(self, snap: dict) -> None:
        wid = str(snap.get("worker_id", "?"))
        self.worker_stats[wid] = snap
        self._last_seen[wid] = self._clock()
        self._g_usage.labels(worker=wid).set(snap.get("kv_usage", 0.0))
        self._g_running.labels(worker=wid).set(
            snap.get("num_requests_running", 0))
        self._g_waiting.labels(worker=wid).set(
            snap.get("num_requests_waiting", 0))
        # forward-compat: pre-spec workers publish no "spec" field — treat
        # it as all-zero stats rather than choking on the absent key
        spec = snap.get("spec") or {}
        drafted = spec.get("drafted", 0)
        self._g_spec_accept.labels(worker=wid).set(
            spec.get("accepted", 0) / drafted if drafted else 0.0)
        # forward-compat: workers without the flight recorder (older build,
        # DYNTPU_OBS_ENABLED=0, the mocker) publish no "obs" — zero-default
        obs = snap.get("obs") or {}
        self._g_mfu.labels(worker=wid).set(obs.get("mfu", 0.0))
        self._g_goodput.labels(worker=wid).set(obs.get("goodput_tok_s", 0.0))
        self._g_pad_waste.labels(worker=wid).set(
            obs.get("padding_waste_ratio", 0.0))
        self._g_goodput_total.labels(worker=wid).set(
            obs.get("total_goodput_tokens", 0.0))
        self._g_steps_total.labels(worker=wid).set(
            obs.get("total_steps", 0.0))
        # forward-compat: non-disagg workers publish no "disagg" — zero
        dg = snap.get("disagg") or {}
        self._g_dg_fallbacks.labels(worker=wid).set(
            dg.get("fallback_total", 0.0))
        self._g_dg_breaker.labels(worker=wid).set(
            dg.get("breaker_open", 0.0))
        self._g_dg_retries.labels(worker=wid).set(
            dg.get("transfer_retries_total", 0.0))
        self._g_dg_orphans.labels(worker=wid).set(
            dg.get("orphans_reaped_total", 0.0))
        # forward-compat: workers without an attached kvbm publish no
        # "kvbm", pre-preemption workers no "preempt" — zero-default both
        kb = snap.get("kvbm") or {}
        self._g_kvbm_bytes.labels(worker=wid).set(
            kb.get("host_pool_bytes", 0.0))
        self._g_kvbm_spills.labels(worker=wid).set(
            kb.get("spills_total", 0.0))
        self._g_kvbm_onboard_reqs.labels(worker=wid).set(
            kb.get("onboard_requests_total", 0.0))
        self._g_kvbm_g4_puts.labels(worker=wid).set(
            kb.get("g4_puts_total", 0.0))
        self._g_kvbm_g4_hits.labels(worker=wid).set(
            kb.get("g4_hits_total", 0.0))
        self._g_kvbm_peer_hits.labels(worker=wid).set(
            kb.get("peer_hits_total", 0.0))
        self._g_prefix_nodes.labels(worker=wid).set(
            kb.get("prefix_nodes", 0.0))
        self._g_prefix_hit_tokens.labels(worker=wid).set(
            kb.get("prefix_hit_tokens_total", 0.0))
        self._g_prefix_evictions.labels(worker=wid).set(
            kb.get("prefix_evictions_total", 0.0))
        pe = snap.get("preempt") or {}
        self._g_preempt_notices.labels(worker=wid).set(
            pe.get("notices", 0.0))
        self._g_preempt_evacuated.labels(worker=wid).set(
            pe.get("evacuated_total", 0.0))
        # forward-compat: workers without an installed fault plan publish
        # no "faults" — zero-default every label set seen so far rather
        # than freezing stale firings after a plan is cleared
        fired = snap.get("faults") or {}
        labels = self._fault_labels.setdefault(wid, set())
        for key, count in fired.items():
            site, _, kind = key.partition("/")
            labels.add((site, kind))
            self._g_faults_fired.labels(
                worker=wid, site=site, kind=kind).set(count)
        for site, kind in labels:
            if f"{site}/{kind}" not in fired:
                self._g_faults_fired.labels(
                    worker=wid, site=site, kind=kind).set(0.0)
        self.expire_stale()
        self._recompute_hit_rate()
        self._recompute_spec_rate()

    def expire_stale(self) -> None:
        """Drop workers whose stats went silent past ``stale_after_s`` and
        clear their per-worker gauge label sets from the registry."""
        now = self._clock()
        stale = [wid for wid, seen in self._last_seen.items()
                 if now - seen > self.stale_after_s]
        for wid in stale:
            self.worker_stats.pop(wid, None)
            self._last_seen.pop(wid, None)
            for gauge in (self._g_usage, self._g_running, self._g_waiting,
                          self._g_spec_accept, self._g_mfu, self._g_goodput,
                          self._g_goodput_total, self._g_steps_total,
                          self._g_pad_waste, self._g_dg_fallbacks,
                          self._g_dg_breaker, self._g_dg_retries,
                          self._g_dg_orphans, self._g_kvbm_bytes,
                          self._g_kvbm_spills, self._g_kvbm_onboard_reqs,
                          self._g_kvbm_g4_puts, self._g_kvbm_g4_hits,
                          self._g_kvbm_peer_hits, self._g_prefix_nodes,
                          self._g_prefix_hit_tokens,
                          self._g_prefix_evictions,
                          self._g_preempt_notices,
                          self._g_preempt_evacuated):
                gauge.remove(worker=wid)
            for site, kind in self._fault_labels.pop(wid, set()):
                self._g_faults_fired.remove(
                    worker=wid, site=site, kind=kind)
            log.info("expired stale worker %s from the scrape", wid)

    def _recompute_hit_rate(self) -> None:
        hits = sum(s.get("prefix_cache_hits", 0)
                   for s in self.worker_stats.values())
        queries = sum(s.get("prefix_cache_queries", 0)
                      for s in self.worker_stats.values())
        self._g_hit_rate.set(hits / queries if queries else 0.0)

    def _recompute_spec_rate(self) -> None:
        drafted = sum((s.get("spec") or {}).get("drafted", 0)
                      for s in self.worker_stats.values())
        accepted = sum((s.get("spec") or {}).get("accepted", 0)
                       for s in self.worker_stats.values())
        self._g_spec_rate.set(accepted / drafted if drafted else 0.0)

    def _on_kv_event(self, payload: dict) -> None:
        kind = payload.get("event", {}).get("kind", "unknown")
        self._c_events.labels(kind=kind).inc()

    # ---------------------- planner control loop ------------------------

    def _on_planner_event(self, event: dict) -> None:
        kind = event.get("kind", "unknown")
        if kind == "degradation":
            self._g_degradation.set(event.get("level", 0))
            self._c_transitions.labels(
                kind="degradation",
                detail=f"{event.get('direction')}:{event.get('step')}",
            ).inc()
        elif kind == "scale":
            for role in ("prefill", "decode"):
                if role in event:
                    self._g_targets.labels(role=role).set(event[role])
            self._c_transitions.labels(kind="scale", detail="targets").inc()
        elif kind == "preemption":
            # a worker announced a maintenance notice (or the planner
            # echoed one): count it so dashboards line the evacuation up
            # against the scale response
            self._c_transitions.labels(
                kind="preemption",
                detail=str(event.get("worker") or event.get("notices")
                           or "notice"),
            ).inc()
        elif kind == "replay_wave":
            # a chaos replay scored one fault wave: publish its recovery
            # verdict so dashboards overlay it on the worker gauges
            # (-1 = the tiers never got back under SLO in this run)
            windows = event.get("windows_to_recover")
            self._g_wave_recovery.labels(
                wave=str(event.get("wave", "?"))
            ).set(-1.0 if windows is None else float(windows))
            self._c_transitions.labels(
                kind="replay_wave", detail=str(event.get("wave", "?"))
            ).inc()

    def queue_depth(self) -> int:
        """Requests waiting across every live worker (the planner's
        backlog signal)."""
        return int(sum(s.get("num_requests_waiting", 0)
                       for s in self.worker_stats.values()))

    def spec_acceptance(self):
        drafted = sum((s.get("spec") or {}).get("drafted", 0)
                      for s in self.worker_stats.values())
        accepted = sum((s.get("spec") or {}).get("accepted", 0)
                       for s in self.worker_stats.values())
        return accepted / drafted if drafted else None

    def preempt_notices(self) -> int:
        """Maintenance notices across live workers (the planner treats a
        noticed worker as capacity already on its way out)."""
        return int(sum((s.get("preempt") or {}).get("notices", 0)
                       for s in self.worker_stats.values()))

    def _obs_mean(self, key: str):
        """Mean of a flight-recorder field over workers that publish it
        (None when nobody does — signals must distinguish 'no recorder'
        from 'recorder says zero')."""
        vals = [(s.get("obs") or {}).get(key)
                for s in self.worker_stats.values()]
        vals = [v for v in vals if v is not None]
        return sum(vals) / len(vals) if vals else None

    def goodput_tok_s(self):
        """Aggregate goodput across live workers (sum, not mean)."""
        vals = [(s.get("obs") or {}).get("goodput_tok_s")
                for s in self.worker_stats.values()]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    def goodput_tokens_total(self):
        """Summed recorder lifetime goodput tokens across live workers
        (None when no worker publishes a recorder) — the live-deployment
        side of the replay token cross-check."""
        vals = [(s.get("obs") or {}).get("total_goodput_tokens")
                for s in self.worker_stats.values()]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    async def _publish_signals(self, interval_s: float) -> None:
        """The aggregator's side of the planner feed: worker-queue backlog
        and aggregate spec acceptance, published like frontend_stats."""
        subject = f"{self.component.namespace.name}/planner_signals"
        while True:
            await asyncio.sleep(interval_s)
            self.expire_stale()
            payload = {
                "queue_depth": self.queue_depth(),
                "spec_acceptance": self.spec_acceptance(),
                "preempt_notices": self.preempt_notices(),
                "num_workers": len(self.worker_stats),
                # flight-recorder aggregates (None with no recorder-bearing
                # workers): fleet-mean utilization/waste + summed goodput
                "mfu": self._obs_mean("mfu"),
                "padding_waste_ratio": self._obs_mean("padding_waste_ratio"),
                "spec_reject_waste_ratio": self._obs_mean(
                    "spec_reject_waste_ratio"),
                "goodput_tok_s": self.goodput_tok_s(),
            }
            try:
                await self.runtime.store.publish(
                    subject, codec.packb(payload)
                )
            except Exception as exc:
                log.warning("planner signals publish failed: %s", exc)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo-tpu metrics aggregator")
    p.add_argument("--store-addr", default=None)
    p.add_argument("--namespace", default=None)
    p.add_argument("--component", default="backend")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9090)
    p.add_argument(
        "--signals-interval", type=float, default=10.0,
        help="seconds between planner_signals publishes (worker queue "
             "depth + spec acceptance for the SLA planner; 0 disables)",
    )
    return p.parse_args(argv)


async def run(args: argparse.Namespace) -> None:
    config = RuntimeConfig.from_settings()
    if args.store_addr:
        config.store_addr = args.store_addr
    if args.namespace:
        config.namespace = args.namespace
    runtime = await DistributedRuntime.from_settings(config)

    agg = MetricsAggregator(runtime, args.component)
    await agg.start(signals_interval_s=args.signals_interval)
    server = SystemServer(metrics=runtime.metrics, host=args.host,
                          port=args.port)
    await server.start()

    async def _shutdown():
        await agg.stop()
        await server.stop()
        await runtime.shutdown()

    install_shutdown_signals(
        lambda: spawn_logged(_shutdown(), name="aggregator-shutdown"),
        loop=asyncio.get_running_loop(), name="aggregator",
    )
    log.info("metrics aggregator on %s:%d (component=%s)",
             args.host, server.port, args.component)
    await runtime.shutdown_event.wait()


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
