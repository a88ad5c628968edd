"""Simulated P/D cluster for closed-loop planner validation
(ref: the mocker-engine scale harness of components/backends/mocker —
speedup-accelerated engines faithful enough for control-loop dynamics).

Builds a real distributed deployment — store, per-worker
``DistributedRuntime`` + ingress server, KV-aware router, migration — whose
*engines* are simulated: token timing is driven by a small load model
instead of a device. That keeps every control-plane seam real (leases,
discovery, drains, breakers, migration carryover) while letting a hundred
workers and thousands of requests run on one CPU in seconds.

Load model:

- **TTFT** = wait for a slot in a global prefill pool (capacity = live
  prefill workers × slots) + ISL × per-token prefill cost + one decode
  step. Prefill workers are pure capacity: flipping a worker to prefill
  grows the pool, so the planner's prefill targets have real effect.
- **ITL** = per-worker decode step × max(1, active/seats): a decode worker
  running more streams than seats slows all of them, so overload shows up
  exactly where the planner looks (itl p99).
- Degradation orders feed back as cost scales (clamping spec_k /
  tightening chunking cheapens decode steps) and as admission tier
  shedding, so the ladder measurably relieves pressure before scaling.

Engines emit ScriptedWorker-convention tokens (1000 + absolute position)
so migrations and role flips are checked for byte-exact parity.

``SimCluster`` implements the orchestrator's ``WorkerPool`` protocol
(workers/spawn/stop/flip) plus ``kill`` for chaos. ``run_scenario`` closes
the whole loop: drive bursty Poisson/diurnal arrivals with seeded chaos
(worker kills, an optional store flap) against a live planner +
orchestrator and report per-window SLO compliance, recovery time, parity,
and per-tier latency percentiles.

A copy of ``dynamo_tpu.mocker.cluster`` over the port's runtime, router,
Migration, disaggregation, KVBM and preemption. The real-engine harnesses
(:class:`DisaggChaosHarness`, :class:`PreemptionChaosHarness`) build the
port's ``InferenceEngine`` on its default device (the card); their canaries
are torch tensors.
"""

from __future__ import annotations

import asyncio
import math
import random
import socket
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..frontend.service import AdmissionController, AdmissionError, percentile
from ..llm.migration import Migration
from ..planner.connector import VirtualConnector
from ..planner.core import Planner, PlannerConfig, WindowMetrics
from ..planner.degradation import DegradationConfig, DegradationWatcher
from ..planner.interpolation import DecodeInterpolator, PrefillInterpolator
from ..planner.orchestrator import Orchestrator
from ..router.kv_router import KvPushRouter, KvRouter
from ..router.scheduler import KvRouterConfig
from ..runtime.circuit import BreakerConfig, CircuitBreakerRegistry
from ..runtime.component import DistributedRuntime
from ..runtime.context import Context
from ..runtime.engine import AsyncEngine
from ..runtime.store import StoreServer
from ..utils.config import RuntimeConfig
from ..utils.logging import get_logger

log = get_logger("mocker.cluster")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------- load model -------------------------------


@dataclass
class SimTiming:
    """Device-time costs; wall sleeps are divided by ``speedup_ratio``
    (ref: MockerConfig — the same acceleration knob)."""

    prefill_time_per_token_s: float = 10e-3
    decode_time_per_step_s: float = 160e-3
    speedup_ratio: float = 20.0
    prefill_slots_per_worker: int = 1
    decode_seats_per_worker: int = 1

    @property
    def eff_prefill_tpt(self) -> float:
        return self.prefill_time_per_token_s / self.speedup_ratio

    @property
    def eff_step(self) -> float:
        return self.decode_time_per_step_s / self.speedup_ratio

    def interpolators(self) -> Tuple[PrefillInterpolator, DecodeInterpolator]:
        """The profile an SLA profiler would record for these engines —
        ideal (uncongested) latency curves and the throughput/chip envelope
        the planner inverts."""
        step, tpt = self.eff_step, self.eff_prefill_tpt
        slots = self.prefill_slots_per_worker
        isl_grid = [8.0, 64.0, 512.0]
        # profiled TTFT includes the first (uncongested) decode step, like a
        # real profiler's time-to-first-token would
        prefill = PrefillInterpolator(
            isl=isl_grid,
            ttft_s=[isl * tpt + step for isl in isl_grid],
            thpt_per_chip=[slots / tpt] * len(isl_grid),
        )
        # conservative throughput envelope: the planner provisions headroom
        # below the factor-1 saturation rate (1/step tokens/s/worker)
        decode = DecodeInterpolator(
            kv_usage=[0.2, 0.5, 0.9, 0.2, 0.5, 0.9],
            context_length=[16.0, 16.0, 16.0, 512.0, 512.0, 512.0],
            itl_s=[step, step * 1.5, step * 3.0] * 2,
            thpt_per_chip=[0.5 / step, 0.65 / step, 0.8 / step] * 2,
        )
        return prefill, decode


class ResizablePool:
    """Counting pool whose capacity follows the live prefill fleet."""

    def __init__(self, capacity: int):
        self.capacity = max(1, capacity)
        self._in_use = 0
        self._cond = asyncio.Condition()

    @property
    def waiting(self) -> int:
        return len(self._cond._waiters)  # backlog signal for the planner

    async def acquire(self) -> None:
        async with self._cond:
            while self._in_use >= self.capacity:
                await self._cond.wait()
            self._in_use += 1

    async def release(self) -> None:
        async with self._cond:
            self._in_use -= 1
            self._cond.notify_all()

    async def resize(self, capacity: int) -> None:
        async with self._cond:
            self.capacity = max(1, capacity)
            self._cond.notify_all()


class SimWorkerEngine(AsyncEngine):
    """AsyncEngine with load-coupled timing and ScriptedWorker parity
    tokens: position ``j`` of the stream is token ``1000 + prompt_len + j``,
    so migrated/flipped continuations are byte-checkable."""

    def __init__(self, cluster: "SimCluster"):
        self.cluster = cluster
        self.active = 0  # decode streams running on this worker

    async def generate(self, request, context):
        cl = self.cluster
        t = cl.timing
        prompt = list(request["token_ids"])
        start = len(prompt)
        n = int(request.get("max_tokens", 8))
        await cl.prefill_pool.acquire()
        try:
            await asyncio.sleep(start * t.eff_prefill_tpt * cl.prefill_scale)
        finally:
            await cl.prefill_pool.release()
        self.active += 1
        try:
            for i in range(n):
                if context.is_stopped() or context.is_expired():
                    return  # no finished marker: the client migrates
                # the first token is scheduled ahead of the congested batch
                # so TTFT stays a prefill signal and ITL a decode signal
                factor = (1.0 if i == 0 else
                          max(1.0, self.active
                              / max(1, t.decode_seats_per_worker)))
                await asyncio.sleep(t.eff_step * factor * cl.decode_scale)
                if context.is_stopped() or context.is_expired():
                    return
                yield {
                    "token_ids": [1000 + start + i],
                    "finished": i == n - 1,
                    "finish_reason": "length" if i == n - 1 else None,
                    "num_prompt_tokens": start,
                }
        finally:
            self.active -= 1


# ------------------------------- cluster --------------------------------


@dataclass
class SimWorker:
    wid: int
    runtime: DistributedRuntime
    engine: AsyncEngine
    served: object
    component: str


class SimCluster:
    """A live simulated deployment implementing the orchestrator's
    ``WorkerPool``: every worker is a real runtime + ingress server whose
    engine timing comes from the shared load model."""

    def __init__(
        self,
        cfg: RuntimeConfig,
        *,
        namespace: str = "sim",
        prefill_component: str = "prefill",
        decode_component: str = "backend",
        timing: Optional[SimTiming] = None,
        drain_deadline_s: float = 0.15,
        engine_factory: Optional[Callable[[], AsyncEngine]] = None,
    ):
        self.cfg = cfg
        self.namespace = namespace
        self.prefill_component = prefill_component
        self.decode_component = decode_component
        self.timing = timing or SimTiming()
        self.drain_deadline_s = drain_deadline_s
        # when set, spawned workers serve engines from this factory (e.g.
        # real tiny InferenceEngines for the trace-replay scoreboard)
        # instead of the simulated load model
        self.engine_factory = engine_factory
        self.prefill_pool = ResizablePool(1)
        # degradation feedback: cheapened decode steps while clamps hold
        self.decode_scale = 1.0
        self.prefill_scale = 1.0
        self.num_kills = 0
        self._workers: Dict[int, SimWorker] = {}
        self._next_id = 0

    # ------------------------- WorkerPool ---------------------------

    def workers(self, component: str) -> List[int]:
        return sorted(w.wid for w in self._workers.values()
                      if w.component == component)

    def worker_addr(self, worker_id: int) -> str:
        """Advertised ingress address of a live worker — the in-process
        analogue of a live deployment's worker admin URL, so replay code
        can address fault/preempt events at a specific seeded victim."""
        return self._workers[worker_id].served.instance.addr

    async def spawn(self, component: str) -> int:
        rt = await DistributedRuntime.from_settings(self.cfg)
        engine = (self.engine_factory() if self.engine_factory is not None
                  else SimWorkerEngine(self))
        ep = (rt.namespace(self.namespace).component(component)
              .endpoint("generate"))
        served = await ep.serve_endpoint(engine, advertise_host="127.0.0.1")
        wid = self._next_id
        self._next_id += 1
        self._workers[wid] = SimWorker(wid, rt, engine, served, component)
        await self._resize_prefill()
        return wid

    async def stop(self, worker_id: int) -> None:
        sw = self._workers.pop(worker_id)
        await sw.served.drain_and_stop(deadline_s=self.drain_deadline_s)
        await sw.runtime.shutdown()
        await self._stop_engine(sw.engine)
        await self._resize_prefill()

    async def flip(self, worker_id: int, component: str) -> None:
        sw = self._workers[worker_id]
        if sw.component == component:
            return
        # drain off the old role: in-flight joins within the deadline,
        # stragglers are stopped so Migration carries them to a peer
        await sw.served.drain_and_stop(deadline_s=self.drain_deadline_s)
        sw.served.server.draining = False
        ep = (sw.runtime.namespace(self.namespace).component(component)
              .endpoint("generate"))
        sw.served = await ep.serve_endpoint(sw.engine,
                                            advertise_host="127.0.0.1")
        sw.component = component
        await self._resize_prefill()

    # --------------------------- chaos ------------------------------

    async def kill(self, worker_id: int) -> None:
        """Abrupt crash: in-flight streams are cut mid-frame (clients see a
        retryable failure and migrate); the lease revocation deregisters."""
        sw = self._workers.pop(worker_id)
        self.num_kills += 1
        try:
            await sw.served.server.stop()
        except Exception:
            pass
        try:
            await sw.runtime.shutdown()
        except Exception:
            pass
        await self._stop_engine(sw.engine)
        await self._resize_prefill()

    # ------------------------- lifecycle ----------------------------

    async def start(self, n_prefill: int, n_decode: int,
                    batch: int = 16) -> None:
        todo = ([self.prefill_component] * n_prefill
                + [self.decode_component] * n_decode)
        for i in range(0, len(todo), batch):
            await asyncio.gather(*(self.spawn(c) for c in todo[i:i + batch]))

    async def shutdown(self) -> None:
        for sw in list(self._workers.values()):
            try:
                await sw.served.server.stop()
            except Exception:
                pass
            try:
                await sw.runtime.shutdown()
            except Exception:
                pass
            await self._stop_engine(sw.engine)
        self._workers.clear()

    @staticmethod
    async def _stop_engine(engine: AsyncEngine) -> None:
        """Real engines (factory-built) own a decode loop that must stop
        with the worker; the simulated engine has no lifecycle."""
        stop = getattr(engine, "stop", None)
        if stop is None:
            return
        try:
            await stop()
        except Exception:
            pass

    async def _resize_prefill(self) -> None:
        n = len(self.workers(self.prefill_component))
        await self.prefill_pool.resize(
            n * self.timing.prefill_slots_per_worker)

    def apply_degradation(self, actions: dict) -> None:
        """The worker-side effect of the ladder's orders: clamped spec_k
        stops draft-verify amplification, tightened chunking stops long
        prefills stalling decodes — both cheapen decode steps."""
        scale = 1.0
        if actions.get("spec_k_max") is not None:
            scale *= 0.85
        if actions.get("prefill_chunk_tokens_max") is not None:
            scale *= 0.90
        self.decode_scale = scale


# ------------------------------ scenarios -------------------------------


@dataclass
class SimScenario:
    """One closed-loop run: phases (warmup → burst+chaos → cooldown) at
    ``window_s`` planner cadence. All randomness flows from ``seed``."""

    seed: int = 0
    n_prefill: int = 6
    n_decode: int = 10
    timing: SimTiming = field(default_factory=SimTiming)
    isl: int = 32
    osl: int = 8
    base_rps: float = 25.0
    burst_factor: float = 4.0
    diurnal_amplitude: float = 0.15
    diurnal_period_s: float = 4.0
    warmup_s: float = 1.0
    burst_s: float = 2.5
    cooldown_s: float = 2.0
    window_s: float = 0.5
    ttft_sla_s: float = 0.15
    itl_sla_s: float = 0.02
    kill_fraction: float = 0.1
    store_flap_s: float = 0.0  # >0: stop/restart the store mid-burst
    max_chip_budget: int = 32
    min_endpoint: int = 3
    migration_limit: int = 8
    max_concurrency: int = 4096
    max_queue: int = 4096
    tier_weights: Tuple[float, float, float] = (0.3, 0.4, 0.3)
    spec_acceptance: float = 0.62  # synthetic aggregator signal
    attach_aggregator: bool = True
    engage_ratio: float = 1.5  # ladder engagement pressure threshold

    @property
    def duration_s(self) -> float:
        return self.warmup_s + self.burst_s + self.cooldown_s

    def rate(self, t: float) -> float:
        burst = (self.burst_factor
                 if self.warmup_s <= t < self.warmup_s + self.burst_s
                 else 1.0)
        diurnal = 1.0 + self.diurnal_amplitude * math.sin(
            2 * math.pi * t / self.diurnal_period_s)
        return self.base_rps * burst * diurnal


def flagship_scenario(seed: int = 0) -> SimScenario:
    """The 100+ worker configuration (slow; scripts/verify.sh planner).

    Workers are slow enough (eff. 200 ms/step) that ~70 decode replicas are
    genuinely needed at the 45 rps baseline, yet the whole cluster and a 4x
    burst still fit one event loop. The burst's raw demand exceeds the chip
    budget — only degradation (tier shed + clamps) plus scale-to-budget can
    restore the SLO, which is exactly the control story under test."""
    return SimScenario(
        seed=seed,
        n_prefill=32,
        n_decode=72,
        timing=SimTiming(prefill_time_per_token_s=20e-3,
                         decode_time_per_step_s=4.0,
                         speedup_ratio=20.0),
        isl=48,
        osl=6,
        base_rps=45.0,
        warmup_s=2.0,
        burst_s=4.0,
        cooldown_s=4.0,
        window_s=1.0,
        ttft_sla_s=0.6,
        itl_sla_s=0.45,
        store_flap_s=0.4,
        max_chip_budget=150,
        min_endpoint=6,
        max_concurrency=220,
        max_queue=300,
        # the big fleet's overload plateaus nearer the SLA line than the
        # compact scenario's — engage the ladder on a smaller overshoot
        engage_ratio=1.3,
    )


def arrival_times(rng: random.Random, scenario: SimScenario) -> List[float]:
    """Non-homogeneous Poisson arrivals over the scenario's rate curve."""
    out, t = [], 0.0
    while t < scenario.duration_s:
        t += rng.expovariate(max(scenario.rate(t), 1e-6))
        if t < scenario.duration_s:
            out.append(t)
    return out


class _Recorder:
    """Per-window latency reservoirs + run-level per-tier accumulation."""

    RESERVOIR = 4096

    def __init__(self, seed: int):
        self._rng = random.Random(seed)
        self.num_arrived = 0
        self.num_shed = 0
        self.ttft: List[float] = []
        self.itl: List[float] = []
        self.tiers: Dict[int, Dict[str, list]] = {}
        self.request_slo: List[bool] = []  # per-request violation flags

    def _sample(self, samples: list, v: float) -> None:
        if len(samples) < self.RESERVOIR:
            samples.append(v)
        else:
            samples[self._rng.randrange(self.RESERVOIR)] = v

    def record(self, tier: int, ttft_s: float, itls: List[float],
               violated: bool) -> None:
        self._sample(self.ttft, ttft_s)
        for v in itls:
            self._sample(self.itl, v)
        bucket = self.tiers.setdefault(tier, {"ttft": [], "itl": []})
        self._sample(bucket["ttft"], ttft_s)
        for v in itls:
            self._sample(bucket["itl"], v)
        self.request_slo.append(violated)

    def drain_window(self) -> dict:
        win = {
            "num_arrived": self.num_arrived,
            "num_shed": self.num_shed,
            "num_completed": len(self.ttft),
            "ttft_p50_s": percentile(self.ttft, 0.50),
            "ttft_p99_s": percentile(self.ttft, 0.99),
            "itl_p50_s": percentile(self.itl, 0.50),
            "itl_p99_s": percentile(self.itl, 0.99),
        }
        self.num_arrived = 0
        self.num_shed = 0
        self.ttft = []
        self.itl = []
        return win

    def tier_summary(self) -> dict:
        return {
            str(tier): {
                "count": len(b["ttft"]),
                "ttft_p50_s": percentile(b["ttft"], 0.50),
                "ttft_p99_s": percentile(b["ttft"], 0.99),
                "itl_p50_s": percentile(b["itl"], 0.50),
                "itl_p99_s": percentile(b["itl"], 0.99),
            }
            for tier, b in sorted(self.tiers.items())
        }


async def run_scenario(sc: SimScenario, workdir: str) -> dict:
    """Drive the scenario end-to-end with zero manual intervention and
    return the trajectory report. ``workdir`` holds the store snapshot
    (needed for the mid-burst store flap)."""
    rng = random.Random(sc.seed)
    port = _free_port()
    snap = f"{workdir}/sim-store.snap"
    stores = {"live": StoreServer("127.0.0.1", port, persist_path=snap)}
    await stores["live"].start()
    cfg = RuntimeConfig(
        store_addr=f"127.0.0.1:{port}",
        namespace="sim",
        store_reconnect_base_s=0.05,
        store_reconnect_cap_s=0.2,
        store_recover_timeout_s=15.0,
        store_reconcile_grace_s=0.5,
    )
    cluster = SimCluster(cfg, namespace="sim", timing=sc.timing)
    await cluster.start(sc.n_prefill, sc.n_decode)

    front = await DistributedRuntime.from_settings(cfg)
    client = await (front.namespace("sim")
                    .component(cluster.decode_component)
                    .endpoint("generate").client())
    await client.wait_for_instances(sc.n_decode, timeout_s=20.0)
    breakers = CircuitBreakerRegistry(
        BreakerConfig(failure_threshold=3, open_timeout_s=1.0))
    router = KvRouter(
        client, client.endpoint.component,
        block_size=16, use_events=False, seed=0,
        config=KvRouterConfig(replica_sync=False, snapshot_threshold=0),
        breakers=breakers,
    )
    mig = Migration(KvPushRouter(router), migration_limit=sc.migration_limit,
                    backoff_base_s=0.01, rng=random.Random(sc.seed))

    admission = AdmissionController(sc.max_concurrency,
                                    max_queue=sc.max_queue)
    prefill_interp, decode_interp = sc.timing.interpolators()
    connector = VirtualConnector(front.store, namespace="sim")
    planner = Planner(
        PlannerConfig(
            ttft_sla_s=sc.ttft_sla_s,
            itl_sla_s=sc.itl_sla_s,
            adjustment_interval_s=sc.window_s,
            min_endpoint=sc.min_endpoint,
            max_chip_budget=sc.max_chip_budget,
            predictor_order=2,
            degradation=DegradationConfig(engage_ratio=sc.engage_ratio),
        ),
        prefill_interp, decode_interp, connector,
        prefill_component=cluster.prefill_component,
        decode_component=cluster.decode_component,
    )
    orchestrator = Orchestrator(
        front.store, cluster, namespace="sim",
        prefill_component=cluster.prefill_component,
        decode_component=cluster.decode_component,
        max_chip_budget=sc.max_chip_budget,
    )

    def _apply_degradation(actions: dict) -> None:
        admission.min_tier = actions.get("min_tier") or 0
        cluster.apply_degradation(actions)

    watcher = DegradationWatcher(front.store, "sim", _apply_degradation)

    aggregator = None
    if sc.attach_aggregator:
        from ..metrics_aggregator import MetricsAggregator

        aggregator = MetricsAggregator(front, cluster.decode_component)
        await aggregator.start()

    recorder = _Recorder(sc.seed)
    report: dict = {
        "seed": sc.seed, "windows": [], "dropped": [],
        "parity_failures": [], "chaos_window": None,
    }
    expected = [1000 + sc.isl + j for j in range(sc.osl)]
    loop = asyncio.get_running_loop()

    async def _one_request(i: int) -> None:
        tier = rng.choices((0, 1, 2), weights=sc.tier_weights)[0]
        # arrivals (not post-queue admissions) are the demand signal the
        # planner provisions for — a saturated queue must not hide load
        recorder.num_arrived += 1
        try:
            await admission.acquire(tier=tier)
        except AdmissionError:
            recorder.num_shed += 1
            return
        try:
            prompt = [((i * 7 + j) % 500) + 2 for j in range(sc.isl)]
            req = {"token_ids": prompt, "max_tokens": sc.osl}
            t0 = loop.time()
            first = prev = None
            itls: List[float] = []
            toks: List[int] = []
            frames = []
            async for frame in mig.generate(req,
                                            Context(request_id=f"sim-{i}")):
                now = loop.time()
                if first is None:
                    first = now - t0
                else:
                    itls.append(now - prev)
                prev = now
                toks.extend(frame["token_ids"])
                frames.append(frame)
            if (toks != expected or not frames
                    or not frames[-1].get("finished")
                    or any(f["num_prompt_tokens"] != sc.isl for f in frames)):
                recorder.request_slo.append(True)
                report["parity_failures"].append(
                    {"request": i, "tokens": toks})
                return
            mean_itl = sum(itls) / len(itls) if itls else 0.0
            violated = first > sc.ttft_sla_s or mean_itl > sc.itl_sla_s
            recorder.record(tier, first, itls, violated)
        except Exception as exc:
            report["dropped"].append({"request": i, "error": repr(exc)})
        finally:
            admission.release()

    async def _load() -> None:
        t0 = loop.time()
        tasks = []
        for i, at in enumerate(arrival_times(random.Random(sc.seed + 1), sc)):
            delay = t0 + at - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            tasks.append(asyncio.create_task(_one_request(i)))
        await asyncio.gather(*tasks)

    async def _chaos() -> None:
        # kills land just after the burst begins
        await asyncio.sleep(sc.warmup_s + sc.window_s / 2)
        decode = cluster.workers(cluster.decode_component)
        n_kill = max(1, math.ceil(sc.kill_fraction * len(decode)))
        victims = random.Random(sc.seed + 2).sample(decode, n_kill)
        report["chaos_window"] = len(report["windows"])
        report["killed"] = victims
        for wid in victims:
            await cluster.kill(wid)
        if sc.store_flap_s > 0:
            await asyncio.sleep(sc.window_s)
            await stores["live"].stop()
            await asyncio.sleep(sc.store_flap_s)
            stores["live"] = StoreServer("127.0.0.1", port,
                                         persist_path=snap)
            await stores["live"].start()

    load_task = asyncio.create_task(_load())
    chaos_task = asyncio.create_task(_chaos())

    # ------------- the control loop under test (no human in it) ----------
    n_windows = int(math.ceil(sc.duration_s / sc.window_s)) + 2
    for _w in range(n_windows):
        await asyncio.sleep(sc.window_s)
        win = recorder.drain_window()
        metrics = WindowMetrics(
            num_requests=win["num_arrived"],
            isl_avg=sc.isl, osl_avg=sc.osl,
            ttft_p50_s=win["ttft_p50_s"], ttft_p99_s=win["ttft_p99_s"],
            itl_p50_s=win["itl_p50_s"], itl_p99_s=win["itl_p99_s"],
            ttft_avg_s=win["ttft_p50_s"], itl_avg_s=win["itl_p50_s"],
            # prefill-attributable backlog only: the admission queue is
            # decode pressure and already shows in the ITL correction
            queue_depth=cluster.prefill_pool.waiting,
            breaker_open=sum(1 for s in breakers.states().values()
                             if s != "closed"),
            spec_acceptance=sc.spec_acceptance,
        )
        planner.observe(metrics)
        try:
            await planner.make_adjustments()
            await watcher.poll_once()
            await orchestrator.reconcile()
        except Exception as exc:  # store flap: stale orders, next window wins
            log.warning("control window degraded to staleness: %s", exc)
        win.update({
            "compliant": (
                win["num_completed"] > 0
                and win["ttft_p99_s"] <= sc.ttft_sla_s
                and win["itl_p99_s"] <= sc.itl_sla_s
            ),
            "degradation_level": planner.ladder.level,
            "targets": planner.last_targets,
            "live_prefill": len(cluster.workers(cluster.prefill_component)),
            "live_decode": len(cluster.workers(cluster.decode_component)),
            "breaker_open": metrics.breaker_open,
        })
        report["windows"].append(win)

    await asyncio.wait_for(load_task, timeout=60.0)
    await chaos_task
    if aggregator is not None:
        await asyncio.sleep(0.2)  # let the last planner events land
        report["metrics_text"] = front.metrics.render().decode()
        await aggregator.stop()

    # ------------------------------ report -------------------------------
    # recovery is counted from the first *visible* SLO breach at/after the
    # chaos window (the kill lands mid-window, so the window it falls in may
    # still close compliant) to the first compliant window after it; idle
    # tail windows carry no signal and cannot open a breach
    cw = report["chaos_window"]
    recovery = None
    if cw is not None:
        wins = report["windows"]
        breach = next(
            (i for i in range(cw, len(wins))
             if (wins[i]["num_arrived"] or wins[i]["num_completed"])
             and not wins[i]["compliant"]),
            None,
        )
        if breach is None:
            recovery = 0
        else:
            for idx in range(breach, len(wins)):
                if wins[idx]["compliant"]:
                    recovery = idx - breach
                    break
    report.update({
        "recovery_windows": recovery,
        "num_requests": len(recorder.request_slo),
        "num_shed_total": admission.num_shed,
        "slo_violation_rate": (
            sum(recorder.request_slo) / len(recorder.request_slo)
            if recorder.request_slo else None),
        "tiers": recorder.tier_summary(),
        "degradation_transitions": list(planner.ladder.transitions),
        "degradation_max_level": max(
            (w["degradation_level"] for w in report["windows"]), default=0),
        "orchestrator": {
            "flips": orchestrator.stats.num_flips,
            "spawns": orchestrator.stats.num_spawns,
            "stops": orchestrator.stats.num_stops,
        },
        "num_kills": cluster.num_kills,
    })

    await router.stop()
    await client.stop()
    await front.shutdown()
    await cluster.shutdown()
    await stores["live"].stop()
    return report


# ----------------------- disagg chaos harness ---------------------------
# Real tiny InferenceEngines wired exactly like a disaggregated
# P/D worker pair — real kv_inject TCP ingress, real store work queue in
# queue mode — driven through a seeded FaultPlan storm. The invariants it
# certifies are the ones ROADMAP item 3 leans on: byte parity with the
# local-prefill path, zero KV corruption (poisoned-block canary), and zero
# leaked blocks/reservations after the storm.


@dataclass
class DisaggChaosScenario:
    """One seeded disagg chaos run. ``plan_fn(plan)`` installs the fault
    rules; structural events (prefill-worker kill) are fields."""

    name: str
    seed: int = 0
    num_requests: int = 6
    concurrency: int = 2
    use_queue: bool = False
    # hide the device plane from the prefill side → every transfer rides
    # the integrity-checked host relay
    relay_only: bool = False
    prompt_len: Tuple[int, int] = (24, 40)
    max_tokens: int = 6
    queue_wait_s: float = 4.0
    handoff_timeout_s: float = 10.0
    inject_timeout_s: float = 2.0
    transfer_max_retries: int = 3
    retry_backoff_base_s: float = 0.02
    inflight_grace_s: float = 4.0
    min_remote_prefill_tokens: int = 8
    breaker_failure_threshold: int = 100  # storms shouldn't trip by default
    plan_fn: Optional[object] = None      # Callable[[FaultPlan], None]
    # queue mode: hard-kill the queue worker once it pulled this many
    # items (mid-transfer when combined with a disagg.transfer delay)
    kill_prefill_after_pulls: Optional[int] = None
    revive_prefill: bool = True


class _InlinePrefillClient:
    """Push-mode stand-in for the component Client: routes straight to the
    in-process PrefillHandler (transport ingress is still real for the KV
    inject leg, which is the leg the faults target)."""

    def __init__(self, handler):
        self.handler = handler

    def instance_ids(self):
        return [1]

    def round_robin(self, request, context):
        return self.handler.generate(request, Context())


class DisaggChaosHarness:
    """Builds the P/D pair, plants the canary, runs the storm, accounts
    for every block. Use :func:`run_disagg_scenario` for the one-shot
    form."""

    def __init__(self, sc: DisaggChaosScenario):
        self.sc = sc
        self._canary_seq = None
        self._canary_pattern = None
        self._free_baseline: Dict[str, int] = {}

    async def start(self) -> None:
        from ..disagg.handlers import (
            DecodeHandler, DisaggConfig, PrefillHandler, PrefillQueueWorker,
        )
        from ..disagg.ici import DevicePlane
        from ..engine.config import EngineConfig, ModelConfig
        from ..engine.engine import InferenceEngine
        from ..runtime.store import StoreClient
        from ..runtime.transport import IngressServer

        sc = self.sc
        model_cfg = ModelConfig.tiny(vocab_size=256)
        eng_cfg = EngineConfig(
            num_blocks=64, block_size=4, max_model_len=128,
            max_num_batched_tokens=128, prefill_buckets=(128,),
            decode_buckets=(4,), max_num_seqs=4,
        )
        # identical init seeds: the remote-prefill path, the local-fallback
        # path, and the serial reference must all be greedy-identical
        self.prefill_engine = InferenceEngine(model_cfg, eng_cfg, seed=0)
        self.decode_engine = InferenceEngine(model_cfg, eng_cfg, seed=0)
        self.reference_engine = InferenceEngine(model_cfg, eng_cfg, seed=0)

        plane = DevicePlane()
        self.config = DisaggConfig(
            min_remote_prefill_tokens=sc.min_remote_prefill_tokens,
            use_queue=sc.use_queue, queue_name=f"chaos_q_{sc.seed}",
            queue_wait_s=sc.queue_wait_s,
            handoff_timeout_s=sc.handoff_timeout_s,
            inflight_grace_s=sc.inflight_grace_s,
            inject_timeout_s=sc.inject_timeout_s,
            transfer_max_retries=sc.transfer_max_retries,
            retry_backoff_base_s=sc.retry_backoff_base_s,
            breaker_failure_threshold=sc.breaker_failure_threshold,
            orphan_sweep_interval_s=0.5, orphan_grace_s=0.5,
        )
        self.prefill_handler = PrefillHandler(
            self.prefill_engine,
            plane=DevicePlane() if sc.relay_only else plane,
            config=self.config,
        )
        self.store_server = None
        self.queue_worker = None
        self._stores = []
        if sc.use_queue:
            self.store_server = StoreServer(host="127.0.0.1", port=0)
            await self.store_server.start()
            addr = f"127.0.0.1:{self.store_server.port}"
            prefill_store = await StoreClient.connect(addr)
            decode_store = await StoreClient.connect(addr)
            self._stores = [prefill_store, decode_store]
            self.queue_worker = PrefillQueueWorker(
                self.prefill_handler, prefill_store,
                queue_name=self.config.queue_name,
            )
            self.queue_worker.start()
            prefill_client = None
            store = decode_store
        else:
            prefill_client = _InlinePrefillClient(self.prefill_handler)
            store = None
        self.decode_handler = DecodeHandler(
            self.decode_engine, prefill_client=prefill_client,
            config=self.config, plane=plane, store=store,
        )
        self.inject_server = IngressServer(
            self.decode_handler.inject_handler(), host="127.0.0.1", port=0
        )
        await self.inject_server.start()
        self.decode_handler.kv_inject_addr = (
            f"127.0.0.1:{self.inject_server.port}"
        )
        await self._plant_canary()
        self._free_baseline = {
            "prefill": self.prefill_engine.scheduler.pool.num_free,
            "decode": self.decode_engine.scheduler.pool.num_free,
        }

    async def stop(self) -> None:
        if self.queue_worker is not None:
            await self.queue_worker.stop()
        if hasattr(self.prefill_handler, "_transport"):
            await self.prefill_handler._transport.close()
        self.decode_handler.close()
        self.prefill_handler.close()
        await self.inject_server.stop()
        for engine in (self.prefill_engine, self.decode_engine,
                       self.reference_engine):
            await engine.stop()
        for s in self._stores:
            await s.close()
        if self.store_server is not None:
            await self.store_server.stop()

    # ----------------- poisoned-block canary ---------------------------

    async def _plant_canary(self) -> None:
        import torch

        from ..engine.engine import Request

        req = Request(request_id="canary", token_ids=list(range(1, 18)),
                      max_tokens=1)
        seq = self.decode_engine.reserve_sequence(req)
        assert seq is not None, "canary reservation must fit"
        probe = await self.decode_engine.extract_kv_blocks(seq.block_table)
        self._canary_pattern = {
            "k": torch.full(probe["k"].shape, 3.0, dtype=probe["k"].dtype),
            "v": torch.full(probe["v"].shape, -5.0, dtype=probe["v"].dtype),
        }
        await self.decode_engine.inject_kv_blocks(
            seq.block_table, self._canary_pattern
        )
        self._canary_seq = seq

    async def _canary_corrupted(self) -> bool:
        import torch

        got = await self.decode_engine.extract_kv_blocks(
            self._canary_seq.block_table
        )
        ok = all(torch.equal(got[key].float(),
                             self._canary_pattern[key].float())
                 for key in ("k", "v"))
        return not ok

    # ------------------------- the storm --------------------------------

    async def run(self) -> dict:
        from ..runtime import faults
        from ..runtime.faults import FaultPlan

        sc = self.sc
        rng = random.Random(sc.seed)
        prompts = [
            [rng.randrange(1, 255)
             for _ in range(rng.randint(*sc.prompt_len))]
            for _ in range(sc.num_requests)
        ]
        requests = [
            {"token_ids": p, "max_tokens": sc.max_tokens,
             "ignore_eos": True}
            for p in prompts
        ]
        # serial greedy reference BEFORE any fault is installed
        expected = []
        for r in requests:
            expected.append(await self._collect(
                self.reference_engine.generate(dict(r), Context())
            ))

        plan = FaultPlan(seed=sc.seed)
        if sc.plan_fn is not None:
            sc.plan_fn(plan)
        faults.install(plan)
        killer = None
        if sc.kill_prefill_after_pulls is not None:
            killer = asyncio.create_task(self._kill_prefill())
        sem = asyncio.Semaphore(sc.concurrency)
        results: List[Optional[List[int]]] = [None] * sc.num_requests

        async def _one(i: int) -> None:
            async with sem:
                await asyncio.sleep(rng.random() * 0.05)
                try:
                    results[i] = await asyncio.wait_for(
                        self._collect(self.decode_handler.generate(
                            dict(requests[i]),
                            Context(request_id=f"chaos{sc.seed}-{i}"),
                        )),
                        timeout=60.0,
                    )
                except Exception:
                    log.exception("chaos request %d died", i)

        try:
            await asyncio.gather(*(_one(i) for i in range(sc.num_requests)))
        finally:
            faults.clear()
            if killer is not None:
                killer.cancel()
                await asyncio.gather(killer, return_exceptions=True)
        # Quiesce before measuring: stop the queue worker so in-flight
        # prefills receive their cancellations NOW (not at teardown), then
        # wait for sweeps/zombie-reaps to return both pools to baseline.
        # A real leak never converges and still fails the assertion below.
        if self.queue_worker is not None:
            await self.queue_worker.stop()
        for _ in range(50):
            self.decode_handler.sweep_orphans()
            self.prefill_handler.sweep_orphans()
            quiesced = (
                not self.decode_handler.pending
                and not self.prefill_handler._held
                and not self.prefill_engine.scheduler.zombies
                and not self.prefill_engine.scheduler.running
                and (self.prefill_engine.scheduler.pool.num_free
                     == self._free_baseline["prefill"])
                and (self.decode_engine.scheduler.pool.num_free
                     == self._free_baseline["decode"])
            )
            if quiesced:
                break
            await asyncio.sleep(0.2)

        parity_failures = sum(
            1 for got, want in zip(results, expected) if got != want
        )
        completed = sum(1 for got in results if got is not None)
        leaked_pending = (len(self.decode_handler.pending)
                          + len(self.prefill_handler._held))
        # the canary is the only reservation allowed to survive the storm
        leaked_reservations = (
            len(self.decode_engine._kv_reservations)
            - (1 if self._canary_seq is not None else 0)
        )
        canary_corrupted = await self._canary_corrupted()
        leaked_prefill = (self._free_baseline["prefill"]
                          - self.prefill_engine.scheduler.pool.num_free)
        leaked_decode = (self._free_baseline["decode"]
                         - self.decode_engine.scheduler.pool.num_free)
        leaked_blocks = leaked_prefill + leaked_decode
        self.decode_engine.cancel_reservation(self._canary_seq)
        dh, ph = self.decode_handler, self.prefill_handler
        return {
            "name": sc.name,
            "seed": sc.seed,
            "num_requests": sc.num_requests,
            "completed": completed,
            "parity_failures": parity_failures,
            "remote_prefills": dh.num_remote_prefills,
            "local_prefills": dh.num_local_prefills,
            "fallbacks": dh.num_fallbacks,
            "transfer_retries": ph.num_transfer_retries,
            "epoch_rejects": dh.num_epoch_rejects,
            "integrity_rejects": dh.num_integrity_rejects,
            "orphans_reaped": (dh.num_orphans_reaped
                               + ph.num_orphans_reaped),
            "queue_expired": (self.queue_worker.num_expired
                              if self.queue_worker is not None else 0),
            "breaker_trips": dh.fallback_breaker.num_trips,
            "faults_fired": plan.fired(),
            "faults_fired_by_site": plan.fired_counts(),
            "canary_corrupted": canary_corrupted,
            "leaked_blocks": leaked_blocks,
            "leaked_blocks_prefill": leaked_prefill,
            "leaked_blocks_decode": leaked_decode,
            "leaked_pending": leaked_pending,
            "leaked_reservations": leaked_reservations,
        }

    async def _kill_prefill(self) -> None:
        """Hard-kill the queue worker once it pulled enough items (pair
        with a disagg.transfer delay to make the kill land mid-transfer),
        then optionally revive a fresh worker so the storm can recover."""
        from ..disagg.handlers import PrefillQueueWorker

        sc = self.sc
        while (self.queue_worker is None
               or self.queue_worker.num_pulled < sc.kill_prefill_after_pulls):
            await asyncio.sleep(0.01)
        pulled = self.queue_worker.num_pulled
        await self.queue_worker.stop()
        log.info("chaos: killed prefill queue worker after %d pulls", pulled)
        if sc.revive_prefill:
            await asyncio.sleep(0.3)
            self.queue_worker = PrefillQueueWorker(
                self.prefill_handler, self._stores[0],
                queue_name=self.config.queue_name,
            )
            self.queue_worker.start()

    @staticmethod
    async def _collect(stream) -> List[int]:
        toks: List[int] = []
        async for out in stream:
            toks.extend(out["token_ids"])
        return toks


async def run_disagg_scenario(sc: DisaggChaosScenario) -> dict:
    """One-shot: build the harness, run the storm, tear everything down."""
    h = DisaggChaosHarness(sc)
    await h.start()
    try:
        return await h.run()
    finally:
        await h.stop()


# --------------------- preemption chaos harness --------------------------
# Real tiny InferenceEngines driven through seeded preemption storms: a
# maintenance notice lands mid-decode and every in-flight seat must end up
# byte-identical to an unfaulted reference — continued on a peer after a
# device-plane KV hand-off, resumed from the host spill tier, or replayed
# Migration-style from the seat journal. The same harness drives the engine
# stall watchdog (a wedged dispatch window must recover, not hang) and the
# HBM-pressure ladder (spill/pause/shed must engage and release without
# leaking a block).


@dataclass
class PreemptionChaosScenario:
    """One seeded preemption storm. ``mode`` picks the failure shape:

    - ``notice-then-kill``   notice → evacuate to a peer → kill the source
    - ``notice-no-peer``     notice with no peer: spill to the host tier,
                             resume from kvbm prefix hits
    - ``kill-no-notice``     the notice is LOST (fault drop): seats die
                             cold and recovery is Migration-style replay
    - ``stall-mid-window``   a dispatch window wedges on device; the stall
                             watchdog must recover it within the deadline
    - ``pressure-waves``     an undersized pool forces the HBM-pressure
                             ladder through spill → shed and back
    """

    name: str
    mode: str
    seed: int = 0
    num_requests: int = 4
    concurrency: int = 4
    prompt_len: Tuple[int, int] = (24, 40)
    # enough decode runway that seats are still mid-flight when the grace
    # window closes — CPU decode is fast, short budgets drain during it
    max_tokens: int = 20
    # fire the notice once every live request has emitted this many tokens
    notice_after_tokens: int = 2
    # zero grace keeps the storm deterministic: a warmed CPU engine drains
    # any realistic token budget inside a timed grace window, leaving
    # nothing to evacuate (the grace sleep itself has no failure modes)
    notice_grace_s: float = 0.0
    evac_deadline_s: float = 10.0
    # stall-mid-window: watchdog deadline + injected wedge length
    stall_timeout_s: float = 0.4
    stall_delay_s: float = 2.0
    stall_after_windows: int = 3
    # pressure-waves: pool size + ladder thresholds
    pressure_num_blocks: int = 40
    pressure_spill_threshold: float = 0.6
    pressure_shed_threshold: float = 0.85
    plan_fn: Optional[object] = None   # Callable[[FaultPlan], None]


class PreemptionChaosHarness:
    """Builds the source/peer/reference engine trio, plants the canary on
    the receiver, runs the storm, accounts for every block. Use
    :func:`run_preemption_scenario` for the one-shot form."""

    def __init__(self, sc: PreemptionChaosScenario):
        self.sc = sc
        self._canary_seq = None
        self._canary_pattern = None
        self._free_baseline: Dict[str, int] = {}

    # ------------------------------ setup -------------------------------

    async def start(self) -> None:
        from ..engine.config import EngineConfig, ModelConfig
        from ..engine.engine import InferenceEngine
        from ..kvbm.manager import KvbmConfig
        from ..runtime.preemption import PreemptionCoordinator

        sc = self.sc
        model_cfg = ModelConfig.tiny(vocab_size=256)
        kwargs: dict = {}
        num_blocks = 64
        if sc.mode == "stall-mid-window":
            # two decode rungs so quarantine can route 4-row windows to
            # the 8-row bucket instead of rebuilding with einsum attention
            kwargs = {"stall_timeout_s": sc.stall_timeout_s,
                      "stall_seq_retries": 4, "stall_dead_threshold": 10}
        elif sc.mode == "pressure-waves":
            num_blocks = sc.pressure_num_blocks
            kwargs = {
                "pressure_spill_threshold": sc.pressure_spill_threshold,
                "pressure_shed_threshold": sc.pressure_shed_threshold,
                "pressure_release": 0.1,
            }
        eng_cfg = EngineConfig(
            num_blocks=num_blocks, block_size=4, max_model_len=128,
            max_num_batched_tokens=128, prefill_buckets=(128,),
            decode_buckets=(4, 8), max_num_seqs=4, **kwargs,
        )
        ref_cfg = EngineConfig(
            num_blocks=64, block_size=4, max_model_len=128,
            max_num_batched_tokens=128, prefill_buckets=(128,),
            decode_buckets=(4, 8), max_num_seqs=4,
        )
        # identical init seeds: evacuated continuations, spill resumes, and
        # the serial reference must all be greedy-identical
        self.src = InferenceEngine(model_cfg, eng_cfg, seed=0)
        self.peer = InferenceEngine(model_cfg, ref_cfg, seed=0)
        self.reference = InferenceEngine(model_cfg, ref_cfg, seed=0)
        if sc.mode == "notice-no-peer":
            # the spill tier: src evacuates into its host pool; the resume
            # worker onboards from the SAME pool (a shared host tier, as
            # the store remote tier would be in production)
            self.src.attach_kvbm(KvbmConfig(host_blocks=256))
            self.peer.attach_kvbm(KvbmConfig(host_blocks=256))
            self.peer.kvbm.host_pool = self.src.kvbm.host_pool
        self.coordinator = PreemptionCoordinator(
            self.src,
            worker_key=f"chaos-{sc.seed}",
            peer=self.peer if sc.mode == "notice-then-kill" else None,
            notice_grace_s=sc.notice_grace_s,
            evac_deadline_s=sc.evac_deadline_s,
        )
        await self._plant_canary()
        self._free_baseline = {
            "src": self.src.scheduler.pool.num_free,
            "peer": self.peer.scheduler.pool.num_free,
        }

    async def stop(self) -> None:
        for engine in (self.src, self.peer, self.reference):
            await engine.stop()

    async def _plant_canary(self) -> None:
        import torch

        from ..engine.engine import Request

        req = Request(request_id="canary", token_ids=list(range(1, 18)),
                      max_tokens=1)
        seq = self.peer.reserve_sequence(req)
        assert seq is not None, "canary reservation must fit"
        probe = await self.peer.extract_kv_blocks(seq.block_table)
        self._canary_pattern = {
            "k": torch.full(probe["k"].shape, 3.0, dtype=probe["k"].dtype),
            "v": torch.full(probe["v"].shape, -5.0, dtype=probe["v"].dtype),
        }
        await self.peer.inject_kv_blocks(seq.block_table,
                                         self._canary_pattern)
        self._canary_seq = seq

    async def _canary_corrupted(self) -> bool:
        import torch

        got = await self.peer.extract_kv_blocks(self._canary_seq.block_table)
        ok = all(torch.equal(got[key].float(),
                             self._canary_pattern[key].float())
                 for key in ("k", "v"))
        return not ok

    # ---------------------------- collectors ----------------------------

    @staticmethod
    async def _collect_wire(stream) -> Tuple[List[int], Optional[str]]:
        """Tokens + final finish_reason from a wire-dict stream. Keyed by
        index: an abort/evacuation finish frame re-carries the last token,
        which must not be double-counted."""
        toks: Dict[int, int] = {}
        reason = None
        async for out in stream:
            for t in out["token_ids"]:
                if t >= 0:
                    toks[out["index"]] = t
            if out.get("finished"):
                reason = out.get("finish_reason")
        return [toks[i] for i in sorted(toks)], reason

    @staticmethod
    async def _collect_outputs(aiter) -> Tuple[List[int], Optional[str]]:
        """Same, for a StepOutput stream (submit / resume_prefilled)."""
        toks: Dict[int, int] = {}
        reason = None
        async for out in aiter:
            if out.token_id >= 0:
                toks[out.index] = out.token_id
            if out.finished:
                reason = out.finish_reason
                break
        return [toks[i] for i in sorted(toks)], reason

    # ----------------------------- the storm ----------------------------

    async def run(self) -> dict:
        from ..runtime import faults
        from ..runtime.faults import FaultPlan

        sc = self.sc
        rng = random.Random(sc.seed)
        prompts = [
            [rng.randrange(1, 255)
             for _ in range(rng.randint(*sc.prompt_len))]
            for _ in range(sc.num_requests)
        ]
        requests = [
            {"token_ids": p, "max_tokens": sc.max_tokens,
             "ignore_eos": True}
            for p in prompts
        ]
        # serial greedy reference BEFORE any fault is installed
        expected = []
        for r in requests:
            toks, _ = await self._collect_wire(
                self.reference.generate(dict(r), Context())
            )
            expected.append(toks)

        plan = FaultPlan(seed=sc.seed)
        if sc.plan_fn is not None:
            sc.plan_fn(plan)
        if sc.mode == "kill-no-notice":
            plan.drop_connection("preempt.notice")
        if sc.mode == "stall-mid-window":
            plan.delay("engine.stall", sc.stall_delay_s,
                       after=sc.stall_after_windows, times=1)
        faults.install(plan)

        progress = [0] * sc.num_requests
        results: List[Optional[List[int]]] = [None] * sc.num_requests
        reasons: List[Optional[str]] = [None] * sc.num_requests
        sem = asyncio.Semaphore(sc.concurrency)

        async def _one(i: int) -> None:
            async with sem:
                await asyncio.sleep(rng.random() * 0.02)
                ctx = Context(request_id=f"preempt{sc.seed}-{i}")
                for attempt in range(40):
                    try:
                        toks: Dict[int, int] = {}
                        reason = None
                        async for out in self.src.generate(
                            dict(requests[i]), ctx
                        ):
                            for t in out["token_ids"]:
                                if t >= 0:
                                    toks[out["index"]] = t
                            progress[i] = len(toks)
                            if out.get("finished"):
                                reason = out.get("finish_reason")
                        results[i] = [toks[k] for k in sorted(toks)]
                        reasons[i] = reason
                        return
                    except RuntimeError as exc:
                        # admission shed (pressure rung 3): back off and
                        # retry, exactly what the router would do
                        if "shed" not in str(exc):
                            raise
                        await asyncio.sleep(0.05)
                raise AssertionError(f"request {i} shed forever")

        report = None

        async def _notice_when_decoding() -> None:
            nonlocal report
            while not all(p >= sc.notice_after_tokens or r is not None
                          for p, r in zip(progress, results)):
                await asyncio.sleep(0.005)
            report = await self.coordinator.notice("chaos")
            if sc.mode == "kill-no-notice":
                # the notice was dropped: the kill lands on live seats
                for seq in list(self.src.scheduler.running):
                    self.src.abort(seq.seq_id, "error")

        noticer = None
        if sc.mode in ("notice-then-kill", "notice-no-peer",
                       "kill-no-notice"):
            noticer = asyncio.create_task(_notice_when_decoding())
        try:
            await asyncio.wait_for(
                asyncio.gather(*(_one(i) for i in range(sc.num_requests))),
                timeout=120.0,
            )
            if noticer is not None:
                await asyncio.wait_for(noticer, timeout=30.0)
        finally:
            faults.clear()
            if noticer is not None and not noticer.done():
                noticer.cancel()
                await asyncio.gather(noticer, return_exceptions=True)

        # ----- resume every interrupted seat and splice the tails -----
        by_seat = {}
        if report is not None:
            by_seat = {r.record.seq_id: r for r in report.results}
        spliced: List[Optional[List[int]]] = []
        for i in range(sc.num_requests):
            got, reason = results[i], reasons[i]
            if got is None:
                spliced.append(None)
                continue
            if reason in ("length", "stop"):
                spliced.append(got)        # finished before the storm hit
                continue
            rid = f"preempt{sc.seed}-{i}"
            res = by_seat.get(rid)
            if res is not None and res.mode == "peer":
                # receiver re-emits the frontier token as index 0; the
                # source already delivered it
                tail, _ = await self._collect_outputs(
                    self.peer.resume_prefilled(
                        res.dst_seq, res.record.first_token())
                )
                spliced.append(got + tail[1:])
            elif res is not None and res.mode in ("spill", "fallback"):
                req = res.record.resume_request()
                tail, _ = await self._collect_outputs(
                    await self._submit(self.peer, req))
                spliced.append(got + tail)
            elif reason == "error" and sc.mode == "kill-no-notice":
                # Migration-style replay from client state: full history
                # as prompt, budget shrunk by what was delivered
                from ..engine.engine import Request

                req = Request(
                    request_id=rid, token_ids=list(prompts[i]) + got,
                    max_tokens=max(1, sc.max_tokens - len(got)),
                    ignore_eos=True,
                )
                tail, _ = await self._collect_outputs(
                    await self._submit(self.peer, req))
                spliced.append(got + tail)
            else:
                spliced.append(got)

        # quiesce: all seats finished, pools back to baseline
        for _ in range(50):
            if (not self.src.scheduler.running
                    and not self.src.scheduler.waiting
                    and not self.peer.scheduler.running
                    and (self.src.scheduler.pool.num_free
                         == self._free_baseline["src"])
                    and (self.peer.scheduler.pool.num_free
                         == self._free_baseline["peer"])):
                break
            await asyncio.sleep(0.2)

        parity_failures = sum(
            1 for got, want in zip(spliced, expected) if got != want
        )
        completed = sum(1 for got in spliced if got is not None)
        leaked_src = (self._free_baseline["src"]
                      - self.src.scheduler.pool.num_free)
        leaked_peer = (self._free_baseline["peer"]
                       - self.peer.scheduler.pool.num_free)
        # the canary is the only reservation allowed to survive the storm
        leaked_reservations = (
            len(self.src._kv_reservations)
            + len(self.peer._kv_reservations)
            - (1 if self._canary_seq is not None else 0)
        )
        leaked_pending = sum(
            s.pending_total for s in self.src.scheduler.running
        )
        canary_corrupted = await self._canary_corrupted()
        self.peer.cancel_reservation(self._canary_seq)
        out = {
            "name": sc.name,
            "mode": sc.mode,
            "seed": sc.seed,
            "num_requests": sc.num_requests,
            "completed": completed,
            "parity_failures": parity_failures,
            "notices": self.coordinator.num_notices,
            "evacuated_peer": self.coordinator.num_evacuated,
            "spilled": self.coordinator.num_spilled,
            "fallbacks": self.coordinator.num_fallbacks,
            "journal_len": len(self.coordinator.journal),
            "notice_lost": bool(report.notice_lost) if report else False,
            "deadline_blown": (bool(report.deadline_blown)
                               if report else False),
            "stalls": self.src.num_stalls,
            "stall_dead": self.src.stall_dead,
            "quarantined_shapes": len(self.src._shape_quarantine),
            "pressure_spills": self.src.num_pressure_spills,
            "pressure_shed": self.src.num_pressure_shed,
            "pressure_level": self.src.pressure_level,
            "pressure_peak": self.src.pressure_peak,
            "onboarded_blocks": (
                self.peer.kvbm.stats.onboarded_blocks
                if self.peer.kvbm is not None else 0),
            "faults_fired": plan.fired(),
            "faults_fired_by_site": plan.fired_counts(),
            "canary_corrupted": canary_corrupted,
            "leaked_blocks": leaked_src + leaked_peer,
            "leaked_blocks_src": leaked_src,
            "leaked_blocks_peer": leaked_peer,
            "leaked_pending": leaked_pending,
            "leaked_reservations": leaked_reservations,
        }
        return out

    @staticmethod
    async def _submit(engine, req):
        return engine.submit(req)


async def run_preemption_scenario(sc: PreemptionChaosScenario) -> dict:
    """One-shot: build the harness, run the storm, tear everything down."""
    h = PreemptionChaosHarness(sc)
    await h.start()
    try:
        return await h.run()
    finally:
        await h.stop()
