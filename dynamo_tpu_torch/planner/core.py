"""Planner core: metrics window → load prediction → replica targets
(ref: components/planner/src/dynamo/planner/utils/planner_core.py —
observe_metrics:193, predict_load:240, _compute_replica_requirements:259).

Every adjustment interval the planner:
1. observes the window's request rate, mean ISL/OSL, and measured TTFT/ITL
   (tail-aware: p99 when the frontend publishes percentiles, average as the
   forward-compat fallback) plus the live pressure signals the serving path
   exposes — admission/worker queue depth, router breaker states, spec
   acceptance;
2. updates correction factors = measured latency / interpolated latency
   (queueing and interference the offline profile can't see);
3. orders graceful degradation (shed → clamp spec_k → tighten chunking)
   while the SLO overshoot is severe, releasing in reverse as it falls;
4. predicts next-window load with per-signal predictors;
5. converts predicted load into prefill/decode replica counts using the
   profiled perf curves, clamps to the chip budget, and emits the targets
   through the connector.

A copy of ``dynamo_tpu.planner.core``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from ..utils.logging import get_logger
from .degradation import DegradationConfig, DegradationLadder
from .interpolation import DecodeInterpolator, PrefillInterpolator
from .predictors import ARPredictor

log = get_logger("planner")


@dataclass
class WindowMetrics:
    """One adjustment window's observed aggregates.

    The percentile fields are optional: older frontends publish only the
    averages and the planner keeps working on those. ``queue_depth`` is the
    sum of requests waiting anywhere (admission queue + worker queues),
    ``breaker_open`` counts router breakers not currently closed, and
    ``spec_acceptance`` is the aggregate draft acceptance rate (None when
    speculative decoding is off)."""

    num_requests: float
    isl_avg: float
    osl_avg: float
    ttft_avg_s: Optional[float] = None
    itl_avg_s: Optional[float] = None
    ttft_p50_s: Optional[float] = None
    ttft_p99_s: Optional[float] = None
    itl_p50_s: Optional[float] = None
    itl_p99_s: Optional[float] = None
    queue_depth: float = 0.0
    breaker_open: int = 0
    spec_acceptance: Optional[float] = None
    # workers that received a maintenance notice this window: capacity that
    # is evacuating and about to vanish (runtime.preemption)
    preempt_notices: int = 0

    @property
    def is_valid(self) -> bool:
        vals = [self.num_requests, self.isl_avg, self.osl_avg]
        return all(v is not None and v == v and v > 0 for v in vals)

    def ttft_signal(self, quantile: str = "p99") -> Optional[float]:
        """The TTFT the SLA is judged against: the requested percentile when
        published, else the average (old frontends)."""
        if quantile == "p99" and self.ttft_p99_s is not None:
            return self.ttft_p99_s
        if quantile == "p50" and self.ttft_p50_s is not None:
            return self.ttft_p50_s
        return self.ttft_avg_s

    def itl_signal(self, quantile: str = "p99") -> Optional[float]:
        if quantile == "p99" and self.itl_p99_s is not None:
            return self.itl_p99_s
        if quantile == "p50" and self.itl_p50_s is not None:
            return self.itl_p50_s
        return self.itl_avg_s


@dataclass
class PlannerConfig:
    ttft_sla_s: float = 0.5
    itl_sla_s: float = 0.05
    adjustment_interval_s: float = 60.0
    prefill_engine_num_chips: int = 1
    decode_engine_num_chips: int = 1
    min_endpoint: int = 1
    max_chip_budget: int = 64
    predictor_order: int = 4
    # which latency statistic the SLA is enforced on ("p99" | "p50" | "avg")
    sla_quantile: str = "p99"
    # fold the queue backlog into predicted load (a standing queue is demand
    # the arrival rate alone does not show)
    queue_depth_weight: float = 1.0
    # add one decode replica per open breaker: a tripped worker serves
    # nothing, so intent must cover the hole until it heals
    compensate_breakers: bool = True
    # add one decode replica per maintenance-noticed worker: its seats are
    # evacuating and the node is leaving — scale the replacement proactively
    # instead of waiting for the capacity hole to show up in latency
    compensate_preemptions: bool = True
    # graceful degradation before scaling; None disables the ladder
    degradation: Optional[DegradationConfig] = field(
        default_factory=DegradationConfig
    )


class Planner:
    def __init__(
        self,
        config: PlannerConfig,
        prefill: PrefillInterpolator,
        decode: DecodeInterpolator,
        connector,
        prefill_component: str = "prefill",
        decode_component: str = "backend",
    ):
        self.config = config
        self.prefill = prefill
        self.decode = decode
        self.connector = connector
        self.prefill_component = prefill_component
        self.decode_component = decode_component
        p = config.predictor_order
        self._pred_req = ARPredictor(p)
        self._pred_isl = ARPredictor(p)
        self._pred_osl = ARPredictor(p)
        self.p_correction = 1.0
        self.d_correction = 1.0
        self.last_targets = (config.min_endpoint, config.min_endpoint)
        self.last_window: Optional[WindowMetrics] = None
        self.ladder = (DegradationLadder(config.degradation)
                       if config.degradation is not None else None)

    # ------------------------- observation -----------------------------

    def observe(self, m: WindowMetrics) -> None:
        if not m.is_valid:
            return
        self.last_window = m
        self._pred_req.observe(m.num_requests)
        self._pred_isl.observe(m.isl_avg)
        self._pred_osl.observe(m.osl_avg)
        q = self.config.sla_quantile
        ttft = m.ttft_signal(q)
        if ttft:
            expect = self.prefill.interpolate_ttft(m.isl_avg)
            if expect > 0:
                self.p_correction = ttft / expect
        itl = m.itl_signal(q)
        if itl:
            expect = self.decode.interpolate_itl(
                0.5, m.isl_avg + m.osl_avg / 2
            )
            if expect > 0:
                self.d_correction = itl / expect

    def pressure(self) -> Optional[float]:
        """Worst SLO overshoot ratio in the last window (1.0 = exactly at
        SLA); None without a latency observation to judge."""
        m = self.last_window
        if m is None:
            return None
        q = self.config.sla_quantile
        ratios = []
        ttft = m.ttft_signal(q)
        if ttft is not None and self.config.ttft_sla_s > 0:
            ratios.append(ttft / self.config.ttft_sla_s)
        itl = m.itl_signal(q)
        if itl is not None and self.config.itl_sla_s > 0:
            ratios.append(itl / self.config.itl_sla_s)
        return max(ratios) if ratios else None

    # ------------------------- planning --------------------------------

    def compute_replicas(self, num_req: float, isl: float,
                         osl: float) -> tuple:
        """Replica counts meeting the SLAs at the predicted load
        (semantics of ref _compute_replica_requirements:259-355)."""
        cfg = self.config
        interval = cfg.adjustment_interval_s

        # prefill: queueing delay scales ~linearly with backlog, so spend
        # replicas proportional to the TTFT overshoot (capped at 1 —
        # running *better* than SLA must not scale us below the load)
        prefill_tput = (num_req * isl / interval
                        * max(1.0, min(self.p_correction, 4.0)))
        per_prefill = (self.prefill.interpolate_thpt_per_chip(isl)
                       * cfg.prefill_engine_num_chips)
        num_p = math.ceil(prefill_tput / max(per_prefill, 1e-9))

        # decode: tighten the ITL target by the observed interference,
        # then run each chip at the best profiled point meeting it
        corrected_itl = (cfg.itl_sla_s / self.d_correction
                         if self.d_correction > 0 else cfg.itl_sla_s)
        best_tput, _, _ = self.decode.find_best_throughput_per_chip(
            itl_s=corrected_itl, context_length=isl + osl / 2
        )
        decode_tput = num_req * osl / interval
        num_d = math.ceil(
            decode_tput / max(best_tput * cfg.decode_engine_num_chips, 1e-9)
        )

        # live signals: a standing backlog is unserved demand on top of the
        # arrival rate, and an open breaker is capacity that exists on paper
        # only — both demand replicas the rate×latency math can't see
        m = self.last_window
        if m is not None:
            if m.queue_depth > 0 and num_req > 0:
                boost = 1.0 + (cfg.queue_depth_weight * m.queue_depth
                               / max(num_req, 1.0))
                num_p = math.ceil(num_p * min(boost, 4.0))
            if cfg.compensate_breakers and m.breaker_open > 0:
                num_d += int(m.breaker_open)
            if cfg.compensate_preemptions and m.preempt_notices > 0:
                num_d += int(m.preempt_notices)

        num_p = max(num_p, cfg.min_endpoint)
        num_d = max(num_d, cfg.min_endpoint)

        total = (num_p * cfg.prefill_engine_num_chips
                 + num_d * cfg.decode_engine_num_chips)
        if total > cfg.max_chip_budget:
            scale = cfg.max_chip_budget / total
            num_p = max(cfg.min_endpoint, round(num_p * scale))
            num_d = max(cfg.min_endpoint, math.floor(
                (cfg.max_chip_budget
                 - num_p * cfg.prefill_engine_num_chips)
                / cfg.decode_engine_num_chips
            ))
            log.warning("chip budget clamps targets to p=%d d=%d",
                        num_p, num_d)
        return num_p, num_d

    async def _order_degradation(self) -> None:
        """One ladder move per window, pushed through the connector (which
        skips unchanged orders) and broadcast for the aggregator's gauges."""
        if self.ladder is None:
            return
        pressure = self.pressure()
        if pressure is None:
            return
        transition = self.ladder.update(pressure)
        actions = self.ladder.actions()
        if hasattr(self.connector, "set_degradation"):
            await self.connector.set_degradation(actions)
        if transition is not None and hasattr(self.connector,
                                              "publish_event"):
            direction, step = transition
            await self.connector.publish_event({
                "kind": "degradation", "direction": direction, "step": step,
                "level": self.ladder.level, "pressure": pressure,
            })

    async def make_adjustments(self) -> Optional[tuple]:
        """Order degradation for the current pressure, then predict the next
        window and emit replica targets. Returns (num_p, num_d) or None when
        there is no traffic history yet."""
        await self._order_degradation()
        m = self.last_window
        if (m is not None and m.preempt_notices > 0
                and hasattr(self.connector, "publish_event")):
            # surface the proactive-scale trigger so dashboards can line the
            # evacuation up against the replica response
            await self.connector.publish_event({
                "kind": "preemption", "notices": int(m.preempt_notices),
            })
        req = self._pred_req.predict()
        isl = self._pred_isl.predict()
        osl = self._pred_osl.predict()
        if not req or not isl or not osl:
            return None
        num_p, num_d = self.compute_replicas(req, isl, osl)
        if (num_p, num_d) != self.last_targets:
            log.info("scaling targets: prefill=%d decode=%d "
                     "(req=%.1f isl=%.0f osl=%.0f pcorr=%.2f dcorr=%.2f)",
                     num_p, num_d, req, isl, osl,
                     self.p_correction, self.d_correction)
            if hasattr(self.connector, "publish_event"):
                await self.connector.publish_event({
                    "kind": "scale", "prefill": num_p, "decode": num_d,
                })
        await self.connector.scale(self.prefill_component, num_p)
        await self.connector.scale(self.decode_component, num_d)
        self.last_targets = (num_p, num_d)
        return num_p, num_d
