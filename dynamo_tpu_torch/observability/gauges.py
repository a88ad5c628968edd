"""Worker-local Prometheus gauges for the engine flight recorder.

``EngineObsGauges`` mints the ``engine_*`` gauges on a MetricsRegistry and
refreshes them from ``engine.obs_snapshot()``; ``refresh()`` doubles as the
``WorkerMetricsPublisher.obs_fn`` so the same snapshot rides the wire to
the metrics aggregator (per-worker gauges + planner signals) at the
publish cadence — one read of the recorder per interval, zero per-token
overhead.

A copy of ``dynamo_tpu.observability.gauges`` on the port's
``MetricsRegistry``, with the same metric names, labels and help text. The
engine's snapshot carries the graph-capture watch's keys
(``observability/compilewatch.py``: ``engine_recompiles_total{fn}`` counts
steady-state graph captures per window key; ``engine_involuntary_remats_
total`` stays 0, XLA's remat warning having no counterpart) and, with
adaptive buckets on, the ladders' keys (``engine_ladder_*{kind}``).
"""

from __future__ import annotations

from typing import Dict


class EngineObsGauges:
    def __init__(self, registry, engine):
        self._engine = engine
        self._g_mfu = registry.gauge(
            "engine_mfu",
            "live model-FLOPs utilization over the trailing window "
            "(goodput FLOPs / peak; attention term included)",
        )
        self._g_mfu_class = registry.gauge(
            "engine_mfu_by_class",
            "live MFU split by step class", ["step"]
        )
        self._g_goodput = registry.gauge(
            "engine_goodput_tok_s",
            "real tokens landed per second over the trailing window",
        )
        self._g_pad_waste = registry.gauge(
            "engine_padding_waste_ratio",
            "fraction of dispatched FLOPs burnt on bucket padding",
        )
        self._g_waste = registry.gauge(
            "engine_wasted_flops_ratio",
            "fraction of dispatched FLOPs wasted, by cause", ["cause"]
        )
        self._g_recompiles = registry.gauge(
            "engine_recompiles_total",
            "steady-state XLA backend compiles per jitted function "
            "(anything nonzero after warmup is a shape leak)", ["fn"]
        )
        self._g_remats = registry.gauge(
            "engine_involuntary_remats_total",
            "XLA [SPMD] involuntary full rematerialization warnings seen",
        )
        self._g_ladder = registry.gauge(
            "engine_ladder_rungs",
            "live bucket-ladder rung count per dispatch kind "
            "(engine/ladder.py; static buckets when the ladder is off)",
            ["kind"]
        )
        self._g_ladder_splits = registry.gauge(
            "engine_ladder_splits_total",
            "bucket-ladder rungs added (each costs one steady-state "
            "compile per consuming jit family)", ["kind"]
        )
        self._g_ladder_retires = registry.gauge(
            "engine_ladder_retires_total",
            "bucket-ladder rungs retired for cold occupancy", ["kind"]
        )
        self._g_ladder_budget = registry.gauge(
            "engine_ladder_budget_remaining",
            "bucket-ladder compile budget left (0 = grid frozen)", ["kind"]
        )

    def refresh(self) -> Dict[str, float]:
        """Pull one recorder snapshot, set every gauge, return the wire
        dict for the load-metrics publisher."""
        snap = self._engine.obs_snapshot()
        if not snap:
            return {}
        self._g_mfu.set(snap.get("mfu", 0.0))
        self._g_mfu_class.labels(step="prefill").set(
            snap.get("mfu_prefill", 0.0))
        self._g_mfu_class.labels(step="decode").set(
            snap.get("mfu_decode", 0.0))
        self._g_goodput.set(snap.get("goodput_tok_s", 0.0))
        self._g_pad_waste.set(snap.get("padding_waste_ratio", 0.0))
        self._g_waste.labels(cause="padding").set(
            snap.get("padding_waste_ratio", 0.0))
        self._g_waste.labels(cause="spec_reject").set(
            snap.get("spec_reject_waste_ratio", 0.0))
        for fn, n in (snap.get("recompiles_by_fn") or {}).items():
            self._g_recompiles.labels(fn=fn).set(n)
        self._g_remats.set(snap.get("involuntary_remats_total", 0))
        for kind in ("decode", "prefill"):
            n_rungs = snap.get(f"ladder_{kind}_rungs_n")
            if n_rungs is None:
                continue
            self._g_ladder.labels(kind=kind).set(n_rungs)
            self._g_ladder_splits.labels(kind=kind).set(
                snap.get(f"ladder_{kind}_splits_total", 0))
            self._g_ladder_retires.labels(kind=kind).set(
                snap.get(f"ladder_{kind}_retires_total", 0))
            self._g_ladder_budget.labels(kind=kind).set(
                snap.get(f"ladder_{kind}_budget_remaining", 0))
        # the wire snapshot carries scalars only (msgpack-friendly, and the
        # aggregator's zero-default reads stay flat)
        return {
            k: v for k, v in snap.items()
            if isinstance(v, (int, float))
        }
