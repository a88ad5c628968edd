"""Pre-profiled performance interpolation (ref: components/planner/src/
dynamo/planner/utils/perf_interpolation.py — PrefillInterpolator,
DecodeInterpolator).

The SLA profiler sweeps the engine offline and records:
- prefill: ISL → TTFT and throughput/chip (1D curves);
- decode: (kv_usage, context_length) → ITL and throughput/chip (2D surface).

The planner inverts these at runtime: "what per-chip throughput can I run at
while keeping ITL under the SLA at this context length?" Linear
interpolation over the profiled grid — smooth enough for scaling decisions,
no scipy dependency.

A copy of ``dynamo_tpu.planner.interpolation``; the profile's keys are the
ones ``dynamo_tpu_torch.planner.profiler`` writes (and the JAX profiler's).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


class PrefillInterpolator:
    """1D ISL → (ttft_s, throughput_per_chip) interpolation."""

    def __init__(self, isl: Sequence[float], ttft_s: Sequence[float],
                 thpt_per_chip: Sequence[float]):
        order = np.argsort(isl)
        self.isl = np.asarray(isl, np.float64)[order]
        self.ttft = np.asarray(ttft_s, np.float64)[order]
        self.thpt = np.asarray(thpt_per_chip, np.float64)[order]

    @classmethod
    def from_profile(cls, profile: Dict) -> "PrefillInterpolator":
        return cls(profile["prefill_isl"], profile["prefill_ttft_s"],
                   profile["prefill_thpt_per_chip"])

    def interpolate_ttft(self, isl: float) -> float:
        return float(np.interp(isl, self.isl, self.ttft))

    def interpolate_thpt_per_chip(self, isl: float) -> float:
        return float(np.interp(isl, self.isl, self.thpt))


class DecodeInterpolator:
    """2D (kv_usage ∈ [0,1], context_length) → (itl_s, throughput/chip).

    Profiled as scattered points; queried either directly (bilinear over a
    gridded fit) or inversely via :meth:`find_best_throughput_per_chip`.
    """

    def __init__(self, kv_usage: Sequence[float],
                 context_length: Sequence[float],
                 itl_s: Sequence[float],
                 thpt_per_chip: Sequence[float],
                 resolution: int = 64):
        x = np.asarray(kv_usage, np.float64)
        y = np.asarray(context_length, np.float64)
        self.itl = np.asarray(itl_s, np.float64)
        self.thpt = np.asarray(thpt_per_chip, np.float64)
        self.points = np.stack([x, y], axis=1)
        self.xi = np.linspace(0.0, 1.0, resolution)
        self.yi = np.linspace(float(y.min()), float(y.max()), resolution)

    @classmethod
    def from_profile(cls, profile: Dict) -> "DecodeInterpolator":
        return cls(profile["decode_kv_usage"],
                   profile["decode_context_length"],
                   profile["decode_itl_s"],
                   profile["decode_thpt_per_chip"])

    def _idw(self, values: np.ndarray, x: float, y: float) -> float:
        """Inverse-distance-weighted estimate at (x, y) — robust on the
        scattered profile points without scipy's Delaunay machinery."""
        span_y = max(1.0, float(self.yi[-1] - self.yi[0]))
        d2 = ((self.points[:, 0] - x) ** 2
              + ((self.points[:, 1] - y) / span_y) ** 2)
        near = d2 < 1e-12
        if near.any():
            return float(values[near][0])
        w = 1.0 / d2
        return float((w * values).sum() / w.sum())

    def interpolate_itl(self, kv_usage: float, context_length: float) -> float:
        return self._idw(self.itl, min(max(kv_usage, 0.0), 1.0),
                         context_length)

    def interpolate_thpt_per_chip(self, kv_usage: float,
                                  context_length: float) -> float:
        return self._idw(self.thpt, min(max(kv_usage, 0.0), 1.0),
                         context_length)

    def find_best_throughput_per_chip(
        self, itl_s: float, context_length: float
    ) -> Tuple[float, float, float]:
        """Max throughput/chip whose interpolated ITL stays ≤ the target at
        this context length. Returns (thpt_per_chip, kv_usage, itl_s);
        falls back to the lowest-ITL operating point when nothing meets the
        SLA (best effort, same shape as the reference's inverse lookup)."""
        best = None
        fallback = None
        for x in self.xi:
            itl = self.interpolate_itl(float(x), context_length)
            thpt = self.interpolate_thpt_per_chip(float(x), context_length)
            cand = (thpt, float(x), itl)
            if fallback is None or itl < fallback[2]:
                fallback = cand
            if itl <= itl_s and (best is None or thpt > best[0]):
                best = cand
        return best if best is not None else fallback
