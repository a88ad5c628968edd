"""Load predictors (ref: components/planner/src/dynamo/planner/utils/
load_predictor.py — Constant:66, ARIMA:79, Prophet:119).

Each predictor consumes one observation per adjustment window and predicts
the next window's value. The ARIMA/Prophet roles are covered by a
least-squares AR(p) model — no heavyweight stats deps in the serving image.

A copy of ``dynamo_tpu.planner.predictors``.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Deque, Optional

import numpy as np


def _clean(value) -> Optional[float]:
    """None for unusable observations (None/NaN/inf — the shapes a startup
    gap or a store outage window produces), else the float value."""
    if value is None:
        return None
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


class ConstantPredictor:
    """Next value = last observed value."""

    def __init__(self) -> None:
        self._last: Optional[float] = None

    def observe(self, value: float) -> None:
        v = _clean(value)
        if v is not None:
            self._last = v

    def predict(self) -> Optional[float]:
        return self._last


class MovingAveragePredictor:
    """Next value = mean of the last ``window`` observations."""

    def __init__(self, window: int = 8) -> None:
        self._buf: Deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        v = _clean(value)
        if v is not None:
            self._buf.append(v)

    def predict(self) -> Optional[float]:
        return float(np.mean(self._buf)) if self._buf else None


class ARPredictor:
    """AR(p) one-step-ahead forecast fitted by least squares over a sliding
    history. Captures trends and short periodicities (the ARIMA role);
    falls back to the mean until 2p+1 observations exist.

    Invalid observations (None/NaN/inf) are dropped instead of entering the
    history: one empty adjustment window during startup or a store outage
    must not poison every subsequent lstsq fit with NaN."""

    def __init__(self, order: int = 4, history: int = 64) -> None:
        self.order = order
        self._buf: Deque[float] = deque(maxlen=history)
        self.num_dropped = 0

    def observe(self, value: float) -> None:
        v = _clean(value)
        if v is None:
            self.num_dropped += 1
            return
        self._buf.append(v)

    def predict(self) -> Optional[float]:
        if not self._buf:
            return None
        y = np.asarray(self._buf, np.float64)
        p = self.order
        if len(y) < 2 * p + 1:
            return float(y.mean())
        # rows: y[t] ~ [1, y[t-1], ..., y[t-p]]
        X = np.stack(
            [np.ones(len(y) - p)]
            + [y[p - j - 1: len(y) - j - 1] for j in range(p)],
            axis=1,
        )
        coef, *_ = np.linalg.lstsq(X, y[p:], rcond=None)
        nxt = coef[0] + float(coef[1:] @ y[-1: -p - 1: -1])
        if not math.isfinite(nxt):
            return float(y.mean())
        # a degenerate fit must not drive scaling negative
        return max(0.0, float(nxt))
