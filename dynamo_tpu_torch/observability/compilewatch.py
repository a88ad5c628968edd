"""Steady-state program watch: counts what makes a new program after warm-up.

The twin of ``dynamo_tpu.observability.compilewatch``. The JAX package
counts XLA backend compiles per jitted function through
``jax.monitoring``; PyTorch runs eagerly and has no such event stream. What
makes a new program in this package is:

- a **decode or spec graph capture** (``engine/model.py``
  ``AutopilotWindow._capture``), keyed by the window's ``last_key``
  (``"decode_window:B=8:stochastic=0"``). On the CPU, where windows run
  eagerly, the first call of a key counts in a capture's place, so the CPU
  tests see the keys a card would capture;
- a **prefill graph capture** on a card (``engine/model.py``
  ``PrefillGraphs._capture``), keyed ``"prefill:<T>:greedy"`` or
  ``"prefill:<T>:stochastic"``; on the CPU prefill chunks run eagerly and
  count nothing;
- an **einsum rebuild** of the decode window by the stall watchdog
  (``engine/engine.py`` ``_quarantine_shape``), keyed
  ``"decode_window:einsum_rebuild"``.

Each is counted per key, in total and (after :func:`mark_warmup_done`) in
steady state, with the seconds it took. The snapshot keeps the JAX package's
keys. XLA's ``[SPMD] Involuntary full rematerialization`` warnings have no
counterpart here: the remat counters stay at 0 and there is no
``scan_log_text``. ``engine_recompiles_total{fn}`` surfaces through the
worker gauges (``observability/gauges.py``).

:func:`label` keeps the JAX package's attribution seam: a program noted
without a key inside a labelled call is booked under the label.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional

UNATTRIBUTED = "<unattributed>"


class CompileWatch:
    """Process-wide program counters (one per process, as in the JAX
    package; tests drive the singleton through :meth:`reset`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._steady = False
        self.compiles_total: Dict[str, int] = {}
        self.compiles_steady: Dict[str, int] = {}
        self.compile_secs: Dict[str, float] = {}

    def note(self, key: Optional[str] = None, secs: float = 0.0) -> None:
        """Count one new program under ``key`` (else the caller's label)."""
        fn = key or getattr(self._tls, "label", None) or UNATTRIBUTED
        with self._lock:
            self.compiles_total[fn] = self.compiles_total.get(fn, 0) + 1
            self.compile_secs[fn] = self.compile_secs.get(fn, 0.0) + secs
            if self._steady:
                self.compiles_steady[fn] = self.compiles_steady.get(fn, 0) + 1

    def label(self, fn, name: str):
        """Wrap a callable so programs noted during its calls without a key
        attribute to ``name``. Nesting-safe (inner label wins)."""
        tls = self._tls

        def labelled(*args, **kwargs):
            prev = getattr(tls, "label", None)
            tls.label = name
            try:
                return fn(*args, **kwargs)
            finally:
                tls.label = prev

        labelled.__wrapped__ = fn
        labelled.__compile_label__ = name
        return labelled

    def mark_warmup_done(self) -> None:
        """Enter steady state: programs from here on are *recompiles*."""
        with self._lock:
            self._steady = True
            self.compiles_steady = {}

    def reset(self) -> None:
        """Back to warm-up with zeroed counters (test isolation)."""
        with self._lock:
            self._steady = False
            self.compiles_total = {}
            self.compiles_steady = {}
            self.compile_secs = {}

    def steady_by_label(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.compiles_steady)

    def steady_total(self) -> int:
        with self._lock:
            return sum(self.compiles_steady.values())

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "recompiles_steady_state": sum(self.compiles_steady.values()),
                "recompiles_by_fn": dict(self.compiles_steady),
                "compiles_total": sum(self.compiles_total.values()),
                "compiles_by_fn": dict(self.compiles_total),
                "compile_secs_by_fn": dict(self.compile_secs),
                "involuntary_remats_total": 0,
                "involuntary_remats_steady": 0,
                "steady": self._steady,
            }


_watch = CompileWatch()


def get_watch() -> CompileWatch:
    return _watch


def note(key: Optional[str] = None, secs: float = 0.0) -> None:
    _watch.note(key, secs)


def label(fn, name: str):
    return _watch.label(fn, name)


def mark_warmup_done() -> None:
    _watch.mark_warmup_done()


def snapshot() -> dict:
    return _watch.snapshot()


def steady_total() -> int:
    return _watch.steady_total()


def steady_by_label() -> Dict[str, int]:
    return _watch.steady_by_label()


@contextmanager
def assert_no_recompiles(allow: int = 0):
    """Fail if more than ``allow`` steady-state programs (any key) are made
    inside the block. Enters steady state if not already."""
    if not _watch.snapshot()["steady"]:
        _watch.mark_warmup_done()
    before = _watch.steady_by_label()
    yield _watch
    after = _watch.steady_by_label()
    delta = {
        k: after.get(k, 0) - before.get(k, 0)
        for k in set(before) | set(after)
        if after.get(k, 0) != before.get(k, 0)
    }
    total = sum(delta.values())
    if total > allow:
        raise AssertionError(
            f"unexpected steady-state graph captures: {delta!r} "
            f"({total} > allowed {allow})"
        )
