"""Waste-driven adaptive bucket ladders.

A copy of ``dynamo_tpu.engine.ladder`` (pure host bookkeeping). In this
package a new rung costs, on a card, one CUDA graph capture per sampling
mode (greedy, stochastic) and window kind that meets it, made at the
rung's first call (``engine/model.py`` ``AutopilotWindow`` for a decode
rung, ``PrefillGraphs`` for a prefill rung) and counted by
``observability/compilewatch.py``; on the CPU a new decode rung's first
call is counted, and a prefill rung costs nothing (its chunks run
eagerly). One change from the copy: a split or retire
binds a new rung list instead of editing the old one in place, because here
the ladder adapts on the fetch thread while the device-step thread and the
scheduler read the grid.

Static ``decode_buckets``/``prefill_buckets`` trade recompiles for padding:
every dispatch pads its batch (rows) or chunk (tokens) up to the nearest
bucket, and the flight recorder books the pad as ``padding_waste_ratio`` —
pure MFU loss.  A :class:`BucketLadder` closes that loop: it consumes the
recorder's live per-(kind, bucket) occupancy histogram
(``StepStats.bucket_occupancy()``) and, at adaptation epochs,

- **splits** the rung wasting the most padded work (inserting a new rung
  at the observed mean fill, rounded to ``step``), and
- **retires** rungs that have gone cold (dispatch share below
  ``retire_share`` for ``hysteresis`` consecutive epochs),

under an explicit **compile budget**: each added rung costs the new
programs that consume it (in the JAX package, one steady-state XLA trace
per jit family, which the compile watchdog attributes by label), and the
ladder will never add more than
``compile_budget`` rungs over its lifetime.  Hysteresis applies on both
edges — a just-added rung cannot be retired, and a just-retired value
cannot be re-added, for ``hysteresis`` epochs — so the grid converges and
``compilewatch.assert_no_recompiles`` holds once it has.

The ladder is pure host bookkeeping over host ints (never touches device
state), deterministic given an occupancy trace, and disabled by default
(``EngineConfig.adaptive_buckets`` / ``DYNTPU_LADDER_ENABLED``).

Env knobs (all ``DYNTPU_LADDER_*``) override the constructor defaults:
``ENABLED``, ``COMPILE_BUDGET``, ``SPLIT_WASTE``, ``RETIRE_SHARE``,
``MIN_DISPATCHES``, ``HYSTERESIS``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.config import env_float, env_int
from ..utils.logging import get_logger

log = get_logger("ladder")

ENV_PREFIX = "DYNTPU_LADDER_"


class BucketLadder:
    """Adaptive bucket grid for one dispatch kind (decode or prefill).

    ``kinds`` lists the StepRecord kinds whose occupancy feeds this ladder
    (decode consumes both ``decode`` and ``spec_verify`` windows).  The
    largest base rung is permanent — it is the capacity guarantee that
    every batch/chunk has a bucket to land in.
    """

    def __init__(
        self,
        kind: str,
        base_buckets: Sequence[int],
        *,
        kinds: Optional[Sequence[str]] = None,
        compile_budget: int = 4,
        split_waste: float = 0.25,
        retire_share: float = 0.02,
        min_dispatches: int = 64,
        hysteresis: int = 2,
        step: int = 8,
    ):
        self.kind = kind
        self.kinds = tuple(kinds or (kind,))
        self._base = tuple(sorted(set(int(b) for b in base_buckets)))
        if not self._base:
            raise ValueError("need at least one base bucket")
        self._rungs: List[int] = list(self._base)
        self.compile_budget = env_int(
            ENV_PREFIX + "COMPILE_BUDGET", compile_budget)
        self.split_waste = env_float(
            ENV_PREFIX + "SPLIT_WASTE", split_waste)
        self.retire_share = env_float(
            ENV_PREFIX + "RETIRE_SHARE", retire_share)
        self.min_dispatches = env_int(
            ENV_PREFIX + "MIN_DISPATCHES", min_dispatches)
        self.hysteresis = max(1, env_int(
            ENV_PREFIX + "HYSTERESIS", hysteresis))
        self.step = max(1, step)
        self._epoch = 0
        self._splits_total = 0
        self._retires_total = 0
        self._last_event_epoch = -1
        # rung -> epoch it was added / value -> epoch it was retired
        self._added_epoch: Dict[int, int] = {}
        self._retired_epoch: Dict[int, int] = {}
        # rung -> consecutive cold epochs (resets when it sees traffic)
        self._cold_epochs: Dict[int, int] = {}
        # recorder cumulative histogram high-water (per histogram key)
        self._seen: Dict[str, Tuple[int, int, int]] = {}
        # current epoch accumulation: rung -> [dispatches, real, padded]
        self._acc: Dict[int, List[int]] = {}
        self._events: List[dict] = []

    # -- grid queries (the engine's bucketing calls) --

    def buckets(self) -> Tuple[int, ...]:
        return tuple(self._rungs)

    def bucket_for(self, n: int) -> int:
        """First rung >= n, else the largest (mirror of engine._bucket)."""
        for b in self._rungs:
            if n <= b:
                return b
        return self._rungs[-1]

    def rung_at_most(self, cap: int) -> Optional[int]:
        """Largest rung <= cap (the scheduler's chunk-cap snap), or None."""
        best = None
        for b in self._rungs:
            if b <= cap:
                best = b
        return best

    # -- occupancy intake --

    def observe(self, bucket: int, real: int, padded: int,
                count: int = 1) -> None:
        """Direct accumulation (tests / recorder-less callers)."""
        acc = self._acc.setdefault(int(bucket), [0, 0, 0])
        acc[0] += count
        acc[1] += int(real)
        acc[2] += int(padded)

    def ingest(self, occupancy: Dict[str, Sequence[int]]) -> None:
        """Fold the recorder's cumulative per-(kind, bucket) histogram in.

        Keys are ``"kind:bucket"`` -> ``(dispatches, real, padded)``
        cumulative since warmup; this takes deltas against the last call.
        A counter that went backwards means the recorder's window was
        reset (``mark_warmup_done``) — re-baseline and skip one cycle.
        """
        for key, vals in occupancy.items():
            kind, _, b = key.partition(":")
            if kind not in self.kinds:
                continue
            n, real, padded = (int(v) for v in vals)
            prev = self._seen.get(key, (0, 0, 0))
            self._seen[key] = (n, real, padded)
            dn, dr, dp = n - prev[0], real - prev[1], padded - prev[2]
            if dn <= 0 or dr < 0 or dp < 0:
                continue
            self.observe(int(b), dr, dp, count=dn)

    # -- adaptation --

    def _try_split(self, stats: Dict[int, List[int]]) -> Optional[dict]:
        if self._splits_total >= self.compile_budget:
            return None
        # rank by absolute padded waste (padded - real units): the rung
        # burning the most FLOPs on pad is the one worth a new program
        ranked = sorted(
            ((p - r, b) for b, (n, r, p) in stats.items() if p > 0),
            reverse=True,
        )
        for waste_units, b in ranked:
            n, real, padded = stats[b]
            waste = 1.0 - real / padded
            if waste <= self.split_waste:
                continue
            if b not in self._rungs:
                continue  # rung already retired under us
            lower = max((x for x in self._rungs if x < b), default=0)
            mean_real = real / n
            mid = -(-int(mean_real) // self.step) * self.step
            mid = max(mid, self.step)
            if not (lower < mid < b):
                continue  # nothing to gain between the neighbours
            cooled = self._retired_epoch.get(mid)
            if cooled is not None and \
                    self._epoch - cooled < self.hysteresis:
                continue  # value was just retired — don't flap it back
            self._rungs = sorted(self._rungs + [mid])
            self._splits_total += 1
            self._added_epoch[mid] = self._epoch
            return {
                "op": "split", "kind": self.kind, "epoch": self._epoch,
                "rung": b, "new": mid, "waste": round(waste, 4),
                "budget_remaining":
                    self.compile_budget - self._splits_total,
            }
        return None

    def _try_retire(self, stats: Dict[int, List[int]],
                    total_n: int) -> Optional[dict]:
        # update cold streaks for every current rung
        for b in self._rungs:
            share = stats.get(b, [0, 0, 0])[0] / max(total_n, 1)
            if share < self.retire_share:
                self._cold_epochs[b] = self._cold_epochs.get(b, 0) + 1
            else:
                self._cold_epochs[b] = 0
        for b in sorted(self._rungs):
            if b == self._rungs[-1]:
                continue  # the capacity rung is permanent
            if self._cold_epochs.get(b, 0) < self.hysteresis:
                continue
            added = self._added_epoch.get(b)
            if added is not None and \
                    self._epoch - added < self.hysteresis:
                continue  # just added — give it hysteresis epochs to warm
            self._rungs = [x for x in self._rungs if x != b]
            self._retires_total += 1
            self._retired_epoch[b] = self._epoch
            self._cold_epochs.pop(b, None)
            return {
                "op": "retire", "kind": self.kind, "epoch": self._epoch,
                "rung": b,
            }
        return None

    def maybe_adapt(self) -> List[dict]:
        """One adaptation epoch: at most one split and one retire.

        Below ``min_dispatches`` of accumulated evidence this is a no-op
        (the epoch keeps accumulating).  Deterministic: same occupancy
        trace, same decisions.
        """
        total_n = sum(a[0] for a in self._acc.values())
        if total_n < self.min_dispatches:
            return []
        stats = {b: list(a) for b, a in self._acc.items()}
        events = []
        ev = self._try_split(stats)
        if ev:
            events.append(ev)
        ev = self._try_retire(stats, total_n)
        if ev:
            events.append(ev)
        for ev in events:
            self._events.append(ev)
            self._last_event_epoch = self._epoch
            log.info("bucket ladder %s: %s", self.kind, ev)
        self._acc.clear()
        self._epoch += 1
        return events

    # -- reporting --

    @property
    def converged(self) -> bool:
        """No event for ``hysteresis`` epochs and no split budget pressure.

        Once True under a stationary workload the grid is final: further
        ``maybe_adapt`` calls on the same distribution make no changes,
        so ``assert_no_recompiles`` holds across them.
        """
        return self._epoch - self._last_event_epoch > self.hysteresis

    def snapshot(self) -> dict:
        return {
            "rungs": tuple(self._rungs),
            "base": self._base,
            "splits_total": self._splits_total,
            "retires_total": self._retires_total,
            "compile_budget": self.compile_budget,
            "budget_remaining": self.compile_budget - self._splits_total,
            "epoch": self._epoch,
            "converged": self.converged,
        }
