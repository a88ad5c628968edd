"""Deterministic fault injection for resilience tests.

A copy of ``dynamo_tpu.runtime.faults``: the store and the transport of
this package consult the same plans at the same sites, and so does the
engine's stall watchdog at ``engine.stall`` (the disagg and preemption
sites wait for those slices).

A seeded :class:`FaultPlan` describes *where* (a named hook site), *when*
(after the Nth pass, for M firings, or with a seeded probability) and *what*
(drop the connection, delay a frame, truncate the stream, reject with an
error code) goes wrong. Transport and store hook points consult the
installed plan on every pass; with no plan installed the checks are a single
``None`` comparison, so production paths pay nothing.

Sites wired in this repo (the ``key`` each site passes):

==========================  =============================================
site                        key
==========================  =============================================
``client.connect``          worker ``host:port`` the router dials
``client.send``             worker ``host:port`` a request is pushed to
``worker.admit``            request id arriving at the ingress server
``worker.stream``           request id, checked before each data frame
``store.call``              store op name (``put``, ``publish``, …)
``store.connect``           store ``host:port`` being (re)dialled
``store.watch``             watched key prefix at (re)subscribe time
``disagg.prefill``          request id, at remote-prefill execution start
``disagg.transfer``         request id, per KV push attempt (device or
                            relay; ``truncate`` corrupts the relay frame)
``disagg.inject``           request id arriving at the kv_inject ingress
``preempt.notice``          worker id receiving a maintenance notice
                            (``drop`` = the notice is lost: no evacuation,
                            the kill lands cold)
``preempt.evacuate``        seat id being evacuated (``drop`` = the seat's
                            handoff fails and it falls back to re-prefill;
                            ``delay`` = slow evacuation against the
                            deadline)
``engine.stall``            ``kind:window_id`` of the window about to be
                            dispatched — kind is ``decode``/``prefill``/
                            ``mixed`` (``delay`` = the window wedges on
                            device for ``delay_s``, exercising the stall
                            watchdog; match ``decode`` to wedge a window
                            whose deadline the delay reliably exceeds)
==========================  =============================================

Kinds and how sites interpret them:

- ``drop``      — fail the operation as a connection error (retryable
  ``ERR_UNAVAILABLE`` on the transport, ``StoreError`` on the store).
- ``reject``    — refuse with ``code`` (default ``ERR_OVERLOADED``).
- ``delay``     — ``await asyncio.sleep(delay_s)`` then proceed (slow
  worker / slow store).
- ``truncate``  — worker-side only: abruptly close the response connection
  mid-stream, exactly what a crashing worker looks like to the router.

Determinism: each rule fires on its own per-rule pass counter
(``after`` ≤ pass-index < ``after + times``), and probabilistic rules draw
from the plan's seeded RNG — identical call order ⇒ identical faults.

Usage in tests::

    plan = FaultPlan(seed=0)
    plan.truncate_stream("worker.stream", after=3)   # crash on the 4th frame
    install(plan)
    try:
        ...drive the stack...
    finally:
        clear()

Wire serialization: :meth:`FaultPlan.to_json` / :meth:`FaultPlan.from_json`
round-trip a plan (schema version ``SCHEMA_VERSION``) including its seed,
rule state (``seen``/``fired``) and the number of RNG draws consumed, so a
deserialized plan fires *identically* to the original under the same
subsequent call order — the property that lets a replay trace ship the same
fault schedule to the in-process SimCluster and, via the system server's
``/debug/faults`` endpoint, to live worker processes.

Rules may carry a ``wave`` tag (the replay event track's correlated
fault-wave name); :meth:`FaultPlan.clear_wave` retires one wave's rules
without disturbing the rest, and every :class:`FaultEvent` records the wave
of the rule that fired so post-hoc attribution can group firings per wave.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from random import Random
from typing import Dict, List, Optional, Union

DROP = "drop"
REJECT = "reject"
DELAY = "delay"
TRUNCATE = "truncate"
KINDS = (DROP, REJECT, DELAY, TRUNCATE)

# wire-format version for FaultPlan.to_json/from_json; bump on any change
# that an older reader would misinterpret
SCHEMA_VERSION = 1


@dataclass
class FaultRule:
    site: str
    kind: str
    match: Optional[str] = None    # substring of the site key; None = any
    after: int = 0                 # matching passes to let through first
    times: Optional[int] = None    # firings before the rule burns out (None = forever)
    delay_s: float = 0.0
    code: str = "overloaded"       # reject code (transport error code)
    prob: float = 1.0              # per-pass firing probability (plan RNG)
    wave: Optional[str] = None     # replay fault-wave tag (attribution group)
    seen: int = field(default=0, compare=False)   # matching passes observed
    fired: int = field(default=0, compare=False)  # times actually fired

    def to_dict(self) -> dict:
        return {
            "site": self.site, "kind": self.kind, "match": self.match,
            "after": self.after, "times": self.times,
            "delay_s": self.delay_s, "code": self.code, "prob": self.prob,
            "wave": self.wave, "seen": self.seen, "fired": self.fired,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        if d.get("kind") not in KINDS:
            raise ValueError(f"unknown fault kind: {d.get('kind')!r}")
        rule = cls(
            site=d["site"], kind=d["kind"], match=d.get("match"),
            after=int(d.get("after", 0)),
            times=None if d.get("times") is None else int(d["times"]),
            delay_s=float(d.get("delay_s", 0.0)),
            code=d.get("code", "overloaded"),
            prob=float(d.get("prob", 1.0)),
            wave=d.get("wave"),
        )
        rule.seen = int(d.get("seen", 0))
        rule.fired = int(d.get("fired", 0))
        return rule


@dataclass
class FaultEvent:
    """One firing, recorded on the plan for post-hoc assertions."""

    site: str
    key: str
    kind: str
    wave: Optional[str] = None


class FaultPlan:
    """A seeded set of fault rules plus a log of every firing."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = Random(seed)
        self.rules: List[FaultRule] = []
        self.log: List[FaultEvent] = []
        self._draws = 0  # seeded-RNG draws consumed (serialized for replay)

    # -- builders --

    def add(self, rule: FaultRule) -> "FaultPlan":
        self.rules.append(rule)
        return self

    def drop_connection(self, site: str, match: Optional[str] = None,
                        after: int = 0, times: Optional[int] = None,
                        prob: float = 1.0, wave: Optional[str] = None
                        ) -> "FaultPlan":
        return self.add(FaultRule(site, DROP, match, after, times, prob=prob,
                                  wave=wave))

    def reject(self, site: str, match: Optional[str] = None,
               after: int = 0, times: Optional[int] = None,
               code: str = "overloaded", wave: Optional[str] = None
               ) -> "FaultPlan":
        return self.add(FaultRule(site, REJECT, match, after, times, code=code,
                                  wave=wave))

    def delay(self, site: str, delay_s: float, match: Optional[str] = None,
              after: int = 0, times: Optional[int] = None,
              wave: Optional[str] = None) -> "FaultPlan":
        return self.add(FaultRule(site, DELAY, match, after, times,
                                  delay_s=delay_s, wave=wave))

    def truncate_stream(self, site: str = "worker.stream",
                        match: Optional[str] = None, after: int = 0,
                        times: Optional[int] = 1,
                        wave: Optional[str] = None) -> "FaultPlan":
        return self.add(FaultRule(site, TRUNCATE, match, after, times,
                                  wave=wave))

    # -- evaluation --

    def check(self, site: str, key: str = "") -> Optional[FaultRule]:
        """First rule that fires at this (site, key) pass, advancing the
        per-rule pass counters. At most one rule fires per pass."""
        for rule in self.rules:
            if rule.site != site:
                continue
            if rule.match is not None and rule.match not in key:
                continue
            idx = rule.seen
            rule.seen += 1
            if idx < rule.after:
                continue
            if rule.times is not None and rule.fired >= rule.times:
                continue
            if rule.prob < 1.0:
                self._draws += 1
                if self.rng.random() >= rule.prob:
                    continue
            rule.fired += 1
            self.log.append(FaultEvent(site, key, rule.kind, wave=rule.wave))
            return rule
        return None

    def fired(self, site: Optional[str] = None) -> int:
        return sum(1 for e in self.log if site is None or e.site == site)

    def fired_counts(self) -> Dict[str, int]:
        """Firing counts keyed ``site/kind`` — the cross-mode parity unit
        (SimCluster vs live-HTTP replays must agree on these counts)."""
        counts: Dict[str, int] = {}
        for e in self.log:
            k = f"{e.site}/{e.kind}"
            counts[k] = counts.get(k, 0) + 1
        return counts

    # -- wave lifecycle --

    def clear_wave(self, wave: str) -> int:
        """Retire the rules of one fault wave (the firing log is kept for
        attribution). Returns the number of rules removed."""
        before = len(self.rules)
        self.rules = [r for r in self.rules if r.wave != wave]
        return before - len(self.rules)

    # -- wire serialization --

    def to_dict(self, include_log: bool = False) -> dict:
        d = {
            "schema": SCHEMA_VERSION,
            "seed": self.seed,
            "draws": self._draws,
            "rules": [r.to_dict() for r in self.rules],
        }
        if include_log:
            d["log"] = [
                {"site": e.site, "key": e.key, "kind": e.kind, "wave": e.wave}
                for e in self.log
            ]
        return d

    def to_json(self, include_log: bool = False) -> str:
        return json.dumps(self.to_dict(include_log=include_log),
                          sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        schema = d.get("schema")
        if schema != SCHEMA_VERSION:
            raise ValueError(
                f"unsupported FaultPlan schema {schema!r} "
                f"(this reader speaks {SCHEMA_VERSION})")
        plan = cls(seed=int(d.get("seed", 0)))
        # burn the draws the original already consumed so the deserialized
        # plan continues the exact same random sequence
        for _ in range(int(d.get("draws", 0))):
            plan.rng.random()
        plan._draws = int(d.get("draws", 0))
        for rd in d.get("rules", []):
            plan.add(FaultRule.from_dict(rd))
        for ed in d.get("log", []):
            plan.log.append(FaultEvent(ed["site"], ed.get("key", ""),
                                       ed["kind"], wave=ed.get("wave")))
        return plan

    @classmethod
    def from_json(cls, data: Union[str, bytes]) -> "FaultPlan":
        return cls.from_dict(json.loads(data))


# The active plan is process-global: the test harness owns the whole stack
# (frontend, router, workers) in one process, so a single installation
# covers every layer.
_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> None:
    global _PLAN
    _PLAN = plan


def clear() -> None:
    global _PLAN
    _PLAN = None


def current() -> Optional[FaultPlan]:
    """The installed plan, if any (introspection: /debug/faults, snapshots)."""
    return _PLAN


def active(site: str, key: str = "") -> Optional[FaultRule]:
    """Hook-site entry point: None when no plan is installed (fast path)."""
    if _PLAN is None:
        return None
    return _PLAN.check(site, key)


async def maybe_delay(rule: Optional[FaultRule]) -> Optional[FaultRule]:
    """Apply a delay rule in place (returns the rule for further handling)."""
    if rule is not None and rule.kind == DELAY and rule.delay_s > 0:
        await asyncio.sleep(rule.delay_s)
    return rule
