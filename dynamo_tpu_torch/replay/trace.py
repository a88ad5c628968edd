"""Trace model + seeded generators for the replay scoreboard.

A *trace* is the full, deterministic description of one serving workload:

- a list of :class:`TraceRequest` — arrival timestamp, tenant, shared-prefix
  pool, pre-tokenized prompt (ISL), output budget (OSL), deadline tier, and
  optional client-behaviour offsets (abort-at / reconnect-at N tokens);
- an *event track* of :class:`ReplayEvent` — maintenance preemptions
  (the notice path), worker kills, store flaps — fired at scheduled
  offsets by the driver;
- ground-truth metadata: the deduplicated shared-prefix token count the
  measured prefix-hit rate is judged against.

Everything flows from one seed: the same :class:`TraceConfig` produces an
identical trace and event schedule, byte for byte. Traces round-trip
through JSONL (one ``meta`` line, then one line per request, then one line
per event) so a captured production trace can be replayed the same way a
generated one is.

Generators are built on :mod:`.datagen` (the port's copy of
``benchmarks.datagen``'s prefix generator): per-tenant prefix trees give
multi-tenant shared-prefix pools, and arrivals are a non-homogeneous
Poisson process over a diurnal/bursty rate curve (the mocker's arrival
model, reused).

A copy of ``dynamo_tpu.replay.trace``: the same config and seed give the
same trace, byte for byte in JSONL.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

from ..runtime import faults
from .datagen import (
    PrefixDatasetConfig, generate_prefix_dataset, prefix_ground_truth,
)

# The fault-site vocabulary the replay event track can express. Pinned by
# tests/test_faults_registry.py against the faults.py docstring table and
# the faults.active() call sites — adding a seam without replay support
# (or scheduling a fault at an unwired site) fails CI.
FAULT_SITES = (
    "client.connect",
    "client.send",
    "worker.admit",
    "worker.stream",
    "store.call",
    "store.connect",
    "store.watch",
    "disagg.prefill",
    "disagg.transfer",
    "disagg.inject",
    "preempt.notice",
    "preempt.evacuate",
    "engine.stall",
)


@dataclass
class TierSpec:
    """One deadline tier: an assignment weight plus the SLOs the
    scoreboard scores the tier's requests against."""

    tier: int
    weight: float
    ttft_slo_s: float
    itl_slo_s: float


@dataclass
class TraceRequest:
    """One replayed request. ``pool`` identifies the shared-prefix pool
    (tenant-local group id; -1 = unique long-context outlier)."""

    request_id: str
    arrival_s: float
    tenant: str
    pool: int
    token_ids: List[int]
    osl: int
    tier: int
    abort_after_tokens: Optional[int] = None
    reconnect_after_tokens: Optional[int] = None

    @property
    def isl(self) -> int:
        return len(self.token_ids)


@dataclass
class ReplayEvent:
    """One scheduled infrastructure event. Kinds the driver understands:
    ``preempt`` (maintenance notice → evacuation on a decode worker, then
    optionally kill it), ``kill_worker`` (abrupt crash, no notice),
    ``store_flap`` (stop the store, restart it from its snapshot),
    ``fault`` (install one correlated fault wave — a list of ``faults.py``
    rule dicts tagged with the wave name; ``worker_index`` addresses
    worker-scoped sites), ``fault_clear`` (retire one wave's rules).

    Worker-scoped events carry ``worker_index``, an abstract seeded index
    the driver maps onto the sorted worker list (``index % n_workers``) —
    the same arithmetic in SimCluster and live-HTTP modes, so both pick
    identical victims under the same seed."""

    at_s: float
    kind: str
    params: Dict[str, object] = field(default_factory=dict)


@dataclass
class FaultWaveSpec:
    """One correlated fault wave in a :class:`TraceConfig`: a named bundle
    of fault-rule dicts installed together at ``at_frac`` of the trace
    clock (and retired at ``clear_frac``, if set). Rule dicts use the
    :class:`dynamo_tpu_torch.runtime.faults.FaultRule` field names;
    ``site`` must be in :data:`FAULT_SITES` and ``kind`` one of
    ``faults.KINDS``."""

    name: str
    at_frac: float
    rules: Tuple[Dict[str, object], ...] = ()
    clear_frac: Optional[float] = None


@dataclass
class ReplayTrace:
    requests: List[TraceRequest]
    events: List[ReplayEvent]
    meta: Dict[str, object]

    @property
    def duration_s(self) -> float:
        return float(self.meta.get("duration_s", 0.0))

    @property
    def seed(self) -> int:
        return int(self.meta.get("seed", 0))

    def tiers(self) -> List[TierSpec]:
        return [TierSpec(**t) for t in self.meta.get("tiers", [])]


@dataclass
class TraceConfig:
    """Seeded generator knobs. Defaults describe a small CPU-friendly
    bursty multi-tenant scenario; scale ``num_requests`` / ``duration_s``
    / ``base_rps`` up for flagship runs."""

    seed: int = 0
    num_requests: int = 48
    duration_s: float = 6.0
    # arrival curve: base rate modulated by a diurnal sinusoid and a
    # mid-run burst window (burst_factor=1 disables the burst)
    base_rps: float = 12.0
    burst_factor: float = 3.0
    burst_start_frac: float = 0.25
    burst_end_frac: float = 0.6
    diurnal_amplitude: float = 0.2
    diurnal_period_s: float = 4.0
    # multi-tenant shared-prefix pools (per-tenant datagen prefix trees)
    tenants: int = 2
    pools_per_tenant: int = 2
    branches: int = 2
    isl: int = 24
    osl: int = 6
    prefix_ratio: float = 0.5
    vocab_size: int = 200
    vocab_offset: int = 2
    # deadline tiers (weights re-normalized at draw time)
    tiers: Tuple[TierSpec, ...] = (
        TierSpec(tier=0, weight=0.6, ttft_slo_s=2.0, itl_slo_s=0.5),
        TierSpec(tier=1, weight=0.4, ttft_slo_s=6.0, itl_slo_s=1.5),
    )
    # long-context ISL outliers: unique prompts (no pool) of outlier_isl
    outlier_ratio: float = 0.0
    outlier_isl: int = 96
    # abort storm: arrivals inside the window abort after N tokens w.p.
    abort_storm_start_frac: float = 0.0
    abort_storm_end_frac: float = 0.0
    abort_prob: float = 0.5
    abort_after_tokens: int = 2
    # reconnect storm: same shape, client drops and re-issues w/ history
    reconnect_storm_start_frac: float = 0.0
    reconnect_storm_end_frac: float = 0.0
    reconnect_prob: float = 0.5
    reconnect_after_tokens: int = 2
    # event track (fractions of duration_s; None = event disabled)
    preempt_at_frac: Optional[float] = None
    preempt_kill: bool = False
    kill_at_frac: Optional[float] = None
    store_flap_at_frac: Optional[float] = None
    store_flap_down_s: float = 0.2
    # correlated fault waves (seeded faults.py schedules on the event track)
    fault_waves: Tuple[FaultWaveSpec, ...] = ()


def _rate(cfg: TraceConfig, t: float) -> float:
    burst = (cfg.burst_factor
             if (cfg.burst_start_frac * cfg.duration_s <= t
                 < cfg.burst_end_frac * cfg.duration_s)
             else 1.0)
    diurnal = 1.0 + cfg.diurnal_amplitude * math.sin(
        2 * math.pi * t / cfg.diurnal_period_s)
    return cfg.base_rps * burst * diurnal


def _arrivals(rng: random.Random, cfg: TraceConfig) -> List[float]:
    """Non-homogeneous Poisson over the diurnal/burst rate curve, capped
    at ``num_requests`` (re-sweeping the curve if the duration undershoots
    the request budget, so the trace always has exactly num_requests)."""
    out: List[float] = []
    t = 0.0
    while len(out) < cfg.num_requests:
        t += rng.expovariate(max(_rate(cfg, t % cfg.duration_s), 1e-6))
        out.append(t)
    return out


def _in_window(t: float, cfg: TraceConfig, start_frac: float,
               end_frac: float) -> bool:
    return (start_frac * cfg.duration_s <= t < end_frac * cfg.duration_s
            and end_frac > start_frac)


def generate_trace(cfg: TraceConfig) -> ReplayTrace:
    """Deterministic trace from one seed: per-tenant prefix pools, tiered
    Poisson arrivals, outliers, abort/reconnect storms, event track."""
    rng = random.Random(cfg.seed)

    # per-tenant prefix trees: distinct seeds ⇒ distinct pools, so cross-
    # tenant prompts share nothing (the isolation the router should see)
    datasets = {}
    cursors = {}
    for t in range(cfg.tenants):
        datasets[t] = generate_prefix_dataset(PrefixDatasetConfig(
            num_requests=cfg.num_requests,   # upper bound per tenant
            isl=cfg.isl, prefix_ratio=cfg.prefix_ratio,
            groups=cfg.pools_per_tenant, branches=cfg.branches,
            vocab_size=cfg.vocab_size, vocab_offset=cfg.vocab_offset,
            seed=cfg.seed * 1009 + t + 1,
        ))
        cursors[t] = 0

    used: Dict[int, list] = {t: [] for t in range(cfg.tenants)}
    tier_ids = [t.tier for t in cfg.tiers]
    tier_weights = [t.weight for t in cfg.tiers]

    requests: List[TraceRequest] = []
    for i, at in enumerate(_arrivals(rng, cfg)):
        tenant = rng.randrange(cfg.tenants)
        tier = rng.choices(tier_ids, weights=tier_weights)[0]
        if cfg.outlier_ratio > 0 and rng.random() < cfg.outlier_ratio:
            # long-context outlier: unique prompt, no shared pool
            prompt = [rng.randrange(cfg.vocab_offset,
                                    cfg.vocab_offset + cfg.vocab_size)
                      for _ in range(cfg.outlier_isl)]
            pool = -1
        else:
            gen = datasets[tenant][cursors[tenant] % len(datasets[tenant])]
            cursors[tenant] += 1
            used[tenant].append(gen)
            prompt = list(gen.token_ids)
            pool = gen.group
        abort_after = (
            cfg.abort_after_tokens
            if (_in_window(at, cfg, cfg.abort_storm_start_frac,
                           cfg.abort_storm_end_frac)
                and rng.random() < cfg.abort_prob)
            else None)
        reconnect_after = (
            cfg.reconnect_after_tokens
            if (abort_after is None
                and _in_window(at, cfg, cfg.reconnect_storm_start_frac,
                               cfg.reconnect_storm_end_frac)
                and rng.random() < cfg.reconnect_prob)
            else None)
        requests.append(TraceRequest(
            request_id=f"replay{cfg.seed}-{i}",
            arrival_s=round(at, 6),
            tenant=f"tenant{tenant}",
            pool=pool,
            token_ids=prompt,
            osl=cfg.osl,
            tier=tier,
            abort_after_tokens=abort_after,
            reconnect_after_tokens=reconnect_after,
        ))

    # Event-track worker targeting: every worker-scoped event draws one
    # abstract index from the trace RNG (drawn AFTER the request loop, so
    # enabling events never perturbs the request stream). The driver maps
    # ``worker_index % n_workers`` onto its sorted worker list — identical
    # victim selection in SimCluster and live-HTTP modes.
    events: List[ReplayEvent] = []
    if cfg.preempt_at_frac is not None:
        events.append(ReplayEvent(
            at_s=round(cfg.preempt_at_frac * cfg.duration_s, 6),
            kind="preempt",
            params={"reason": "maintenance", "kill": cfg.preempt_kill,
                    "worker_index": rng.randrange(1 << 16)},
        ))
    if cfg.kill_at_frac is not None:
        events.append(ReplayEvent(
            at_s=round(cfg.kill_at_frac * cfg.duration_s, 6),
            kind="kill_worker",
            params={"worker_index": rng.randrange(1 << 16)},
        ))
    if cfg.store_flap_at_frac is not None:
        events.append(ReplayEvent(
            at_s=round(cfg.store_flap_at_frac * cfg.duration_s, 6),
            kind="store_flap", params={"down_s": cfg.store_flap_down_s},
        ))
    for wave in cfg.fault_waves:
        wave_rules = []
        for rule in wave.rules:
            site = rule.get("site")
            kind = rule.get("kind")
            if site not in FAULT_SITES:
                raise ValueError(
                    f"fault wave {wave.name!r}: site {site!r} is not in the "
                    f"replay site vocabulary {FAULT_SITES}")
            if kind not in faults.KINDS:
                raise ValueError(
                    f"fault wave {wave.name!r}: unknown kind {kind!r} "
                    f"(expected one of {faults.KINDS})")
            wave_rules.append({**rule, "wave": wave.name})
        events.append(ReplayEvent(
            at_s=round(wave.at_frac * cfg.duration_s, 6),
            kind="fault",
            params={"wave": wave.name, "rules": wave_rules,
                    "worker_index": rng.randrange(1 << 16)},
        ))
        if wave.clear_frac is not None:
            events.append(ReplayEvent(
                at_s=round(wave.clear_frac * cfg.duration_s, 6),
                kind="fault_clear", params={"wave": wave.name},
            ))
    events.sort(key=lambda e: e.at_s)

    # ground truth: dedup shared-prefix tokens summed per tenant (pools do
    # not alias across tenants — each tree has its own seed)
    gt = {"total_prompt_tokens": 0, "shared_tokens_total": 0,
          "shared_tokens_dedup": 0, "prefix_hit_potential_tokens": 0}
    for t in range(cfg.tenants):
        if used[t]:
            for k, v in prefix_ground_truth(used[t]).items():
                gt[k] += v
    # outlier prompts carry no shared content but are prompted tokens
    gt["total_prompt_tokens"] = sum(r.isl for r in requests)

    meta = {
        "seed": cfg.seed,
        "duration_s": max(cfg.duration_s,
                          max((r.arrival_s for r in requests), default=0.0)),
        "num_requests": len(requests),
        "tiers": [asdict(t) for t in cfg.tiers],
        "prefix_ground_truth": gt,
        # json round-trip so meta is identical before/after JSONL dump
        # (asdict keeps the tiers tuple; JSON has only lists)
        "config": json.loads(json.dumps(asdict(cfg))),
    }
    return ReplayTrace(requests=requests, events=events, meta=meta)


# --------------------------- gauntlet scenario ---------------------------


def gauntlet_config(seed: int) -> TraceConfig:
    """The chaos-replay gauntlet: four correlated fault waves spanning the
    store, relay/disagg, stall, and preemption seams, layered over bursty
    two-tier traffic with a structural store flap and a maintenance
    preemption. Every rule uses ``prob=1.0`` with finite ``times`` so the
    firing counts are exhausted identically by the in-process SimCluster
    and a live multi-process deployment under the same seed."""
    return TraceConfig(
        seed=seed, num_requests=40, duration_s=8.0, base_rps=9.0,
        burst_factor=2.0, tenants=2, pools_per_tenant=2,
        preempt_at_frac=0.62, store_flap_at_frac=0.2,
        fault_waves=(
            # lease keepalives are clock-gated (phase set at client spawn),
            # so wave install kicks the op directly — exactly ``times``
            # firings every run — and the drop pushes the victim through
            # the full recovery path (reconnect + lease + key re-assert)
            FaultWaveSpec(name="storewave", at_frac=0.15, rules=(
                {"site": "store.call", "kind": "drop",
                 "match": "lease_keepalive", "times": 2},
            )),
            FaultWaveSpec(name="relaywave", at_frac=0.3, rules=(
                {"site": "worker.stream", "kind": "truncate", "times": 1},
                {"site": "client.send", "kind": "drop", "times": 1},
                {"site": "disagg.transfer", "kind": "truncate",
                 "times": 1},
            )),
            # pinned to a pure-decode window: the watchdog deadline scales
            # with scheduled tokens, so a prefill-heavy window could out-
            # wait the wedge and the stall would fire but never be seen
            FaultWaveSpec(name="stallwave", at_frac=0.45, rules=(
                {"site": "engine.stall", "kind": "delay", "match": "decode",
                 "delay_s": 1.5, "times": 1},
            )),
            FaultWaveSpec(name="preemptwave", at_frac=0.55, rules=(
                {"site": "preempt.notice", "kind": "delay",
                 "delay_s": 0.05, "times": 1},
            )),
        ),
    )


def generate_gauntlet_trace(seed: int) -> ReplayTrace:
    """Generate the gauntlet trace and align the structural preemption's
    victim with the ``preemptwave`` fault install: live-mode replays ship
    that wave's rules to the worker addressed by the fault event, so the
    maintenance notice must land on the same process for the
    ``preempt.notice`` rule to fire there."""
    trace = generate_trace(gauntlet_config(seed))
    wave_events = {e.params.get("wave"): e for e in trace.events
                   if e.kind == "fault"}
    preempt_wave = wave_events.get("preemptwave")
    if preempt_wave is not None:
        for ev in trace.events:
            if ev.kind == "preempt":
                ev.params["worker_index"] = (
                    preempt_wave.params["worker_index"])
    return trace


# ------------------------------ JSONL I/O -------------------------------


def dump_jsonl(trace: ReplayTrace, path: str) -> None:
    with open(path, "w") as f:
        f.write(json.dumps({"meta": trace.meta}) + "\n")
        for r in trace.requests:
            f.write(json.dumps({"request": asdict(r)}) + "\n")
        for e in trace.events:
            f.write(json.dumps({"event": asdict(e)}) + "\n")


def load_jsonl(path: str) -> ReplayTrace:
    meta: Dict[str, object] = {}
    requests: List[TraceRequest] = []
    events: List[ReplayEvent] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "meta" in d:
                meta = d["meta"]
            elif "request" in d:
                requests.append(TraceRequest(**d["request"]))
            elif "event" in d:
                events.append(ReplayEvent(**d["event"]))
    requests.sort(key=lambda r: r.arrival_s)
    events.sort(key=lambda e: e.at_s)
    return ReplayTrace(requests=requests, events=events, meta=meta)
