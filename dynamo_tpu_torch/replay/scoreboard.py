"""Replay scoreboard: per-tier SLO reporting with fail-on-disagreement
cross-checks against the engine's own instrumentation.

Headline metrics (all from client-side measurement):

- per-tier TTFT/ITL p50/p99 + goodput (output tokens, tokens/s);
- per-tier SLO-violation rate against the trace's :class:`TierSpec` SLOs
  (scored over completed, non-aborted requests; aborts/preemptions are
  accounted separately, not hidden inside the violation rate);
- prefix-hit rate: scheduler prefix-cache hit tokens over the datagen
  ground-truth hit-potential tokens (a *perfect* cache scores 1.0);
- chip-seconds per 1M output tokens ($-proxy) plus the analytic roofline
  from :mod:`..observability.flops` — ideal chip-seconds for the same
  token volume at the device's peak — so the efficiency gap is explicit.

The observability teeth — each cross-check FAILS the run (``ok=False``,
non-zero CLI exit) when it disagrees beyond its declared tolerance:

- **TTFT vs spans**: for every clean request (single submission, no
  migration/evacuation/abort), client TTFT must bracket the span-assembled
  worker timeline (``worker.queue`` + ``engine.prefill`` durations for its
  trace id): the span time can never exceed client TTFT by more than
  ``ttft_span_slack_s``, and the median client-over-span overhead must
  stay under ``ttft_overhead_s``.
- **tokens vs recorder**: client-counted tokens — Σ over driver-visible
  submissions of (prompt + received) — reconciled against the summed
  recorder lifetime ``total_goodput_tokens``. The recorder may legitimately
  read *low* by two measured credits — prefix-cache hit tokens it never
  recomputed, and the prefill-sampled first token of each submission —
  (plus ``token_tol_low``) and *high* by Migration-internal replays and
  decode-ahead work of cancelled streams (bounded by ``token_tol_high``).
- **prefix vs index**: the scheduler's measured prefix-hit tokens must
  agree exactly (``prefix_index_slack_tokens``) with the radix prefix
  index's own event-fed hit accounting — disagreement means the global
  prefix cache's index drifted from the block pool and fails the run.

Robustness verdicts (the chaos-replay gauntlet):

- **token loss**: every accepted request must end completed-at-budget
  (possibly via migration/evacuation resume), client-aborted, or cleanly
  errored — anything else is silent token loss and fails the run;
- **fault attribution**: every fault the plan fired must surface in the
  observability evidence (``SITE_EVIDENCE``: migration retries, breaker
  trips, store recovery/call-error counters, preemption reports, stall
  quarantines) — chaos the stack cannot see is itself a defect;
- **per-wave recovery**: for each fault wave / structural chaos event,
  trace-clock windows until per-tier SLO compliance returns, reported per
  tier plus ``chaos_recovery_windows_p99`` / ``chaos_slo_violation_rate``
  / ``chaos_token_loss`` headline fields.

Determinism: ``outcome_digest`` hashes request-level outcomes (tokens,
abort flags, completion) — same ``REPLAY_SEED`` ⇒ same digest.

A copy of ``dynamo_tpu.replay.scoreboard``. ``percentile`` is the port's
copy (:mod:`.datagen`); the roofline reads the port's FLOPs model at the
width the replay served (``ReplayRunResult.model``, the tiny config when
unset) and the card's peak from ``observability/flops.py``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..observability.flops import FlopsModel, peak_flops
from .datagen import percentile
from .driver import ReplayRunResult, RequestOutcome
from .trace import ReplayTrace, TierSpec


@dataclass
class CheckTolerances:
    """Declared cross-check tolerances (echoed into the report)."""

    # TTFT check: span timeline may exceed client TTFT by at most this
    # (clock-read ordering slack), and the median client-over-span
    # transport/routing overhead must stay under ttft_overhead_s
    ttft_span_slack_s: float = 0.075
    ttft_overhead_s: float = 0.5
    min_ttft_samples: int = 1
    # token check: recorder vs client tolerance band (fractions of the
    # client-expected count, after crediting prefix-cache hit tokens)
    token_tol_low: float = 0.05
    token_tol_high: float = 0.75
    # prefix_vs_index: the scheduler's measured hit tokens and the radix
    # index's own event-fed hit accounting count the same admissions at
    # the same site — any divergence is index drift, so the default
    # tolerance is exact agreement
    prefix_index_slack_tokens: float = 0.0


def outcome_digest(outcomes: List[RequestOutcome]) -> str:
    """Order-independent hash of request-level outcomes: same seed ⇒ same
    tokens, abort/completion flags ⇒ same digest."""
    payload = sorted(
        (o.request_id, o.tokens, bool(o.aborted), o.error is None)
        for o in outcomes
    )
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()
    ).hexdigest()[:16]


def _tier_table(
    outcomes: List[RequestOutcome], tiers: List[TierSpec],
    elapsed_s: float,
) -> Dict[str, dict]:
    specs = {t.tier: t for t in tiers}
    table: Dict[str, dict] = {}
    for tier in sorted({o.tier for o in outcomes}):
        sub = [o for o in outcomes if o.tier == tier]
        scored = [o for o in sub
                  if o.error is None and not o.aborted
                  and o.finish_reason is not None]
        ttfts = [o.ttft_s for o in scored if o.ttft_s is not None]
        itls = [x for o in scored for x in o.itls]
        out_tokens = sum(len(o.tokens) for o in scored)
        spec = specs.get(tier)
        violations = 0
        if spec is not None:
            for o in scored:
                mean_itl = (sum(o.itls) / len(o.itls)) if o.itls else 0.0
                if ((o.ttft_s or 0.0) > spec.ttft_slo_s
                        or mean_itl > spec.itl_slo_s):
                    violations += 1
        table[str(tier)] = {
            "requests": len(sub),
            "completed": len(scored),
            "aborted": sum(1 for o in sub if o.aborted),
            "errors": sum(1 for o in sub if o.error is not None),
            "ttft_p50_ms": round(percentile(ttfts, 50) * 1e3, 2),
            "ttft_p99_ms": round(percentile(ttfts, 99) * 1e3, 2),
            "itl_p50_ms": round(percentile(itls, 50) * 1e3, 2),
            "itl_p99_ms": round(percentile(itls, 99) * 1e3, 2),
            "goodput_tokens": out_tokens,
            "goodput_tok_s": round(out_tokens / max(elapsed_s, 1e-9), 2),
            "slo": ({"ttft_s": spec.ttft_slo_s, "itl_s": spec.itl_slo_s}
                    if spec else None),
            "slo_violation_rate": (
                round(violations / len(scored), 4) if scored else None),
        }
    return table


def _span_timelines(spans: List[dict]) -> Dict[str, dict]:
    """trace_id → stage-duration map, only for traces whose span set is
    unambiguous (exactly one queue + one prefill span = one engine
    admission; migrated/evacuated requests have several)."""
    by_trace: Dict[str, Dict[str, List[float]]] = {}
    for s in spans:
        dur = s.get("duration_s")
        if dur is None:
            continue
        by_trace.setdefault(s.get("trace_id", "?"), {}).setdefault(
            s.get("name", "?"), []).append(float(dur))
    out: Dict[str, dict] = {}
    for tid, stages in by_trace.items():
        if (len(stages.get("worker.queue", [])) == 1
                and len(stages.get("engine.prefill", [])) == 1):
            out[tid] = {
                "queue_s": stages["worker.queue"][0],
                "prefill_s": stages["engine.prefill"][0],
                "attempts": len(stages.get("migration.attempt", [])),
            }
    return out


# Observability evidence that can attribute each fault site's firings
# (keys into ``ReplayRunResult.evidence``). A fired fault none of whose
# mapped counters moved is chaos the stack cannot see — a defect.
SITE_EVIDENCE: Dict[str, tuple] = {
    "client.connect": ("migration_retries", "breaker_trips"),
    "client.send": ("migration_retries", "breaker_trips"),
    "worker.admit": ("migration_retries", "breaker_trips"),
    "worker.stream": ("migration_retries",),
    "store.call": ("store_call_errors",),
    "store.connect": ("store_recoveries",),
    "store.watch": ("store_recoveries",),
    "disagg.prefill": ("disagg_fallbacks",),
    "disagg.transfer": ("disagg_fallbacks",),
    "disagg.inject": ("disagg_fallbacks",),
    "preempt.notice": ("preempt_notices",),
    "preempt.evacuate": ("preempt_evacuated", "preempt_spilled",
                         "preempt_fallbacks"),
    "engine.stall": ("engine_stalls",),
}

# kind-specific overrides where the generic site evidence cannot move:
# a DROPPED maintenance notice means the coordinator never ran — the
# evidence is the cold-kill recovery machinery instead
SITE_KIND_EVIDENCE: Dict[tuple, tuple] = {
    ("preempt.notice", "drop"): ("migration_retries", "breaker_trips"),
}


def cross_check_fault_attribution(
    faults_fired: Dict[str, int], evidence: Dict[str, float],
) -> dict:
    """Every fault the plan fired must surface in the observability
    evidence (spans, recorder counters, preemption reports) or the run
    fails — silent chaos is itself a defect."""
    unattributed = []
    detail: Dict[str, dict] = {}
    for key in sorted(faults_fired):
        count = faults_fired[key]
        if count <= 0:
            continue
        site, _, kind = key.partition("/")
        ev_keys = (SITE_KIND_EVIDENCE.get((site, kind))
                   or SITE_EVIDENCE.get(site))
        if not ev_keys:
            unattributed.append(f"{key} (no evidence mapping)")
            continue
        seen = {k: evidence.get(k, 0.0) for k in ev_keys}
        detail[key] = {"fired": count, "evidence": seen}
        if not any(v > 0 for v in seen.values()):
            unattributed.append(key)
    check = {"fired": dict(sorted(faults_fired.items())),
             "evidence": {k: evidence[k] for k in sorted(evidence)},
             "detail": detail}
    if unattributed:
        check.update(ok=False, reason=(
            "fired faults left no observability evidence: "
            + ", ".join(unattributed)))
    else:
        check["ok"] = True
    return check


def token_loss_accounting(outcomes: List[RequestOutcome]) -> dict:
    """Every accepted request must end in exactly one clean state:
    completed with its full budget (possibly via migration / evacuation
    resume), aborted by its own client, or errored with a taxonomy string.
    A request billed as finished short of budget — or left in no terminal
    state at all — is silent token loss and fails the run."""
    completed = errored = aborted = resumed = 0
    losses: List[dict] = []
    for o in outcomes:
        if o.aborted:
            aborted += 1
            continue
        if o.error is not None:
            errored += 1
            continue
        if o.finish_reason is None:
            losses.append({"request_id": o.request_id,
                           "reason": "no terminal state"})
            continue
        if len(o.tokens) < o.osl:
            losses.append({
                "request_id": o.request_id,
                "reason": (f"finished {o.finish_reason!r} with "
                           f"{len(o.tokens)}/{o.osl} tokens"),
            })
            continue
        completed += 1
        if o.resumes or o.reconnects:
            resumed += 1
    check = {
        "completed_full": completed,
        "resumed": resumed,
        "aborted": aborted,
        "errored": errored,
        "silent_losses": len(losses),
        "losses": losses[:16],
    }
    if losses:
        check.update(ok=False, reason=(
            f"{len(losses)} request(s) silently lost tokens "
            f"(first: {losses[0]})"))
    else:
        check["ok"] = True
    return check


def wave_recovery(
    trace: ReplayTrace, outcomes: List[RequestOutcome],
    window_s: Optional[float] = None,
) -> dict:
    """Per-chaos-wave time-to-recover: for each fault wave (and each
    structural chaos event), the number of trace-clock windows after its
    onset until every SLO tier is compliant again. A window is compliant
    for a tier when no scored request arriving in it violates the tier's
    SLOs (empty windows are compliant — nothing suffered)."""
    duration = max(trace.duration_s, 1e-9)
    window_s = window_s or max(duration / 12.0, 1e-3)
    specs = {t.tier: t for t in trace.tiers()}

    def _violates(o: RequestOutcome) -> bool:
        spec = specs.get(o.tier)
        if spec is None:
            return False
        mean_itl = (sum(o.itls) / len(o.itls)) if o.itls else 0.0
        return ((o.ttft_s or 0.0) > spec.ttft_slo_s
                or mean_itl > spec.itl_slo_s)

    scored = [(o.arrival_s, o.tier, _violates(o)) for o in outcomes
              if o.error is None and not o.aborted
              and o.finish_reason is not None]
    last_arrival = max((a for a, _t, _v in scored), default=0.0)
    n_windows = int(last_arrival // window_s) + 1

    waves: List[tuple] = []
    for ev in trace.events:
        if ev.kind == "fault":
            waves.append((str(ev.params.get("wave", "?")), ev.at_s))
        elif ev.kind in ("preempt", "kill_worker", "store_flap"):
            waves.append((f"{ev.kind}@{ev.at_s}", ev.at_s))

    out: Dict[str, dict] = {}
    for name, at_s in waves:
        k0 = int(at_s // window_s)
        tiers: Dict[str, dict] = {}
        worst: Optional[int] = 0
        for tier in sorted(specs):
            rec: Optional[int] = None
            for k in range(k0, n_windows + 1):
                lo, hi = k * window_s, (k + 1) * window_s
                bad = any(v for a, t, v in scored
                          if t == tier and lo <= a < hi)
                if not bad:
                    rec = k - k0
                    break
            tiers[str(tier)] = {"windows_to_recover": rec,
                                "recovered": rec is not None}
            if rec is None:
                worst = None
            elif worst is not None:
                worst = max(worst, rec)
        out[name] = {"at_s": at_s, "tiers": tiers,
                     "windows_to_recover": worst}
    return {"window_s": round(window_s, 6), "waves": out}


def cross_check_ttft(
    outcomes: List[RequestOutcome], spans: List[dict],
    tol: CheckTolerances,
) -> dict:
    """Client TTFT vs span-assembled worker timeline, per clean request."""
    timelines = _span_timelines(spans)
    samples = []
    for o in outcomes:
        if (o.error is not None or o.aborted or o.resumes
                or o.reconnects or len(o.submissions) != 1
                or o.ttft_s is None):
            continue
        tl = timelines.get(o.trace_id)
        if tl is None or tl["attempts"] > 1:
            continue
        span_ttft = tl["queue_s"] + tl["prefill_s"]
        samples.append({
            "request_id": o.request_id,
            "client_ttft_s": round(o.ttft_s, 6),
            "span_ttft_s": round(span_ttft, 6),
            "overhead_s": round(o.ttft_s - span_ttft, 6),
        })
    check = {
        "samples": len(samples),
        "tolerance": {"span_slack_s": tol.ttft_span_slack_s,
                      "overhead_s": tol.ttft_overhead_s,
                      "min_samples": tol.min_ttft_samples},
    }
    if len(samples) < tol.min_ttft_samples:
        check.update(ok=False, reason=(
            f"only {len(samples)} span-matched clean requests "
            f"(need {tol.min_ttft_samples}) — span pipeline broken?"))
        return check
    overheads = sorted(s["overhead_s"] for s in samples)
    median_overhead = overheads[len(overheads) // 2]
    worst_negative = min(overheads)
    check.update({
        "median_overhead_s": round(median_overhead, 6),
        "min_overhead_s": round(worst_negative, 6),
        "max_overhead_s": round(overheads[-1], 6),
    })
    if worst_negative < -tol.ttft_span_slack_s:
        check.update(ok=False, reason=(
            f"span timeline exceeds client TTFT by "
            f"{-worst_negative:.3f}s (> {tol.ttft_span_slack_s}s slack)"))
    elif median_overhead > tol.ttft_overhead_s:
        check.update(ok=False, reason=(
            f"median client-over-span overhead {median_overhead:.3f}s "
            f"exceeds {tol.ttft_overhead_s}s"))
    else:
        check["ok"] = True
    return check


def cross_check_tokens(
    outcomes: List[RequestOutcome], recorder_tokens: float,
    prefix_hit_tokens: float, tol: CheckTolerances,
) -> dict:
    """Client-counted tokens vs recorder lifetime goodput totals.

    The recorder counts every token the engines *computed* — prompt tokens
    per dispatched prefill chunk plus decode-window tokens — so the
    client-side expectation is Σ over submissions of (prompt + received),
    minus two measured credits for work the engine legitimately never did:
    prefix-cache hit tokens (cached blocks skip prefill dispatch) and one
    token per productive submission (the first output token is sampled by
    the final prefill chunk, whose goodput already counted as prompt)."""
    client_expected = float(sum(
        p + r for o in outcomes for (p, r) in o.submissions))
    first_token_credit = float(sum(
        1 for o in outcomes for (_p, r) in o.submissions if r > 0))
    low = ((client_expected - prefix_hit_tokens - first_token_credit)
           * (1.0 - tol.token_tol_low))
    high = client_expected * (1.0 + tol.token_tol_high)
    check = {
        "client_expected_tokens": client_expected,
        "recorder_tokens": recorder_tokens,
        "prefix_hit_tokens_credit": prefix_hit_tokens,
        "first_token_credit": first_token_credit,
        "bounds": [round(low, 1), round(high, 1)],
        "tolerance": {"low": tol.token_tol_low,
                      "high": tol.token_tol_high},
    }
    if client_expected <= 0:
        check.update(ok=False, reason="no client-side submissions recorded")
    elif recorder_tokens < low:
        check.update(ok=False, reason=(
            f"recorder {recorder_tokens:.0f} below bound {low:.0f} — "
            f"engines did less work than clients were billed for"))
    elif recorder_tokens > high:
        check.update(ok=False, reason=(
            f"recorder {recorder_tokens:.0f} above bound {high:.0f} — "
            f"hidden replay amplification"))
    else:
        check["ok"] = True
    return check


def cross_check_prefix_vs_index(
    run: ReplayRunResult, tol: CheckTolerances,
) -> dict:
    """Scheduler-measured prefix-hit tokens vs the radix index's own hit
    accounting.

    The scheduler counts pool hits at admission; the prefix manager
    reports the same matches to the radix index, which credits a block
    ONLY if its event-fed replica of the pool also holds it in G1. The
    two countings share a site but not state — so any disagreement means
    the index has drifted from the pool (missed/duplicated events, stale
    tier markings) and the run fails."""
    measured = float(run.prefix_hits_blocks * run.block_size)
    index = float(getattr(run, "prefix_index_hit_tokens", 0.0))
    check = {
        "scheduler_hit_tokens": measured,
        "index_hit_tokens": index,
        "scheduler_query_blocks": float(run.prefix_queries_blocks),
        "index_query_blocks": float(
            getattr(run, "prefix_index_queries", 0.0)),
        "tolerance": {"slack_tokens": tol.prefix_index_slack_tokens},
    }
    diff = abs(measured - index)
    if diff > tol.prefix_index_slack_tokens:
        check.update(ok=False, reason=(
            f"radix index credited {index:.0f} hit tokens but the "
            f"scheduler measured {measured:.0f} (|Δ|={diff:.0f} > "
            f"{tol.prefix_index_slack_tokens:.0f}) — prefix index has "
            f"drifted from the block pool"))
    else:
        check["ok"] = True
    return check


def _chaos_violation_rate(
    trace: ReplayTrace, outcomes: List[RequestOutcome],
    chaos_starts: List[float],
) -> Optional[float]:
    """SLO-violation rate over requests arriving at/after the first
    scheduled chaos event — SLO-under-chaos, not SLO-under-load."""
    if not chaos_starts:
        return None
    first = min(chaos_starts)
    specs = {t.tier: t for t in trace.tiers()}
    scored = [o for o in outcomes
              if o.arrival_s >= first and o.error is None
              and not o.aborted and o.finish_reason is not None]
    if not scored:
        return None
    violations = 0
    for o in scored:
        spec = specs.get(o.tier)
        if spec is None:
            continue
        mean_itl = (sum(o.itls) / len(o.itls)) if o.itls else 0.0
        if ((o.ttft_s or 0.0) > spec.ttft_slo_s
                or mean_itl > spec.itl_slo_s):
            violations += 1
    return round(violations / len(scored), 4)


def _recovery_p99(recovery: dict) -> Optional[float]:
    vals = [w["windows_to_recover"] for w in recovery["waves"].values()
            if w["windows_to_recover"] is not None]
    if not vals:
        return None
    return round(percentile([float(v) for v in vals], 99), 2)


def build_scoreboard(
    trace: ReplayTrace, run: ReplayRunResult,
    tol: Optional[CheckTolerances] = None,
) -> dict:
    """Assemble the full REPLAY_*.json payload from one cluster replay."""
    tol = tol or CheckTolerances()
    outcomes = run.outcomes
    elapsed = max(run.elapsed_s, 1e-9)
    completed = [o for o in outcomes
                 if o.error is None and not o.aborted
                 and o.finish_reason is not None]
    out_tokens = sum(len(o.tokens) for o in completed)
    gt = dict(trace.meta.get("prefix_ground_truth") or {})
    hit_tokens = float(run.prefix_hits_blocks * run.block_size)
    hit_potential = float(gt.get("prefix_hit_potential_tokens", 0) or 0)

    # $-proxy: measured chip-seconds per 1M output tokens, next to the
    # analytic roofline for the same token volume (flops of every
    # completed request at the device's peak)
    chip_seconds = elapsed * run.chips
    per_1m = (chip_seconds / (out_tokens / 1e6)) if out_tokens else None
    peak = peak_flops(run.device_kind, run.platform)
    try:
        from ..engine.config import ModelConfig

        fm = FlopsModel(getattr(run, "model", None) or ModelConfig.tiny())
        ideal_s = sum(
            fm.sequence_flops(o.isl, max(len(o.tokens), 1))
            for o in completed
        ) / peak
    except Exception:
        ideal_s = None
    ideal_per_1m = ((ideal_s / (out_tokens / 1e6))
                    if (ideal_s is not None and out_tokens) else None)

    checks = {
        "ttft_vs_spans": cross_check_ttft(outcomes, run.spans, tol),
        "tokens_vs_recorder": cross_check_tokens(
            outcomes, run.recorder_goodput_tokens, hit_tokens, tol),
        "token_loss": token_loss_accounting(outcomes),
        "fault_attribution": cross_check_fault_attribution(
            getattr(run, "faults_fired", {}) or {},
            getattr(run, "evidence", {}) or {}),
        "prefix_vs_index": cross_check_prefix_vs_index(run, tol),
    }
    recovery = wave_recovery(trace, outcomes)
    chaos_starts = [e.at_s for e in trace.events
                    if e.kind in ("fault", "preempt", "kill_worker",
                                  "store_flap")]
    tier_table = _tier_table(outcomes, trace.tiers(), elapsed)
    violation_rates = [t["slo_violation_rate"] for t in tier_table.values()
                       if t["slo_violation_rate"] is not None]
    report = {
        "replay_seed": run.seed,
        "outcome_digest": outcome_digest(outcomes),
        "requests": len(outcomes),
        "completed": len(completed),
        "aborted": sum(1 for o in outcomes if o.aborted),
        "errors": sum(1 for o in outcomes if o.error is not None),
        "reconnects": sum(o.reconnects for o in outcomes),
        "evacuation_resumes": sum(o.resumes for o in outcomes),
        "elapsed_s": round(run.elapsed_s, 3),
        "time_scale": run.time_scale,
        "output_tokens": out_tokens,
        "output_tok_s": round(out_tokens / elapsed, 2),
        "tiers": tier_table,
        "slo_violation_rate": (
            round(sum(
                t["slo_violation_rate"] * t["completed"]
                for t in tier_table.values()
                if t["slo_violation_rate"] is not None
            ) / max(len(completed), 1), 4)
            if violation_rates else None),
        "prefix_hit_tokens": hit_tokens,
        "prefix_hit_potential_tokens": hit_potential,
        "prefix_hit_rate": (
            round(min(hit_tokens / hit_potential, 1.0), 4)
            if hit_potential else None),
        "prefix_ground_truth": gt,
        "events_fired": run.events_fired,
        "preempt": run.preempt,
        "num_kills": run.num_kills,
        "faults_fired": getattr(run, "faults_fired", {}) or {},
        "fault_log": getattr(run, "fault_log", []) or [],
        "wave_recovery": recovery,
        # chaos headline fields (None when the trace schedules no chaos)
        "chaos_slo_violation_rate": _chaos_violation_rate(
            trace, outcomes, chaos_starts),
        "chaos_recovery_windows_p99": _recovery_p99(recovery),
        "chaos_token_loss": checks["token_loss"]["silent_losses"],
        "chips": run.chips,
        "device_kind": run.device_kind,
        "chip_seconds": round(chip_seconds, 3),
        "chip_seconds_per_1m_output_tokens": (
            round(per_1m, 2) if per_1m is not None else None),
        "ideal_chip_seconds_per_1m_output_tokens": (
            round(ideal_per_1m, 6) if ideal_per_1m is not None else None),
        "checks": checks,
        "ok": all(c.get("ok") for c in checks.values()),
    }
    return report
