"""Layered runtime configuration.

Equivalent role to the reference's figment-based ``RuntimeConfig``
(ref: lib/runtime/src/config.rs:72,194-244): defaults < config file (JSON)
< environment variables, with the ``DYNTPU_`` prefix (the reference uses
``DYN_``). Typed accessors with bool/int/float coercion.

A copy of ``dynamo_tpu.utils.config`` holding the settings this package
reads, under the JAX package's names, defaults and environment variables,
so one deployment's settings configure processes of either package: the
system server, health probes, speculative decoding and the planner's
degradation ladder, the radix prefix cache (on by default, as in the JAX
package), the disaggregated handoff and the preemption coordinator among
them. The profile directory of ``/debug/profile`` comes with its path
(ROADMAP.md queue A, item 7).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

ENV_PREFIX = "DYNTPU_"

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off", ""}


def env_flag(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    low = raw.strip().lower()
    if low in _TRUTHY:
        return True
    if low in _FALSY:
        return False
    raise ValueError(f"cannot parse boolean env {name}={raw!r}")


def env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw is None or raw == "" else int(raw)


def env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return default if raw is None or raw == "" else float(raw)


def env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclasses.dataclass
class RuntimeConfig:
    """Process-wide runtime settings, layered from file + env."""

    namespace: str = "dynamo"
    store_addr: str = "127.0.0.1:3280"  # lease-KV discovery store (etcd role)
    system_port: int = 0  # 0 = disabled; /health /live /metrics server
    system_enabled: bool = False
    request_timeout_s: float = 600.0
    # frontend admission control: 0 disables the limiter entirely
    max_concurrent_requests: int = 0
    max_queued_requests: int = 16
    retry_after_s: float = 1.0
    health_check_enabled: bool = False
    health_check_period_s: float = 10.0
    lease_ttl_s: float = 10.0  # ref: transports/etcd.rs:89-95 (10 s TTL)
    # graceful drain: in-flight streams get this long to finish before they
    # are stopped (clients migrate the remainder to another worker)
    drain_timeout_s: float = 30.0
    # store-outage survival: how long the client retries reconnecting before
    # declaring the lease lost, and the jittered-backoff pacing of the dials
    store_recover_timeout_s: float = 30.0
    store_reconnect_base_s: float = 0.25
    store_reconnect_cap_s: float = 5.0
    # after a snapshot reconcile, keys missing from the snapshot are only
    # evicted once they stay gone this long (their owner may be re-putting)
    store_reconcile_grace_s: float = 3.0
    # -- request tracing (dynamo_tpu_torch.tracing) --
    # head-sampling ratio by trace id in [0, 1]; 0 disables span export
    # (stage_latency_seconds histograms are observed regardless)
    trace_sample_ratio: float = 0.0
    # root spans slower than this are exported even when unsampled
    # (slow-request auto-dump); 0 disables
    trace_slow_threshold_s: float = 0.0
    # JSONL span export path for the offline assembler; "" disables
    trace_export_path: str = ""
    # in-process span ring buffer
    trace_buffer_size: int = 4096
    # -- speculative decoding defaults (worker flags override) --
    # "off" | "ngram"; see EngineConfig.spec_mode for semantics
    spec_mode: str = "off"
    spec_k: int = 4
    # acceptance rate below which drafting auto-disables (0 = never),
    # checked once spec_auto_disable_window draft tokens were verified
    spec_auto_disable_threshold: float = 0.0
    spec_auto_disable_window: int = 256
    # chunked prefill: per-chunk token cap so long prompts interleave with
    # running decodes (0 = whole-bucket prefill)
    prefill_chunk_tokens: int = 0
    # "bf16" | "int8" | "fp8": weight and paged-KV storage dtypes,
    # validated again by EngineConfig at engine startup
    weight_dtype: str = "bf16"
    kv_dtype: str = "bf16"
    # -- engine flight recorder (dynamo_tpu_torch.observability) --
    # master switch for the per-step recorder; it stamps host-known ints
    # on already-planned syncs, so the steady-state overhead is a few
    # microseconds per window
    obs_enabled: bool = True
    # trailing window the live gauges (mfu, goodput_tok_s,
    # padding_waste_ratio, ...) describe
    obs_window_s: float = 10.0
    # append every landed StepRecord as one JSON line here ("" disables);
    # render offline with `python -m dynamo_tpu_torch.observability <path>`
    obs_stepstats_path: str = ""
    # -- SLA planner (the JAX package's python -m dynamo_tpu.planner) --
    # latency statistic the SLAs are enforced on: "p99" | "p50" | "avg"
    planner_sla_quantile: str = "p99"
    # graceful-degradation ladder (shed -> clamp spec_k -> tighten
    # chunking) ordered before scaling; see planner/degradation.py
    planner_degradation_enabled: bool = True
    planner_engage_ratio: float = 1.5
    planner_release_ratio: float = 1.0
    planner_shed_tier: int = 1
    planner_spec_k_clamp: int = 1
    planner_chunk_clamp_tokens: int = 256
    # workers poll planner/{ns}/degradation and clamp their engine knobs
    # when enabled (frontends always apply tier shedding)
    planner_apply_degradation: bool = False
    # -- global prefix cache (dynamo_tpu_torch.prefix) --
    # radix-tree prefix index over the tiered KVBM: engine-side tier
    # tracking + onboarding/demotion policies (attach_prefix_cache)
    prefix_enabled: bool = True
    # G1 blocks one degradation evict_to_host application may demote
    prefix_evict_blocks: int = 64
    # routing score weight of host-pool / store-held prefix blocks
    # relative to device-resident G1 (= 1.0)
    prefix_tier_weight_g2: float = 0.75
    prefix_tier_weight_g4: float = 0.5
    # -- disaggregated prefill/decode handoff (dynamo_tpu_torch.disagg) --
    # how long decode waits on a queued prefill before going local
    disagg_queue_wait_s: float = 60.0
    # total wall budget for one KV handoff (further capped by the
    # request's own deadline)
    disagg_handoff_timeout_s: float = 120.0
    # extra wait when a device transfer is mid-write at timeout
    disagg_inflight_grace_s: float = 30.0
    # per-attempt cap on one KV push (device transfer or relay inject)
    disagg_inject_timeout_s: float = 10.0
    # push retries after the first attempt (exponential backoff from
    # the base, always bounded by the remaining handoff deadline)
    disagg_transfer_max_retries: int = 2
    disagg_retry_backoff_base_s: float = 0.05
    # consecutive handoff failures before decode flips to local-prefill
    # for the cooldown window (exported as disagg_breaker_open)
    disagg_breaker_failure_threshold: int = 3
    disagg_breaker_cooldown_s: float = 10.0
    # orphan GC: sweep cadence + slack past an entry's deadline
    disagg_orphan_sweep_interval_s: float = 5.0
    disagg_orphan_grace_s: float = 5.0
    # -- preemption tolerance (dynamo_tpu_torch.runtime.preemption) --
    # wait after a maintenance notice before evacuating, so short
    # seats finish in place instead of paying a handoff
    preempt_notice_grace_s: float = 2.0
    # total wall budget for evacuating all in-flight seats; seats that
    # miss the deadline fall back to Migration re-prefill
    preempt_evac_deadline_s: float = 30.0
    # max seat-state journal entries retained per worker (evacuated
    # seats are dropped oldest-first past the cap)
    preempt_journal_cap: int = 256

    @staticmethod
    def from_settings(path: Optional[str] = None) -> "RuntimeConfig":
        cfg = RuntimeConfig()
        file_path = path or os.environ.get(ENV_PREFIX + "CONFIG")
        if file_path and Path(file_path).exists():
            data = json.loads(Path(file_path).read_text())
            for k, v in data.items():
                if hasattr(cfg, k):
                    setattr(cfg, k, v)
        # env layer wins: DYNTPU_<FIELD IN CAPITALS>, as in the JAX package
        for field in dataclasses.fields(cfg):
            env = ENV_PREFIX + field.name.upper()
            current = getattr(cfg, field.name)
            if field.type == "bool":
                value = env_flag(env, current)
            elif field.type == "int":
                value = env_int(env, current)
            elif field.type == "float":
                value = env_float(env, current)
            else:
                value = env_str(env, current)
            setattr(cfg, field.name, value)
        return cfg


# settings whose path this package does not serve yet, with the ROADMAP.md
# item that brings each (none: every setting above has its path)
_UNPORTED: tuple = ()


def check_supported(cfg: RuntimeConfig) -> None:
    """Refuse every setting whose path this package does not serve yet:
    the process would otherwise run without what was asked for."""
    for field, what in _UNPORTED:
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{field} ({ENV_PREFIX}{field.upper()}) needs {what}, which "
                "dynamo_tpu_torch does not serve yet"
            )
