"""Worker selection with the reference cost function
(ref: lib/llm/src/kv_router/scheduler.rs:461-524).

``logit = overlap_weight * potential_prefill_blocks + decode_blocks`` —
lower is better; the winner is softmax-sampled over ``-logit / temperature``
(temperature 0 → uniform choice among the minima; scheduler.rs:375
``softmax_sample``).

``PotentialLoads`` tracks, per worker, what the router has routed and not yet
seen finish — the ``prefill_tokens`` / ``decode_blocks`` inputs the reference
keeps in ``ActiveSequences`` (sequence.rs).

A copy of ``dynamo_tpu.router.scheduler``: the same ``random.Random`` draws,
so a seeded router picks the same workers in both packages.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, Optional

WorkerId = int


@dataclass
class KvRouterConfig:
    """Router knobs (ref: kv_router.rs KvRouterConfig; CLI
    ``--kv-overlap-score-weight`` / ``--router-temperature``)."""

    overlap_score_weight: float = 1.0
    router_temperature: float = 0.0
    # workers above this fraction of busy decode blocks are rejected when
    # every candidate is saturated (ref: push_router.rs:58 busy threshold)
    busy_threshold: Optional[float] = None
    # persist the prefix-index snapshot (behind a store lock) every N
    # applied KV events so a router restart warm-starts instead of routing
    # blind (ref: kv_router.rs:979 radix-bucket snapshots). 0 = disabled.
    snapshot_threshold: int = 1000
    # publish/apply routing add/prefill_done/free events between router
    # replicas so peers see each other's in-flight load instead of
    # double-booking workers (ref: kv_router.rs:65-73 prefill_events /
    # active_sequences_events subjects)
    replica_sync: bool = True
    # prefix-aware routing: keep a cluster replica of the radix prefix
    # index (prefix.radix) fed by the same KV events and score workers by
    # longest cached prefix, tier-weighted — a worker holding the run in
    # G1 HBM outranks one that must onboard it from its host pool or the
    # G4 store. Falls back to the flat overlap counts for requests whose
    # match is shorter than ``prefix_min_blocks``.
    prefix_routing: bool = True
    prefix_min_blocks: int = 1
    prefix_tier_weight_g2: float = 0.75
    prefix_tier_weight_g4: float = 0.5


def softmax_sample(
    logits: Dict[WorkerId, float],
    temperature: float,
    rng: Optional[random.Random] = None,
) -> WorkerId:
    """Pick a worker: lower logit better (ref: scheduler.rs:375)."""
    if not logits:
        raise ValueError("no workers to sample from")
    rng = rng or random
    if temperature == 0.0:
        lo = min(logits.values())
        ties = [w for w, v in logits.items() if v == lo]
        return rng.choice(ties)
    # softmax over negated, temperature-scaled logits
    scaled = {w: -v / temperature for w, v in logits.items()}
    m = max(scaled.values())
    weights = {w: math.exp(v - m) for w, v in scaled.items()}
    total = sum(weights.values())
    pick = rng.random() * total
    acc = 0.0
    for w, wt in weights.items():
        acc += wt
        if pick <= acc:
            return w
    return next(reversed(list(weights)))


@dataclass
class _ActiveRequest:
    worker: WorkerId
    prefill_tokens: int   # tokens the worker must still prefill
    decode_blocks: int    # blocks the request occupies during decode


class PotentialLoads:
    """Per-worker outstanding prefill tokens + decode blocks
    (ref: sequence.rs ``ActiveSequences``; scheduler.rs potential loads).

    Lifecycle per request: ``add`` at routing time (prefill tokens =
    isl − overlap·block_size, decode blocks = ceil(isl/bs)); ``prefill_done``
    when the first token streams back (prefill cost drops off);
    ``free`` when the stream finishes.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._requests: Dict[str, _ActiveRequest] = {}
        self._prefill_tokens: Dict[WorkerId, int] = {}
        self._decode_blocks: Dict[WorkerId, int] = {}

    def add(
        self, request_id: str, worker: WorkerId, isl_tokens: int,
        overlap_blocks: int,
    ) -> None:
        new_tokens = max(0, isl_tokens - overlap_blocks * self.block_size)
        blocks = -(-isl_tokens // self.block_size)
        self._requests[request_id] = _ActiveRequest(
            worker=worker, prefill_tokens=new_tokens, decode_blocks=blocks
        )
        self._prefill_tokens[worker] = (
            self._prefill_tokens.get(worker, 0) + new_tokens
        )
        self._decode_blocks[worker] = (
            self._decode_blocks.get(worker, 0) + blocks
        )

    def prefill_done(self, request_id: str) -> None:
        req = self._requests.get(request_id)
        if req is None or req.prefill_tokens == 0:
            return
        self._prefill_tokens[req.worker] -= req.prefill_tokens
        req.prefill_tokens = 0

    def free(self, request_id: str) -> None:
        req = self._requests.pop(request_id, None)
        if req is None:
            return
        if req.prefill_tokens:
            self._prefill_tokens[req.worker] -= req.prefill_tokens
        self._decode_blocks[req.worker] -= req.decode_blocks

    def remove_worker(self, worker: WorkerId) -> None:
        for rid in [r for r, q in self._requests.items() if q.worker == worker]:
            del self._requests[rid]
        self._prefill_tokens.pop(worker, None)
        self._decode_blocks.pop(worker, None)

    def prefill_tokens(self, worker: WorkerId) -> int:
        return self._prefill_tokens.get(worker, 0)

    def decode_blocks(self, worker: WorkerId) -> int:
        return self._decode_blocks.get(worker, 0)

    @property
    def num_active(self) -> int:
        return len(self._requests)


@dataclass
class Selection:
    worker_id: WorkerId
    overlap_blocks: int
    logit: float


def select_worker(
    workers: list,
    isl_tokens: int,
    overlaps: Dict[WorkerId, float],
    loads: PotentialLoads,
    block_size: int,
    config: KvRouterConfig,
    *,
    overlap_weight: Optional[float] = None,
    temperature: Optional[float] = None,
    rng: Optional[random.Random] = None,
) -> Selection:
    """The reference's ``DefaultWorkerSelector::select_worker``
    (scheduler.rs:461): per-request overrides fall back to config; the
    *potential* load of a worker is what it would carry if this request
    landed there."""
    if not workers:
        raise ValueError("no workers")
    if isl_tokens <= 0:
        raise ValueError("isl_tokens must be positive")
    w_overlap = (config.overlap_score_weight
                 if overlap_weight is None else overlap_weight)
    temp = (config.router_temperature
            if temperature is None else temperature)
    request_blocks = -(-isl_tokens // block_size)
    logits: Dict[WorkerId, float] = {}
    for w in workers:
        overlap = overlaps.get(w, 0)
        new_tokens = max(0, isl_tokens - overlap * block_size)
        potential_prefill_blocks = (
            loads.prefill_tokens(w) + new_tokens
        ) / block_size
        potential_decode_blocks = loads.decode_blocks(w) + request_blocks
        logits[w] = (
            w_overlap * potential_prefill_blocks + potential_decode_blocks
        )
    chosen = softmax_sample(logits, temp, rng)
    return Selection(
        worker_id=chosen,
        overlap_blocks=overlaps.get(chosen, 0),
        logit=logits[chosen],
    )
