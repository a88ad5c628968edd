"""Prefix index over worker KV caches (ref: lib/llm/src/kv_router/indexer.rs).

The reference keeps a per-worker radix tree of *unchained* per-block hashes
(indexer.rs:224 ``RadixTree``) and walks it edge by edge. This build keys
every component on **chained sequence hashes** (see ``dynamo_tpu.tokens``
module docstring): equal sequence hashes imply equal full prefixes, so the
radix tree collapses into a flat ``seq_hash → {workers}`` map and prefix
matching is a linear walk over the request's block hashes — O(depth) with no
tree bookkeeping, and immune to cross-component hash-scheme drift.

``ApproxKvIndexer`` (ref: approx.rs:165) is the no-events fallback: it
records the router's *own* routing decisions with a TTL, approximating which
worker holds which prefix when engines don't publish events.

A copy of ``dynamo_tpu.router.indexer`` on the Python path only: the JAX
package's C++ matcher (its ``native/``) and the ``use_native`` switch that
selects it are left out. ``RouterEvent`` lives here, as in the JAX package;
``router/publisher.py`` imports it.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from ..tokens import SequenceHash, compute_block_hashes_for_seq

WorkerId = int


@dataclass
class OverlapScores:
    """Per-worker count of matched leading blocks (ref: indexer.rs:617)."""

    scores: Dict[WorkerId, int] = field(default_factory=dict)

    def best(self) -> int:
        return max(self.scores.values(), default=0)


@dataclass(frozen=True)
class RouterEvent:
    """One worker's KV-cache event as carried on the wire
    (ref: indexer.rs:175)."""

    worker_id: WorkerId
    kind: str                 # "stored" | "removed" | "cleared"
    blocks: tuple             # stored: ({seq_hash, block_hash, parent},…)
                              # removed: (seq_hash,…); cleared: ()

    def to_dict(self) -> dict:
        return {
            "worker_id": self.worker_id,
            "event": {"kind": self.kind, "blocks": list(self.blocks)},
        }

    @staticmethod
    def from_dict(d: dict) -> "RouterEvent":
        ev = d["event"]
        return RouterEvent(
            worker_id=int(d["worker_id"]),
            kind=ev["kind"],
            blocks=tuple(ev.get("blocks", ())),
        )


class KvIndexer:
    """seq_hash → set(workers) prefix index fed by KV events.

    Same role as the reference's ``KvIndexer`` + ``RadixTree``
    (indexer.rs:224,738); flat because our hashes chain (module docstring).
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._workers_of: Dict[SequenceHash, Set[WorkerId]] = {}
        self._hashes_of: Dict[WorkerId, Set[SequenceHash]] = {}
        self.events_applied = 0

    # -- event application (ref: indexer.rs:320 apply_event) --

    def apply_event(self, event: RouterEvent) -> None:
        self.events_applied += 1
        w = event.worker_id
        if event.kind == "stored":
            held = self._hashes_of.setdefault(w, set())
            for b in event.blocks:
                h = int(b["seq_hash"]) if isinstance(b, dict) else int(b)
                self._workers_of.setdefault(h, set()).add(w)
                held.add(h)
        elif event.kind == "removed":
            held = self._hashes_of.get(w)
            for h in event.blocks:
                h = int(h["seq_hash"]) if isinstance(h, dict) else int(h)
                ws = self._workers_of.get(h)
                if ws is not None:
                    ws.discard(w)
                    if not ws:
                        del self._workers_of[h]
                if held is not None:
                    held.discard(h)
        elif event.kind == "cleared":
            self.clear_worker(w)

    def remove_worker(self, worker: WorkerId) -> None:
        """Worker died (lease expired) — drop all its blocks
        (ref: indexer.rs:422)."""
        self.clear_worker(worker)

    def clear_worker(self, worker: WorkerId) -> None:
        for h in self._hashes_of.pop(worker, set()):
            ws = self._workers_of.get(h)
            if ws is not None:
                ws.discard(worker)
                if not ws:
                    del self._workers_of[h]

    # -- matching (ref: indexer.rs:276 find_matches) --

    def find_matches(self, seq_hashes: Sequence[SequenceHash]) -> OverlapScores:
        """Count, per worker, how many *leading* blocks it holds.

        A worker's score only advances at block ``i`` if it matched all
        blocks before it — with chained hashes that is exactly the radix-walk
        the reference does.
        """
        scores: Dict[WorkerId, int] = {}
        for i, h in enumerate(seq_hashes):
            ws = self._workers_of.get(h)
            if not ws:
                break  # chained hashes: nobody can match deeper either
            advanced = False
            for w in ws:
                if scores.get(w, 0) == i:
                    scores[w] = i + 1
                    advanced = True
            if not advanced:
                break
        return OverlapScores(scores=scores)

    def find_matches_for_tokens(self, tokens: Sequence[int]) -> OverlapScores:
        return self.find_matches(
            compute_block_hashes_for_seq(list(tokens), self.block_size)
        )

    # -- introspection --

    def num_blocks(self, worker: Optional[WorkerId] = None) -> int:
        if worker is None:
            return len(self._workers_of)
        return len(self._hashes_of.get(worker, ()))

    def dump_events(self) -> List[RouterEvent]:
        """Serialise the index as stored-events (ref: indexer.rs:450) —
        the radix-snapshot payload for router replica warm-up."""
        out = []
        for w, hashes in self._hashes_of.items():
            if hashes:
                out.append(RouterEvent(
                    worker_id=w, kind="stored",
                    blocks=tuple({"seq_hash": h} for h in sorted(hashes)),
                ))
        return out


class ApproxKvIndexer:
    """TTL'd routing-decision history standing in for real KV events
    (ref: approx.rs:165).

    ``record_routing_decision`` notes that the chosen worker will soon hold
    the request's prefix blocks; entries expire after ``ttl_s`` (the horizon
    over which cached prefixes are presumed to survive engine eviction).
    """

    def __init__(self, block_size: int, ttl_s: float = 120.0):
        self.block_size = block_size
        self.ttl_s = ttl_s
        # (seq_hash, worker) -> expiry, insertion-ordered for cheap pruning
        self._entries: "OrderedDict[tuple, float]" = OrderedDict()
        self._workers_of: Dict[SequenceHash, Set[WorkerId]] = {}

    def record_routing_decision(
        self, worker: WorkerId, tokens: Sequence[int]
    ) -> None:
        now = time.monotonic()
        self._prune(now)
        for h in compute_block_hashes_for_seq(list(tokens), self.block_size):
            key = (h, worker)
            if key in self._entries:
                del self._entries[key]  # refresh recency
            else:
                self._workers_of.setdefault(h, set()).add(worker)
            self._entries[key] = now + self.ttl_s

    def find_matches_for_tokens(self, tokens: Sequence[int]) -> OverlapScores:
        self._prune(time.monotonic())
        scores: Dict[WorkerId, int] = {}
        hashes = compute_block_hashes_for_seq(list(tokens), self.block_size)
        for i, h in enumerate(hashes):
            ws = self._workers_of.get(h)
            if not ws:
                break
            advanced = False
            for w in ws:
                if scores.get(w, 0) == i:
                    scores[w] = i + 1
                    advanced = True
            if not advanced:
                break
        return OverlapScores(scores=scores)

    def remove_worker(self, worker: WorkerId) -> None:
        for (h, w) in [k for k in self._entries if k[1] == worker]:
            del self._entries[(h, w)]
            ws = self._workers_of.get(h)
            if ws is not None:
                ws.discard(w)
                if not ws:
                    del self._workers_of[h]

    def _prune(self, now: float) -> None:
        while self._entries:
            key, expiry = next(iter(self._entries.items()))
            if expiry > now:
                break
            del self._entries[key]
            h, w = key
            ws = self._workers_of.get(h)
            if ws is not None:
                ws.discard(w)
                if not ws:
                    del self._workers_of[h]
