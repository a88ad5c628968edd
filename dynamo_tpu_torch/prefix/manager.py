"""Engine-side prefix cache manager over the tiered KVBM.

Owns one :class:`RadixPrefixIndex` tracking every complete prefix block
this worker knows about and which tier holds it:

  G1 (device HBM pages, the engine's ``BlockPool``) — fed by the pool's
      stored/removed/cleared events, so the index's G1 view tracks the
      paged cache exactly;
  G2 (host LRU pool) — marked when the KVBM offload tick lands a block,
      unmarked when the byte-bounded pool drops it;
  G4 (store remote tier) — marked on write-through puts.

On top of the index it adds the two tier *policies* the KVBM machinery
doesn't have: demotion (``evict_to_host`` — the planner degradation
ladder's new rung ahead of tier shedding: LRU subtrees of sealed G1
blocks are copied to the host pool and their HBM pages freed) and
device-plane onboarding (``onboard`` — a prompt whose prefix lives in a
*peer worker's* G1 is pulled block-for-block over the epoch-guarded
``disagg/ici.py`` transfer path instead of recomputed; G2/G4 hits fall
through to the KVBM onboard path, whose CRC-enveloped wire format and
per-(token, head) quantized scales keep the bytes exact at int8/fp8).

Hit accounting: the scheduler reports every admission-time prefix match
through ``on_scheduler_match``; the manager credits only blocks the
*index* also believes are in G1 — an independent state machine fed by
events — which is what the replay scoreboard's ``prefix_vs_index``
cross-check compares against the scheduler's own measured counters.

A copy of ``dynamo_tpu.prefix.manager`` on this package's engine, KVBM and
device plane (``disagg/ici.py``: a peer engine's G1 blocks are gathered on
its stream and scattered into ours in place, with no host copy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..utils.logging import get_logger
from .radix import TIER_G1, TIER_G2, TIER_G4, RadixPrefixIndex

log = get_logger("prefix")


@dataclass
class PrefixCacheConfig:
    enabled: bool = True
    # per evict_to_host() call: how many G1 blocks one degradation-rung
    # application may demote (bounds the extract batch per tick)
    evict_to_host_blocks: int = 64
    # per-request bound on blocks pulled over the device plane
    max_ici_blocks: int = 512
    # routing score weights for non-G1 tiers (G1 = 1.0)
    tier_weight_g2: float = 0.75
    tier_weight_g4: float = 0.5


class PrefixCacheManager:
    """Attached to an :class:`EngineCore` via ``attach_prefix_cache``."""

    def __init__(self, engine, kvbm=None,
                 config: Optional[PrefixCacheConfig] = None,
                 worker_id: int = 0, plane=None):
        self.engine = engine
        self.kvbm = kvbm
        self.config = config or PrefixCacheConfig()
        self.worker_id = worker_id
        # disagg.ici.DevicePlane + worker_id -> plane_id of in-process
        # peers whose G1 blocks can be pulled device-to-device
        self.plane = plane
        self.peer_planes: Dict[int, str] = {}
        self.index = RadixPrefixIndex(
            engine.config.block_size,
            tier_weights={TIER_G1: 1.0,
                          TIER_G2: self.config.tier_weight_g2,
                          TIER_G4: self.config.tier_weight_g4},
        )
        self.demoted_blocks = 0
        self.ici_onboarded_blocks = 0
        if kvbm is not None:
            kvbm.prefix = self
            # G2 drops retract the index marking; chain whatever drop
            # hook (distributed presence retraction) is already installed
            prev_drop = kvbm.host_pool.on_drop

            def _on_drop(seq_hash: int) -> None:
                if prev_drop is not None:
                    prev_drop(seq_hash)
                self.index.unmark(seq_hash, TIER_G2, self.worker_id)

            kvbm.host_pool.on_drop = _on_drop

    # --------------------- event-driven tier state ---------------------

    def on_pool_event(self, event) -> None:
        """G1 mirror: called from the engine's KV-event hook with every
        BlockPool stored/removed/cleared event."""
        if event.kind == "stored":
            for b in event.blocks:
                self.index.insert(
                    b["seq_hash"], b.get("block_hash", b["seq_hash"]),
                    b.get("parent"), TIER_G1, self.worker_id)
        elif event.kind == "removed":
            for h in event.blocks:
                self.index.unmark(h, TIER_G1, self.worker_id)
        elif event.kind == "cleared":
            self.index.clear_worker_tier(self.worker_id, TIER_G1)

    def on_offloaded(self, seq_hash: int) -> None:
        """KVBM offload tick landed the block in the host pool."""
        self.index.mark(seq_hash, TIER_G2, self.worker_id)

    def on_g4_put(self, seq_hash: int) -> None:
        self.index.mark(seq_hash, TIER_G4, self.worker_id)

    def ingest_router_event(self, worker_id: int, event: dict) -> None:
        """Learn a PEER worker's tier state from its ``RouterEvent``
        stream (the same events the router's cluster replica consumes) —
        this is how ``_peer_runs`` knows which peer G1 holds a prefix.
        Own events are ignored; the local pool feed is authoritative."""
        if worker_id != self.worker_id:
            self.index.apply_event(worker_id, event)

    def on_scheduler_match(self, queried: List[int],
                           matched: List[int]) -> None:
        """Admission-time prefix match result from the scheduler: credit
        hit tokens against the index's own G1 view (the independent
        accounting ``prefix_vs_index`` cross-checks)."""
        self.index.queries_total += len(queried)
        self.index.record_hit_blocks(matched, TIER_G1, self.worker_id)

    # ----------------------------- stats -------------------------------

    def snapshot(self) -> Dict[str, float]:
        out = self.index.stats()
        out["prefix_demoted_total"] = float(self.demoted_blocks)
        out["prefix_ici_onboarded_total"] = float(self.ici_onboarded_blocks)
        return out

    # --------------------------- onboarding ----------------------------

    async def onboard(self, token_seq) -> int:
        """Promote cached leading blocks of a prompt into G1 before
        admission. Order: peer-G1 over the device plane (no host round
        trip), then the KVBM host/peer-G2/G4 chain. Returns blocks
        promoted."""
        if not self.config.enabled:
            return 0
        n = 0
        if self.plane is not None and self.peer_planes:
            try:
                n += await self._onboard_ici(token_seq)
            except Exception:
                log.exception("ici prefix onboard failed — falling back")
        if self.kvbm is not None:
            n += await self.kvbm.onboard_prefix(token_seq)
        return n

    async def _onboard_ici(self, token_seq) -> int:
        """Pull the longest peer-held G1 run device-to-device.

        Rides :meth:`DevicePlane.transfer` — the epoch-guarded path; the
        guard itself is idle here because adopted destination blocks are
        invisible to the prefix cache until ``release_adopted``, so a
        failed transfer can never publish half-written KV."""
        pool = self.engine.scheduler.pool
        hashes = [tb.sequence_hash for tb in token_seq.blocks]
        need_from = 0
        while (need_from < len(hashes)
               and pool.contains(hashes[need_from])):
            need_from += 1
        missing = hashes[need_from:]
        if not missing:
            return 0
        if self.kvbm is not None and missing[0] in self.kvbm.host_pool:
            return 0   # the host pool serves this run cheaper
        # longest leading run a single peer holds in G1 (ties: lowest id)
        best_worker, best_run = None, 0
        for w, run in sorted(self._peer_runs(missing).items()):
            if run > best_run:
                best_worker, best_run = w, run
        if best_worker is None or best_run <= 0:
            return 0
        src_engine = self.plane.get(self.peer_planes.get(best_worker))
        if src_engine is None:
            return 0
        src_pool = src_engine.scheduler.pool
        run = missing[: min(best_run, self.config.max_ici_blocks)]
        pinned: List[Tuple[int, int]] = []       # (src_bid, seq_hash)
        adopted: List[int] = []                  # dst block ids
        try:
            for i, h in enumerate(run):
                src_bid = src_pool.lookup(h)     # pins (incref)
                if src_bid is None:
                    break                        # peer evicted it — stop
                tb = token_seq.blocks[need_from + i]
                dst_bid = pool.adopt(h, tb.block_hash,
                                     tb.parent_sequence_hash)
                if dst_bid is None:              # local G1 full
                    src_pool.decref(src_bid)
                    break
                pinned.append((src_bid, h))
                adopted.append(dst_bid)
            if not adopted:
                return 0
            await self.plane.transfer(
                src_engine, [bid for bid, _ in pinned],
                self.engine, adopted)
        except BaseException:
            for bid in adopted:
                pool.discard_adopted(bid)
            for bid, _ in pinned:
                src_pool.decref(bid)
            raise
        for bid in adopted:
            pool.release_adopted(bid)
        for bid, _ in pinned:
            src_pool.decref(bid)
        self.ici_onboarded_blocks += len(adopted)
        log.info("onboarded %d prefix blocks from worker %d over the "
                 "device plane", len(adopted), best_worker)
        return len(adopted)

    def _peer_runs(self, hashes: List[int]) -> Dict[int, int]:
        """Leading G1 run length per peer worker for ``hashes``."""
        runs: Dict[int, int] = {}
        alive = set(self.peer_planes) - {self.worker_id}
        for h in hashes:
            node = self.index.get(h)
            if node is None:
                break
            alive &= node.holders[TIER_G1]
            if not alive:
                break
            for w in alive:
                runs[w] = runs.get(w, 0) + 1
        return runs

    # ---------------------------- demotion -----------------------------

    async def evict_to_host(self, max_blocks: Optional[int] = None) -> int:
        """The degradation ladder's evict-to-host rung: demote LRU
        subtrees of *sealed, unreferenced* G1 blocks to the host pool —
        one batched device gather — then free their HBM pages. Blocks
        still referenced by running sequences are skipped (and stay
        marked G1). Returns blocks demoted."""
        if self.kvbm is None:
            return 0
        pool = self.engine.scheduler.pool
        budget = max_blocks or self.config.evict_to_host_blocks
        victims: List[Tuple[int, int]] = []      # (seq_hash, block_id)
        tried: set = set()
        while len(victims) < budget:
            hashes = self.index.lru_subtree(
                TIER_G1, self.worker_id, exclude_roots=tried)
            if not hashes:
                break
            tried.add(hashes[0])
            for h in hashes:
                bid = pool._cached.get(h)
                if bid is None or bid not in pool._evictable:
                    continue   # in use by a running seq — not demotable
                pool.lookup(h)                   # pin while we gather
                victims.append((h, bid))
                if len(victims) >= budget:
                    break
        if not victims:
            return 0
        import torch   # the engine's side: the frontend never loads it

        data = await self.engine.extract_kv_blocks(
            [bid for _, bid in victims])
        for i, (h, bid) in enumerate(victims):
            block = {key: arr[:, i].clone(
                memory_format=torch.contiguous_format)
                for key, arr in data.items()}
            self.kvbm.host_pool.put(h, block)
            self.index.mark(h, TIER_G2, self.worker_id)
            # unregister the hash and free the page; the "removed" event
            # this emits is what clears the index's G1 marking
            pool.discard_adopted(bid)
        self.index.evictions_total += len(victims)
        self.demoted_blocks += len(victims)
        log.info("demoted %d G1 blocks to the host tier "
                 "(degradation evict_to_host)", len(victims))
        return len(victims)
