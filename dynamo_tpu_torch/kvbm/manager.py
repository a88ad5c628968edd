"""KVBM manager: write-through offload + prefix-cache onboarding
(ref: lib/llm/src/block_manager/offload.rs — priority-queued offload with
transfer batching; block_manager.rs:99 ``KvBlockManager``).

Lifecycle per block:

  sealed in G1 ──(pending queue)──► batched gather → G2 host pool ─► G3 disk
  evicted from G1, prompt needs it ──► adopt G1 block + batched scatter ◄──┘

Offload runs in ``tick()``, called by the engine's step loop *between*
steps: candidate hashes accumulate as the scheduler seals blocks, and one
batched device gather copies up to ``max_offload_per_tick`` blocks per tick.
Removed/cleared pool events invalidate pending candidates before each
snapshot, so a gather never reads a recycled block (both run on the event
loop; device work serialises on the engine's single step executor).

A copy of ``dynamo_tpu.kvbm.manager`` on torch CPU tensors (the host form
of a payload, ``disagg/protocol.py``) and this package's codec in place of
msgpack, so a G4 block one package writes to the store the other reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from ..runtime import codec
from ..tokens import SequenceHash
from ..utils.logging import get_logger
from .host_pool import HostBlockPool

log = get_logger("kvbm")


@dataclass
class KvbmConfig:
    host_blocks: int = 1024          # G2 capacity (blocks)
    host_bytes: int = 0              # G2 capacity (bytes; 0 = unbounded) —
    # a byte bound sized to the host budget lets a quantized KV cache
    # (int8/fp8, ~half the bytes per block) hold ~2x the blocks
    disk_dir: Optional[str] = None   # G3 location (None = no disk tier)
    disk_blocks: int = 0             # G3 capacity
    max_offload_per_tick: int = 32   # device-gather batch bound
    max_onboard_blocks: int = 512    # per-request onboard bound


@dataclass
class KvbmStats:
    offloaded_blocks: int = 0
    onboarded_blocks: int = 0
    onboard_requests: int = 0
    invalidated_pending: int = 0
    g4_puts: int = 0
    g4_hits: int = 0
    peer_hits: int = 0      # blocks onboarded from a peer worker's G2


class StoreRemoteTier:
    """G4: cluster-shared KV blocks in the store (ref: block_manager
    CacheLevel::G4 remote tier, block_manager.rs:62-76 — the reference
    backs it with NIXL-addressable object storage; here the lease-KV
    store's value plane). Write-through from the offload tick; any worker
    can onboard another worker's blocks."""

    KEY_PREFIX = "kvbm/g4/"

    def __init__(self, store, namespace: str = "dynamo"):
        self.store = store
        self.prefix = f"{self.KEY_PREFIX}{namespace}/"

    def _key(self, seq_hash: int) -> str:
        return f"{self.prefix}{seq_hash:016x}"

    async def put(self, seq_hash: int,
                  data: Dict[str, torch.Tensor]) -> None:
        from ..disagg.protocol import kv_to_wire

        await self.store.put(
            self._key(seq_hash), codec.packb(kv_to_wire(data))
        )

    async def get(self, seq_hash: int) -> Optional[Dict[str, torch.Tensor]]:
        from ..disagg.protocol import kv_from_wire

        raw = await self.store.get(self._key(seq_hash))
        if raw is None:
            return None
        return kv_from_wire(codec.unpackb(raw))


@dataclass
class _Pending:
    seq_hash: int
    block_hash: int
    parent: Optional[int]
    block_id: int


class KvbmManager:
    """Attached to an :class:`InferenceEngine` via ``attach_kvbm``."""

    # class-level default so partially-constructed fakes stay
    # forward-compatible as attach-time collaborators are added
    prefix = None      # radix prefix manager (prefix.manager)

    def __init__(self, engine, config: Optional[KvbmConfig] = None,
                 remote: Optional[StoreRemoteTier] = None):
        self.engine = engine
        self.config = config or KvbmConfig()
        self.host_pool = HostBlockPool(
            self.config.host_blocks, self.config.disk_dir,
            self.config.disk_blocks,
            capacity_bytes=self.config.host_bytes,
        )
        self.remote = remote   # G4 tier (None = disabled)
        self.peers = None      # distributed peer-G2 plane (kvbm.distributed)
        self.prefix = None     # radix prefix manager (prefix.manager)
        self.stats = KvbmStats()
        # seq_hash -> candidate awaiting offload; insertion-ordered
        self._pending: Dict[int, _Pending] = {}
        self.block_size = engine.config.block_size

    def snapshot(self) -> Dict[str, float]:
        """Scalar wire dict for the worker metrics publisher (the
        aggregator re-exports these as ``kvbm_*`` gauges)."""
        hs = self.host_pool.stats
        out = {
            "host_pool_blocks": hs.g2_blocks + hs.g3_blocks,
            "host_pool_bytes": hs.g2_bytes,
            "spills_total": hs.spills,
            "drops_total": hs.drops,
            "offloaded_total": self.stats.offloaded_blocks,
            "onboarded_total": self.stats.onboarded_blocks,
            "onboard_requests_total": self.stats.onboard_requests,
            "g4_puts_total": self.stats.g4_puts,
            "g4_hits_total": self.stats.g4_hits,
            "peer_hits_total": self.stats.peer_hits,
            # radix prefix index counters (zero while no prefix cache
            # manager is attached — the aggregator zero-defaults them
            # the same way for old workers on the wire)
            "prefix_nodes": 0.0,
            "prefix_hit_tokens_total": 0.0,
            "prefix_evictions_total": 0.0,
        }
        if self.prefix is not None:
            px = self.prefix.snapshot()
            out["prefix_nodes"] = px["prefix_nodes"]
            out["prefix_hit_tokens_total"] = px["prefix_hit_tokens_total"]
            out["prefix_evictions_total"] = px["prefix_evictions_total"]
        return out

    # ---- pool event hook (called synchronously from the scheduler) ----

    def on_pool_event(self, event) -> None:
        if event.kind == "stored":
            for b in event.blocks:
                h = b["seq_hash"]
                if h not in self.host_pool and h not in self._pending:
                    self._pending[h] = _Pending(
                        seq_hash=h,
                        block_hash=b.get("block_hash", h),
                        parent=b.get("parent"),
                        block_id=b["block_id"],
                    )
        elif event.kind == "removed":
            for h in event.blocks:
                if self._pending.pop(h, None) is not None:
                    self.stats.invalidated_pending += 1
        elif event.kind == "cleared":
            self.stats.invalidated_pending += len(self._pending)
            self._pending.clear()

    # ------------------------- offload tick ----------------------------

    async def tick(self) -> int:
        """Offload up to ``max_offload_per_tick`` pending blocks in ONE
        batched device gather. Returns blocks offloaded."""
        if not self._pending:
            return 0
        batch: List[_Pending] = []
        for h in list(self._pending):
            batch.append(self._pending.pop(h))
            if len(batch) >= self.config.max_offload_per_tick:
                break
        block_ids = [p.block_id for p in batch]
        data = await self.engine.extract_kv_blocks(block_ids)
        for i, p in enumerate(batch):
            # copy each [L, KV, bs, hd] block out of the batched gather —
            # a view would pin the whole (pinned) batch buffer in G2.  A
            # quantized cache adds "ks"/"vs" scale tensors to the payload.
            block = {key: arr[:, i].clone(
                memory_format=torch.contiguous_format)
                for key, arr in data.items()}
            self.host_pool.put(p.seq_hash, block)
            if self.prefix is not None:
                self.prefix.on_offloaded(p.seq_hash)
            if self.remote is not None:
                try:  # write-through to the cluster-shared G4 tier
                    await self.remote.put(p.seq_hash, block)
                    self.stats.g4_puts += 1
                    if self.prefix is not None:
                        self.prefix.on_g4_put(p.seq_hash)
                except Exception:
                    log.exception("G4 put failed for %x", p.seq_hash)
        if self.peers is not None:
            try:  # one batched presence update, not a put per block
                await self.peers.publish_many(
                    [p.seq_hash for p in batch]
                )
            except Exception:
                log.exception("peer G2 publish failed")
        self.stats.offloaded_blocks += len(batch)
        return len(batch)

    # ------------------------- onboarding ------------------------------

    async def onboard_prefix(self, token_seq) -> int:
        """Promote host-held leading blocks of ``token_seq`` into the G1
        prefix cache (adopt + one batched scatter). Returns blocks
        onboarded. Called by the engine at admission, before scheduling."""
        pool = self.engine.scheduler.pool
        peer_hits_before = self.stats.peer_hits
        candidates = token_seq.blocks[: self.config.max_onboard_blocks]
        peer_data: Dict[int, Dict[str, torch.Tensor]] = {}
        if self.peers is not None:
            # one batched peer lookup+fetch for every locally-missing hash
            # (a per-block round-trip would serialise hundreds of RTTs at
            # admission); may over-fetch past the first break point, bounded
            # by max_onboard_blocks
            need = [
                tb.sequence_hash for tb in candidates
                if not pool.contains(tb.sequence_hash)
                and tb.sequence_hash not in self.host_pool
            ]
            if need:
                try:
                    peer_data = await self.peers.fetch_many(need)
                except Exception:
                    log.exception("peer G2 batch fetch failed")
        adopted: List[Tuple[int, Dict[str, torch.Tensor]]] = []
        try:
            for tb in candidates:
                if pool.contains(tb.sequence_hash):
                    continue  # native G1 hit — prefix matching will take it
                data = self.host_pool.get(tb.sequence_hash)
                if data is None:
                    data = peer_data.get(tb.sequence_hash)
                    if data is not None:
                        self.stats.peer_hits += 1
                        self.host_pool.put(tb.sequence_hash, data)
                        if self.prefix is not None:
                            self.prefix.on_offloaded(tb.sequence_hash)
                if data is None and self.remote is not None:
                    try:
                        data = await self.remote.get(tb.sequence_hash)
                    except Exception:
                        log.exception("G4 get failed")
                        data = None
                    if data is not None:
                        self.stats.g4_hits += 1
                        self.host_pool.put(tb.sequence_hash, data)  # promote
                        if self.prefix is not None:
                            self.prefix.on_offloaded(tb.sequence_hash)
                if data is None:
                    break  # chained hashes: deeper blocks can't hit either
                bid = pool.adopt(
                    tb.sequence_hash, tb.block_hash, tb.parent_sequence_hash
                )
                if bid is None:
                    break  # G1 full — stop promoting
                adopted.append((bid, data))
            if not adopted:
                return 0
            block_ids = [bid for bid, _ in adopted]
            data = {
                key: torch.stack([d[key] for _, d in adopted], dim=1)
                for key in adopted[0][1]
            }
            await self.engine.inject_kv_blocks(block_ids, data)
        except BaseException:
            # injection failed (device error / caller cancelled): the
            # adopted blocks hold no valid KV — discard, never cache them
            for bid, _ in adopted:
                pool.discard_adopted(bid)
            raise
        for bid, _ in adopted:
            pool.release_adopted(bid)
        self.stats.onboarded_blocks += len(adopted)
        if adopted:
            self.stats.onboard_requests += 1
            peer_blocks = self.stats.peer_hits - peer_hits_before
            if peer_blocks:
                log.info("onboarded %d blocks (%d from peer G2)",
                         len(adopted), peer_blocks)
            else:
                log.debug("onboarded %d blocks from host tier",
                          len(adopted))
        return len(adopted)
